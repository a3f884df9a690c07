"""Where a disaggregated prefill's time goes, on one GPU.

    python3 tools/torch_disagg_hop.py [--chunk-pages N] [--reps R]

Builds the kernels (chip_smoke.build_all) and makes Llama-3.1-8B's
random bf16 weights (seed 0) on the card. Starts the port's store, a
``--role decode`` worker (engine D, launch.run's serve_worker with
``--max-local-prefill-length 64``: every serve prompt goes remote) and a
``--role prefill`` worker (engine P, serve_prefill_worker), each on a
loop thread of its own (chip_smoke.LoopThread), on one weight copy.
chip_smoke.py's 8 serve prompts go one at a time straight to D's
disagg wrapper, ``--reps`` times, both caches cleared between reps.

Each job is split into, on P: the prefill (generate() to its end), each
chunk's export (pin + gather + device->host copy, ``_export_run``), each
chunk's write (crc32s + socket, ``PageStreamWriter.write_chunk``) and the
eof wait (``commit``: the receiver's last decode, verify and import); on
D: each chunk frame's decode + crc32 verify, each import (``import_pages``:
the engine loop's scatter) and the tail (intake to first token); and the
job as the client sees it (the call to the first token). Also the
transfer plane alone: 64 MiB frames from a client to a server whose
write hook does nothing (no engine, no crc: frames that are not KV
pages carry none), GB/s. Prints medians over the prompts for each rep;
the last line is a JSON object with the figures. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timed(rec, key, fn):
    """``fn`` (async or not) with each call's seconds appended to
    ``rec[key]``."""
    if asyncio.iscoroutinefunction(fn):
        async def wrapper(*a, **kw):
            t = time.monotonic()
            try:
                return await fn(*a, **kw)
            finally:
                rec[key].append(time.monotonic() - t)
    else:
        def wrapper(*a, **kw):
            t = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                rec[key].append(time.monotonic() - t)
    return wrapper


async def frame_gbs(n_frames=6, nbytes=64 * 2**20):
    """The transfer plane alone: ``n_frames`` uint8 frames of ``nbytes``
    to a server that drops them; GB/s per frame (the write and its ack)."""
    import torch

    from dynamo_tpu_torch import kv_transfer as kt

    srv = kt.BlockTransferServer(write_fn=lambda pages, data, job=None: None)
    host, port = await srv.start()
    data = torch.randint(0, 255, (nbytes,), dtype=torch.uint8)
    out = []
    try:
        for _ in range(n_frames):
            t = time.monotonic()
            await kt.write_remote_pages(host, port, [1], data)
            out.append(nbytes / (time.monotonic() - t) / 1e9)
    finally:
        await srv.stop()
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from dynamo_tpu_torch import kv_transfer as kt
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.runtime.store import serve_store
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk-pages", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_disagg_hop: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cs.log(f"card: {smi}")
    cs.build_all()
    cfg = ModelConfig.llama3_8b()
    name = "llama3_8b"
    params = llama.init_params(cfg, cs.SEED, device="cuda")
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    prompts = cs.serve_prompts(cfg.vocab_size)
    loops = {k: cs.LoopThread(f"{k}-loop")
             for k in ("store", "decode", "prefill")}
    rec: dict = defaultdict(list)
    reps = []
    try:
        server, _ = loops["store"].run(serve_store("127.0.0.1", 0))
        base = ["in=endpoint", "out=torch", "--model-config", name,
                "--model-name", name, "--control-plane",
                f"127.0.0.1:{server.sockets[0].getsockname()[1]}",
                "--kv-transfer-chunk-pages", str(opts.chunk_pages)]
        parse = launch.build_parser().parse_intermixed_args
        args_d = parse(base + ["--role", "decode",
                               "--max-local-prefill-length", "64"])
        args_p = parse(base + ["--role", "prefill"])
        _, chain_d = launch.build_chain(args_d, params=params, tokenizer=tok)
        _, chain_p = launch.build_chain(args_p, params=params, tokenizer=tok)
        eng_d, eng_p = chain_d.engine, chain_p.engine
        marks = cs.record_marks(eng_d)
        rt_d = loops["decode"].run(launch.connect_runtime(args_d))
        served = loops["decode"].run(launch.serve_worker(args_d, chain_d,
                                                         rt_d))
        dis = served.engine
        rt_p = loops["prefill"].run(launch.connect_runtime(args_p))
        pworker = loops["prefill"].run(launch.serve_prefill_worker(
            args_p, chain_p, rt_p))
        # the instrumented steps
        pworker._export_run = timed(rec, "export", pworker._export_run)
        kt.PageStreamWriter.write_chunk = timed(
            rec, "write", kt.PageStreamWriter.write_chunk)
        kt.PageStreamWriter.commit = timed(rec, "eof", kt.PageStreamWriter.commit)
        kt._decode_payload = timed(rec, "verify", kt._decode_payload)
        eng_d.import_pages = timed(rec, "import", eng_d.import_pages)
        eng_p.generate = timed_gen(rec, eng_p.generate)
        for rep in range(opts.reps):
            eng_d.clear_kv_blocks()
            eng_p.clear_kv_blocks()
            rows = []
            for p in prompts:
                for v in rec.values():
                    v.clear()
                toks, _, first, ann = loops["decode"].run(
                    cs.timed_generate(dis, p, name))
                loops["decode"].run(cs.settle_engines(eng_d, eng_p))
                m = marks.pop(tuple(p))
                done = dis.last_done or {}
                rows.append(dict(
                    tokens=len(p), blocks=done.get("blocks"),
                    chunks=done.get("chunks"), job_s=first,
                    p_job_ms=done.get("prefill_ms"),
                    prefill_s=sum(rec["prefill"]),
                    export_ms=[x * 1e3 for x in rec["export"]],
                    write_ms=[x * 1e3 for x in rec["write"]],
                    eof_ms=sum(rec["eof"]) * 1e3,
                    verify_ms=[x * 1e3 for x in rec["verify"]],
                    import_ms=[x * 1e3 for x in rec["import"]],
                    tail_s=m["timing"]["ttft_s"],
                    overlap=done.get("overlap_ratio")))
            if dis.remote_fallbacks:
                raise AssertionError(f"{dis.remote_fallbacks} fallbacks")
            reps.append(rows)
            med = {k: float(np.median([
                sum(r[k]) if isinstance(r[k], list) else r[k] for r in rows]))
                for k in ("job_s", "p_job_ms", "prefill_s", "export_ms",
                          "write_ms", "eof_ms", "verify_ms", "import_ms",
                          "tail_s")}
            moved = sum(r["blocks"] for r in rows) * eng_p.cache["k"][
                :, :, 0].numel() * 2 * eng_p.cache["k"].element_size()
            wire_s = sum(sum(r["write_ms"]) + r["eof_ms"]
                         for r in rows) / 1e3
            cs.log(f"rep {rep}: medians over the 8 prompts (chunk pages "
                   f"{opts.chunk_pages}): client call to first token "
                   f"{med['job_s']:.4f} s = P's job {med['p_job_ms']:.1f} ms "
                   f"(prefill {med['prefill_s'] * 1e3:.1f}, exports "
                   f"{med['export_ms']:.1f}, writes {med['write_ms']:.1f}, "
                   f"eof wait {med['eof_ms']:.1f}) + D's tail "
                   f"{med['tail_s'] * 1e3:.1f} ms; on D: decode + verify "
                   f"{med['verify_ms']:.1f} ms, imports "
                   f"{med['import_ms']:.1f} ms; {moved / 2**20:.1f} MiB in "
                   f"{wire_s:.3f} s of writes + eof waits: "
                   f"{moved / wire_s / 1e9:.2f} GB/s; {smi}")
        loops["prefill"].run(pworker.stop())
        loops["decode"].run(served.shutdown())
        loops["decode"].run(eng_d.stop())
        loops["prefill"].run(eng_p.stop())
        loops["decode"].run(rt_d.close())
        loops["prefill"].run(rt_p.close())
        plane = loops["decode"].run(frame_gbs())
        cs.log(f"transfer plane alone: 64 MiB frames at "
               f"{', '.join(f'{g:.2f}' for g in plane)} GB/s (median "
               f"{np.median(plane):.2f}); {smi}")
        server.close()
    finally:
        for lt in loops.values():
            lt.close()
    print(json.dumps({"card": smi, "chunk_pages": opts.chunk_pages,
                      "reps": reps, "plane_gbs": plane}))
    return 0


def timed_gen(rec, generate):
    """An engine's generate() with each call's seconds to its end in
    ``rec["prefill"]`` (the prefill worker's calls: max_tokens=1)."""
    async def wrapper(req):
        t = time.monotonic()
        try:
            async for out in generate(req):
                yield out
        finally:
            rec["prefill"].append(time.monotonic() - t)
    return wrapper


if __name__ == "__main__":
    sys.exit(main())
