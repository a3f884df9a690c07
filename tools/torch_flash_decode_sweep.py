"""Where the bf16 flash-decode kernel's time goes, on one GPU.

    python3 tools/torch_flash_decode_sweep.py [--mode dense|int8]

Times the bf16 cluster kernel of one mode (dense, ``flash_decode_launch``,
or int8, ``flash_decode_int8_launch`` over K/V quantized with group 64;
one launch, its splits merged in a thread-block cluster) at the
Llama-3.1-8B and Llama-3.2-1B serve shapes of chip_smoke.py (B = 8, 8 KV
heads, 32 heads, S = 4096, R = 4, the serve phase's contexts) while one
thing changes at a time:

  * the cluster size (context splits + the ring block: 8, 7, 6, 5, 4, 2);
  * the contexts: the serve contexts, the same with every context share
    empty (ring only: launch, cluster barriers and merge alone), all
    slots at the longest serve context, and (at the cluster size the
    wrapper takes) exactly 1, 2 or 4 full tiles in every context split;
  * the cache: calls cycling through the layers (most K/V reads miss the
    L2, as in a decode step) or, at the serve contexts and the wrapper's
    cluster size, repeating layer 0 (L2-warm).

Each line gives ms per call (chip_smoke.cuda_time_ms) beside the call's
byte bound, after how many clusters of each size the card holds at once
(cudaOccupancyMaxActiveClusters; a call launches B * n_kv = 64). For the
serve contexts and 4 tiles a split it also prints one call's timeline:
thread 0 of every block stamps %globaltimer at its phases (the kernel's
diagnostic trace buffer, off in serving). The last line is a JSON object
with the same numbers. The card's name and
power limit come first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SIZES = (8, 7, 6, 5, 4, 2)  # blocks per cluster: context splits + the ring


def timeline(lib, call, B: int, nkv: int, ns: int) -> dict:
    """One call with the kernel's phase stamps on (thread 0 of each block
    reads %globaltimer): microseconds from the first block's start, as
    medians and maxima over the blocks."""
    import numpy as np

    lib.flash_decode_set_trace.argtypes = [ctypes.c_void_p]
    slots = lib.flash_decode_set_trace(None)
    buf = torch.zeros(ns * nkv * B * slots, dtype=torch.int64, device="cuda")
    call()
    torch.cuda.synchronize()
    lib.flash_decode_set_trace(buf.data_ptr())
    try:
        call()
        torch.cuda.synchronize()
    finally:
        lib.flash_decode_set_trace(None)
    t = buf.view(ns, nkv * B, slots).cpu().numpy().astype(np.float64)
    t0 = t[:, :, 0].min()
    us = (t[:, :, :10] - t0) / 1e3
    n_tiles = t[:, :, 10].astype(int)
    ctx = n_tiles[:-1] > 0  # context blocks with work (the last z is the ring)

    def stat(x):
        x = np.asarray(x, np.float64).ravel()
        return [round(float(np.median(x)), 2), round(float(x.max()), 2)] if x.size else None

    c = us[:-1][ctx]
    nt = n_tiles[:-1][ctx]
    last = c[np.arange(len(c)), 1 + np.minimum(nt, 4)]  # last stamped landing
    return {
        "blocks start (after the first)": stat(us[:, :, 0]),
        "copies issued": stat(c[:, 1] - c[:, 0]),
        "tile 0 landed": stat(c[:, 2] - c[:, 1]),
        "tile 1 landed after tile 0": stat((c[:, 3] - c[:, 2])[nt >= 2]),
        "tile 2 landed after tile 1": stat((c[:, 4] - c[:, 3])[nt >= 3]),
        "tile 3 landed after tile 2": stat((c[:, 5] - c[:, 4])[nt >= 4]),
        "loop end after the last landing (<= 4 tiles)": stat((c[:, 6] - last)[nt <= 4]),
        "ring block loop": stat(us[-1, :, 6] - us[-1, :, 1]),
        "first cluster barrier wait": stat(us[:, :, 7] - us[:, :, 6]),
        "merge (a block's share)": stat(us[:, :, 8] - us[:, :, 7]),
        "second cluster barrier wait": stat(us[:, :, 9] - us[:, :, 8]),
        "blocks end": stat(us[:, :, 9]),
        "context blocks with n tiles": {int(k): int((nt == k).sum())
                                        for k in np.unique(nt)},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("dense", "int8"), default="int8")
    quant = ap.parse_args().mode == "int8"
    if not torch.cuda.is_available():
        print("torch_flash_decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import cuda_build
    from dynamo_tpu_torch.ops import flash_decode as fd

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}; "
          f"mode {'int8' if quant else 'dense'}")
    serve_lens = [len(p) for p in cs.serve_prompts(
        ModelConfig.llama3_8b().vocab_size)]
    lib = cuda_build.load("flash_decode")
    lib.flash_decode_max_active_clusters.argtypes = [ctypes.c_int] * 3
    pick = fd.cluster_splits
    rows = []
    resident = {}
    timelines = {}
    for label, L, hd in (("llama3_8b", 32, 128), ("llama3_1b", 16, 64)):
        B, nkv, nh, S, R, group = 8, 8, 32, 4096, 4, 64
        for cluster in SIZES:
            n = lib.flash_decode_max_active_clusters(int(quant), hd, cluster)
            resident[f"{label} cluster {cluster}"] = n
            print(f"{label} cluster {cluster}: the card holds {n} clusters at "
                  f"once; a call launches {B * nkv}")
        q, ck, cv, rk, rv = cs.decode_inputs(torch.bfloat16, L, nkv, nh, hd,
                                             B, S, R)
        ksc = vsc = None
        if quant:
            ck, ksc = cs.quantize_groups(ck, group)
            cv, vsc = cs.quantize_groups(cv, group)
        chosen = pick(B, nkv, S, 64, fd._cluster_residency(
            lib, q.device, quant, hd)) + 1
        resident[f"{label} wrapper's cluster"] = chosen
        print(f"{label}: the wrapper takes clusters of {chosen}")
        serve_ctx, serve_base = cs.decode_patterns(S, R, serve_lens)["serve"]
        longest = max(serve_ctx)
        patterns = {
            "serve": (serve_ctx, serve_base),
            "ring only": ([2] * B, [0] * B),
            "all at the longest": ([longest] * B, [longest - 2] * B),
        }
        for k in (1, 2, 4):  # k full tiles in every context split
            live = (chosen - 1) * 64 * k
            patterns[f"{k} tiles a split"] = ([live + 2] * B, [live] * B)
        for pname, (ctx_l, base_l) in patterns.items():
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
            base = torch.tensor(base_l, dtype=torch.int32, device="cuda")
            bound_ms, _ = cs.decode_bound_ms(ctx_l, base_l, nkv, nh, hd, R, 2,
                                             group if quant else None)
            for cluster in SIZES:
                fd.cluster_splits = lambda *a, k=cluster - 1: k
                for cache, layer_of in (("cold", lambda i: i % L),
                                        ("warm", lambda i: 0)):
                    if cache == "warm" and (cluster != chosen
                                            or pname != "serve"):
                        continue
                    if "tiles a split" in pname and cluster != chosen:
                        continue
                    ms = cs.cuda_time_ms(lambda i: fd.flash_decode_attention(
                        q, ck, cv, rk, rv, layer_of(i), ctx, base, ksc, vsc),
                        iters=100)
                    row = dict(shape=label, pattern=pname, cluster=cluster,
                               cache=cache, ms=ms, bound_ms=bound_ms)
                    rows.append(row)
                    print(f"{label} {pname:>18} cluster {cluster} {cache}: "
                          f"{ms:.4f} ms/call (byte bound {bound_ms:.4f} ms)")
            fd.cluster_splits = pick
            if pname in ("serve", "4 tiles a split"):
                tl = timeline(lib, lambda: fd.flash_decode_attention(
                    q, ck, cv, rk, rv, 1, ctx, base, ksc, vsc), B, nkv, chosen)
                timelines[f"{label} {pname}"] = tl
                print(f"{label} {pname} timeline, us (median, max over "
                      f"blocks): " + json.dumps(tl))
        del q, ck, cv, rk, rv, ksc, vsc
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "mode": "int8" if quant else "dense",
                      "max_active_clusters": resident,
                      "timelines": timelines, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
