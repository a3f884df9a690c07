"""``python -m dynamo_tpu_torch.launch.run in=<input> out=<engine>``: the
port's launcher (a copy of the JAX package's launch/run.py, cut to local
serving; reference `dynamo-run`, launch/dynamo-run/src/lib.rs:94-165).

Inputs (reference entrypoint/input.rs:29-45):
  in=http        OpenAI HTTP frontend on --http-host:--http-port; with
                 --control-plane HOST:PORT it serves the models that
                 workers register there instead of a local engine
  in=endpoint    a worker: serves the engine on the control plane at
                 --namespace/--component/--endpoint-name and registers
                 its model (--router-mode picks how frontends route it);
                 --role decode hands long prompts to the prefill queue
                 (disagg.py), --role prefill consumes that queue and
                 registers no model, and --remote-kv serves the KV pool
                 to peers and fetches prefix misses from theirs (G4)
  in=text        one-shot prompt from --prompt (or interactive REPL)
  in=stdin       read prompts line-by-line from stdin
  in=batch:FILE  JSONL of {"prompt": ...} (or mooncake trace records);
                 writes completions JSONL to stdout

Engines:
  out=echo       deterministic token echo (tests/smoke)
  out=torch      TorchEngine with random weights from --model-config, on
                 --device (default cuda: without a card the engine raises)

The parser keeps every flag of the reference's, so a command line written
for it parses here; a flag of a plane the port does not serve yet is
refused with SystemExit when it is set away from its default (see
UNPORTED_FLAGS), never ignored. Serving a checkpoint (--model-path: an
HF tokenizer, chat template and safetensors weights) waits for model files
in the repository; the random-weight chain uses the test tokenizer, as
the reference does without a model path.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import sys
import time
from typing import Any, Optional

# engines the reference serves that the port does not yet
_UNPORTED_ENGINES = {"mocker": "the mocker engine", "tpu": "the JAX engine "
                     "(out=torch is the port's engine)"}
_SERVED_CONFIGS = ("tiny", "llama3_1b", "llama3_8b", "llama3_1b_int8",
                   "llama3_8b_int8")

# flags of the reference's parser for planes the port does not serve:
# flag -> (argparse keywords with the reference's default, what it drives)
UNPORTED_FLAGS: dict[str, tuple[dict, str]] = {
    "--model-path": (dict(default=None), "checkpoint serving"),
    "--trace-sample-rate": (dict(type=float, default=1.0),
                            "request tracing"),
    "--tensor-parallel-size": (dict(type=int, default=1),
                               "tensor parallelism"),
    "--max-waiting-requests": (dict(type=int, default=0),
                               "overload budgets"),
    "--max-waiting-prefill-tokens": (dict(type=int, default=0),
                                     "overload budgets"),
    "--preempt-running": (dict(default="off", choices=["on", "off"]),
                          "running preemption"),
    "--prof-attribution": (dict(default="on", choices=["on", "off"]),
                           "performance attribution"),
    "--slo-ttft-target": (dict(type=float, default=0.5), "SLO burn rates"),
    "--slo-itl-target": (dict(type=float, default=0.05), "SLO burn rates"),
    "--slo-objective": (dict(type=float, default=0.99), "SLO burn rates"),
    "--forensics-sample-rate": (dict(type=float, default=0.0),
                                "tail-latency forensics"),
    "--speculative": (dict(default="off", choices=["off", "ngram", "draft"]),
                      "speculative decoding"),
    "--num-speculative-tokens": (dict(type=int, default=4),
                                 "speculative decoding"),
    "--spec-adaptive": (dict(default="on", choices=["on", "off"]),
                        "speculative decoding"),
    "--spec-min-k": (dict(type=int, default=1), "speculative decoding"),
    "--spec-tree": (dict(default="off", choices=["on", "off"]),
                    "speculative decoding"),
    "--spec-branches": (dict(type=int, default=4), "speculative decoding"),
    "--spec-tree-budget": (dict(type=int, default=0),
                           "speculative decoding"),
    "--spec-gate-acceptance": (dict(type=float, default=0.0),
                               "speculative decoding"),
    "--spec-gate-window": (dict(type=int, default=4),
                           "speculative decoding"),
    "--spec-rearm-tokens": (dict(type=int, default=256),
                            "speculative decoding"),
    "--draft-model-config": (dict(default=None), "speculative decoding"),
    "--num-nodes": (dict(type=int, default=1), "multi-host engines"),
    "--node-rank": (dict(type=int, default=0), "multi-host engines"),
    "--leader-addr": (dict(default=None, metavar="HOST:PORT"),
                      "multi-host engines"),
    "--kv-replication-target": (dict(type=int, default=2),
                                "the fleet prefix economy"),
    "--kv-prefetch-hot-k": (dict(type=int, default=8),
                            "the fleet prefix economy"),
    "--kv-prefetch-interval": (dict(type=float, default=2.0),
                               "the fleet prefix economy"),
    "--kv-freq-halflife": (dict(type=float, default=600.0),
                           "the fleet prefix economy"),
    "--no-kv-dedup-admission": (dict(action="store_true"),
                                "the fleet prefix economy"),
}


def build_parser() -> argparse.ArgumentParser:
    # layered defaults: dataclass <- TOML <- DYNTPU_* env <- CLI flags
    # (reference figment layering, config.rs:103-127)
    from dynamo_tpu_torch.config import load_config

    cfg = load_config()
    p = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.launch.run",
        description="Run the PyTorch port's serving chain",
    )
    p.add_argument("io", nargs="*",
                   help="in=<http|text|stdin|batch:FILE> out=<echo|torch>")
    p.add_argument("--model-name", default=None, help="served model name")
    p.add_argument("--model-config", default=None,
                   help=f"canned config ({'|'.join(_SERVED_CONFIGS)}) for "
                        f"random-weight serving")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="weight quantization (w8a16: int8 weights with a "
                        "per-output-channel scale, served through the "
                        "w8a16 GEMM kernel)")
    p.add_argument("--device", default=None,
                   help="torch device of out=torch (default cuda; the "
                        "engine does not fall back to the CPU)")
    p.add_argument("--http-host", default=cfg.http_host)
    p.add_argument("--http-port", type=int, default=cfg.http_port)
    p.add_argument("--prompt", default=None, help="prompt for in=text")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--trace-speedup", type=float, default=0.0,
                   help="in=batch with a mooncake trace: replay arrival "
                        "timestamps at this speed multiple (0 = ignore "
                        "timestamps, submit all at once)")
    p.add_argument("--trace-block-size", type=int, default=64,
                   help="tokens represented by one trace hash id (must "
                        "match the datagen --block-size for the trace's "
                        "prefix sharing to replay faithfully)")
    p.add_argument("--num-pages", type=int, default=cfg.num_pages)
    p.add_argument("--page-size", type=int, default=cfg.page_size)
    p.add_argument("--max-decode-slots", type=int,
                   default=cfg.max_decode_slots)
    p.add_argument("--cache-dtype", default=cfg.cache_dtype)
    p.add_argument("--kv-quant", default=cfg.kv_quant,
                   choices=["none", "int8"],
                   help="KV quantization: int8 pool pages and int8 decode "
                        "ctx with per-group scales (the flash-decode "
                        "kernel's int8 mode); the ring stays --cache-dtype")
    p.add_argument("--host-offload-pages", type=int,
                   default=cfg.host_offload_pages,
                   help="host-memory KV offload tier capacity in pages "
                        "(KVBM G2); 0 disables")
    p.add_argument("--disk-offload-pages", type=int,
                   default=cfg.disk_offload_pages,
                   help="mmap-backed disk KV tier capacity in pages "
                        "(KVBM G3, spill target of G2); 0 disables")
    p.add_argument("--disk-offload-path", default=cfg.disk_offload_path,
                   help="backing file for the G3 pool (default: a fresh "
                        "temporary file); with a path the tier journals a "
                        "manifest and survives engine restarts")
    p.add_argument("--scrub-on-start", action="store_true",
                   default=cfg.scrub_on_start,
                   help="verify every G3 manifest entry against its file "
                        "at startup (default: at each onboard)")
    # chunk-pipelined KV transfer plane (kv_transfer.py)
    p.add_argument("--kv-transfer-chunk-pages", type=int, default=8,
                   help="pages per streamed KV-transfer chunk (disagg "
                        "remote prefill, G4 peer fetch, G2/G3 onboard); "
                        "0 = monolithic single-blob transfers")
    p.add_argument("--kv-transfer-inflight-chunks", type=int, default=2,
                   help="chunk gathers/D2H copies in flight per export "
                        "stream (double-buffer depth)")
    p.add_argument("--xfer-op-timeout", type=float, default=120.0,
                   help="deadline in seconds for one queued page "
                        "export/import op (raise for multi-GiB chunked "
                        "imports on slow host links)")
    p.add_argument("--kv-transfer-stream-idle-timeout", type=float,
                   default=15.0,
                   help="idle-timeout in seconds reclaiming a chunked "
                        "export stream whose receiver stalled (page refs "
                        "freed)")
    p.add_argument("--round-pipeline",
                   default="on" if cfg.round_pipeline else "off",
                   choices=["on", "off"],
                   help="round pipelining: dispatch round N+1 before "
                        "processing round N's tokens; off restores the "
                        "strict round order")
    # distributed mode (runtime/, frontend/watcher.py)
    p.add_argument("--control-plane", default=None, metavar="HOST:PORT",
                   help="control-plane store address; in=endpoint "
                        "registers a worker there, in=http discovers the "
                        "models registered there")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint-name", default="generate")
    p.add_argument("--router-mode", default="kv",
                   choices=["kv", "round_robin", "random"],
                   help="how frontends route to this worker's model: kv "
                        "(prefix overlap and load), round_robin, random")
    # disaggregated prefill/decode (disagg.py; reference flags.rs +
    # disagg_router.rs) and the G4 remote tier
    p.add_argument("--role", default="aggregated",
                   choices=["aggregated", "decode", "prefill"],
                   help="worker role for disaggregated serving")
    p.add_argument("--max-local-prefill-length", type=int, default=None,
                   help="prompts with more uncached tokens go to the "
                        "prefill queue (writes the store-watched conf)")
    p.add_argument("--max-prefill-queue-size", type=int, default=None)
    p.add_argument("--prefill-timeout", type=float, default=60.0,
                   help="--role decode: seconds to wait for a remote "
                        "prefill before prefilling locally")
    p.add_argument("--remote-kv", action="store_true",
                   help="KVBM G4: serve this worker's sealed KV pool to "
                        "peers and fall through the local tiers to peer "
                        "pools on prefix misses (requires --control-plane "
                        "and a G2 tier via --host-offload-pages)")
    p.add_argument("--record-kv-events", default=None, metavar="PATH",
                   help="in=http --control-plane: record the KV-event "
                        "stream feeding the router (JSONL, the JAX "
                        "package's format; replay with "
                        "recorder.KvRecorder.replay)")
    p.add_argument("--system-port", type=int, default=None,
                   help="per-process /metrics + /health server port "
                        "(reference http_server.rs); 0 = ephemeral")
    # resilience plane (resilience/)
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="arm fault-injection points on the worker serving "
                        "path, e.g. 'kill_worker:p=0.1:after=3,delay:t=0.05'"
                        " (also via DYNAMO_CHAOS; python -m "
                        "dynamo_tpu_torch.tools.chaos arms a running "
                        "worker over HTTP)")
    p.add_argument("--health-heartbeat-ttl", type=float, default=None,
                   help="frontend soft-lease TTL in seconds: a worker "
                        "whose load-metrics heartbeats go silent longer "
                        "than this stops receiving traffic before its "
                        "hard store lease expires (engines heartbeat on "
                        "idle ticks too; set well above ~1s). Default: "
                        "breaker-only health tracking")
    p.add_argument("--drain-timeout", type=float, default=60.0,
                   help="graceful-drain budget: in-flight requests get "
                        "this long to finish after SIGTERM or POST /drain "
                        "before the worker exits anyway")
    for flag, (kw, what) in UNPORTED_FLAGS.items():
        p.add_argument(flag, help=f"not served by the port yet ({what})",
                       **kw)
    return p


def refuse_unported(args: argparse.Namespace) -> None:
    """SystemExit naming every unported flag set away from its default."""
    bad = []
    for flag, (kw, what) in UNPORTED_FLAGS.items():
        default = False if kw.get("action") == "store_true" \
            else kw.get("default")
        value = getattr(args, flag[2:].replace("-", "_"))
        if value != default:
            bad.append(f"{flag}={value!r} ({what})")
    if bad:
        raise SystemExit(
            "not served by the PyTorch port yet: " + "; ".join(bad))


def _parse_io(io: list[str]) -> tuple[str, str]:
    inp, out = "http", "echo"
    for item in io:
        if item.startswith("in="):
            inp = item[3:]
        elif item.startswith("out="):
            out = item[4:]
        else:
            raise SystemExit(f"unrecognized arg {item!r} (expected in=/out=)")
    return inp, out


def build_chain(args, *, params: Any = None, tokenizer: Any = None) -> tuple:
    """(input, ModelChain) for the selected engine. Programmatic callers
    may pass prebuilt ``params`` (the engine's weights, on its device) and
    a ``tokenizer``; the default tokenizer is the test tokenizer."""
    from dynamo_tpu_torch.backend import Backend
    from dynamo_tpu_torch.frontend.model_manager import ModelChain
    from dynamo_tpu_torch.preprocessor import (
        OpenAIPreprocessor,
        PromptFormatter,
    )
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    inp, out = _parse_io(args.io)
    tok = tokenizer if tokenizer is not None else make_test_tokenizer()
    name = args.model_name or "echo"

    if out == "echo":
        from dynamo_tpu_torch.engines import EchoEngine

        engine: Any = EchoEngine()
    elif out == "torch":
        from dynamo_tpu_torch.engine.config import EngineConfig
        from dynamo_tpu_torch.engine.engine import TorchEngine
        from dynamo_tpu_torch.models.config import ModelConfig

        if args.model_config is None:
            raise SystemExit("out=torch needs --model-config "
                             f"({'|'.join(_SERVED_CONFIGS)})")
        if args.model_config not in _SERVED_CONFIGS:
            raise SystemExit(
                f"--model-config {args.model_config!r} is not served by the "
                f"PyTorch port (served: {', '.join(_SERVED_CONFIGS)})")
        # the engine computes in one dtype: random weights are made in the
        # cache dtype (the reference promotes bf16 weights to it)
        cfg = getattr(ModelConfig, args.model_config)(dtype=args.cache_dtype)
        if args.quantize:
            cfg = dataclasses.replace(cfg, quant=args.quantize)
        ecfg = EngineConfig(
            num_pages=args.num_pages,
            page_size=args.page_size,
            max_decode_slots=args.max_decode_slots,
            cache_dtype=args.cache_dtype,
            kv_quant=args.kv_quant,
            host_offload_pages=args.host_offload_pages,
            disk_offload_pages=args.disk_offload_pages,
            disk_offload_path=args.disk_offload_path,
            scrub_on_start=args.scrub_on_start,
            round_pipeline=args.round_pipeline == "on",
            kv_transfer_chunk_pages=args.kv_transfer_chunk_pages,
            kv_transfer_inflight_chunks=args.kv_transfer_inflight_chunks,
            xfer_op_timeout_s=args.xfer_op_timeout,
            kv_transfer_stream_idle_timeout_s=(
                args.kv_transfer_stream_idle_timeout),
        )
        engine = TorchEngine(cfg, ecfg, params=params, device=args.device)
    elif out in _UNPORTED_ENGINES:
        raise SystemExit(f"out={out}: {_UNPORTED_ENGINES[out]} is not "
                         f"served by the PyTorch port")
    else:
        raise SystemExit(f"unknown engine out={out!r}")

    pre = OpenAIPreprocessor(tokenizer=tok, formatter=PromptFormatter(),
                             model_name=name)
    return inp, ModelChain(
        name=name, preprocessor=pre, engine=engine, backend=Backend(tok)
    )


async def _serve_http(args, chain) -> None:
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService

    manager = ModelManager()
    manager.register(chain)
    svc = HttpService(manager, host=args.http_host, port=args.http_port)
    await svc.start()
    print(f"serving {chain.name!r} on http://{args.http_host}:{svc.port}",
          flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await svc.stop()


async def _one_prompt(chain, prompt: str, max_tokens: int) -> str:
    from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest

    req = ChatCompletionRequest.from_dict({
        "model": chain.name,
        "messages": [{"role": "user", "content": prompt}],
        "max_tokens": max_tokens,
    })
    pre = chain.preprocess(req)
    parts = []
    async for out in chain.generate(pre):
        if out.text:
            parts.append(out.text)
    return "".join(parts)


async def _serve_text(args, chain) -> None:
    if args.prompt is not None:
        print(await _one_prompt(chain, args.prompt, args.max_tokens))
        return
    # interactive REPL
    while True:
        try:
            line = await asyncio.to_thread(input, "> ")
        except EOFError:
            return
        if line.strip():
            print(await _one_prompt(chain, line, args.max_tokens))


async def _serve_stdin(args, chain) -> None:
    for line in sys.stdin:
        if line.strip():
            print(await _one_prompt(chain, line.strip(), args.max_tokens))


async def _serve_batch(args, chain, path: str) -> None:
    """Batch mode doubles as the built-in benchmark (reference
    entrypoint/input/batch.rs:294): plain {"prompt": ...} JSONL runs
    through the chat chain; mooncake trace records (datagen output, with
    hash_ids/input_length/output_length) replay token-level with their
    prefix-sharing structure intact and timestamp pacing via
    --trace-speedup. Both print a summary line at the end."""
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    is_trace = bool(recs) and "hash_ids" in recs[0]
    # submit concurrently so the continuous-batching engine actually batches
    sem = asyncio.Semaphore(64)
    ttfts: list[float] = []
    total_tokens = 0
    t0 = time.monotonic()

    async def one(rec):
        nonlocal total_tokens
        async with sem:
            t_sub = time.monotonic()
            first = None
            if is_trace:
                pre = _trace_request(rec, args.trace_block_size)
                n = 0
                async for out in chain.generate(pre):
                    if first is None and out.token_ids:
                        first = time.monotonic() - t_sub
                    n += len(out.token_ids)
                total_tokens += n
                if first is not None:
                    ttfts.append(first)
                return n
            text = await _one_prompt(
                chain, rec.get("prompt", ""),
                rec.get("max_tokens", args.max_tokens),
            )
            ttfts.append(time.monotonic() - t_sub)
            return text

    async def paced(rec, delay_s):
        if delay_s > 0:
            await asyncio.sleep(delay_s)
        return await one(rec)

    if is_trace and args.trace_speedup > 0:
        base_ms = recs[0].get("timestamp", 0)
        tasks = [
            paced(r, (r.get("timestamp", 0) - base_ms) / 1000.0
                  / args.trace_speedup)
            for r in recs
        ]
    else:
        tasks = [one(r) for r in recs]
    results = await asyncio.gather(*tasks)
    wall = time.monotonic() - t0
    if not is_trace:
        for rec, text in zip(recs, results):
            print(json.dumps({"prompt": rec.get("prompt", ""),
                              "text": text}))
    ttfts.sort()
    summary = {
        "requests": len(recs),
        "wall_s": round(wall, 3),
        "requests_per_s": round(len(recs) / wall, 2) if wall else None,
    }
    # trace mode measures a real first-token time; the prompt path only
    # observes whole-request latency — name the metrics honestly
    prefix = "ttft" if is_trace else "latency"
    summary[f"{prefix}_p50_s"] = (
        round(ttfts[len(ttfts) // 2], 4) if ttfts else None
    )
    summary[f"{prefix}_p99_s"] = (
        round(ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))], 4)
        if ttfts else None
    )
    if is_trace:  # token counts only exist on the token-level replay path
        summary["output_tok_s"] = round(total_tokens / wall, 2) \
            if wall else None
    print(json.dumps({"batch_summary": summary}), file=sys.stderr)


def _trace_request(rec: dict, block_size: int = 64) -> "Any":
    """Mooncake record -> PreprocessedRequest with DETERMINISTIC tokens
    per hash id, so equal hash prefixes produce equal token blocks and the
    prefix cache sees the trace's sharing structure. The hash → tokens
    mapping uses a FIXED block_size (one hash = block_size tokens): a
    per-record size would make the same hash expand differently across
    records and destroy the sharing the replay exists to measure."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )

    hash_ids = rec.get("hash_ids") or [0]
    isl = max(1, int(rec.get("input_length", 1)))
    tokens: list[int] = []
    for h in hash_ids:
        base = (int(h) * 2654435761) & 0x7FFFFFFF
        tokens.extend(
            (base + j * 40503) % 30000 + 10 for j in range(block_size)
        )
        if len(tokens) >= isl:
            break
    if len(tokens) < isl:  # trace lengths can exceed hash coverage
        tokens.extend(
            (len(tokens) + j) % 30000 + 10
            for j in range(isl - len(tokens))
        )
    return PreprocessedRequest(
        token_ids=tokens[:isl],
        stop_conditions=StopConditions(
            max_tokens=max(1, int(rec.get("output_length", 16))),
            ignore_eos=True,
        ),
    )


def _cp_addr(args) -> tuple[str, int]:
    host, _, port = args.control_plane.partition(":")
    return host or "127.0.0.1", int(port or 7111)


async def connect_runtime(args):
    """A resyncing connection to ``--control-plane``: a store bounce must
    not unregister a serving worker (the session re-grants the lease and
    re-puts the registration keys), and a frontend serves from
    last-known state through it."""
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    host, port = _cp_addr(args)
    return await DistributedRuntime.connect(host=host, port=port,
                                            resync=True)


async def serve_worker(args, chain, rt, *, lease_ttl_s: float = 5.0):
    """Register ``chain.engine`` on the runtime ``rt`` as an in=endpoint
    worker (the reference's ``_serve_worker``, launch/run.py:839): serve
    the engine, put its model entry under the lease, publish its KV events
    (router mode kv) and load metrics. ``--role decode`` wraps the engine
    in the disagg decision (disagg.DisaggDecodeEngine) and serves its pool
    on the block-transfer plane; ``--remote-kv`` serves the pool too and
    fetches prefix misses from peers (G4). The data plane and its
    descriptor are up before the endpoint serves. A DrainController
    (``served.drain``; deregister = revoke the lease, budget
    --drain-timeout) drains the served engine on request, and with
    --system-port a SystemServer (``served.system``, else None) serves
    /metrics, /health, /drain and /chaos. Returns the ServedEndpoint,
    with the engine it serves (``served.engine``: the wrapper under
    --role decode); its shutdown stops the data plane, the config watch
    and the system server (``served.parts``)."""
    import uuid

    from dynamo_tpu_torch.frontend.watcher import ModelEntry, register_llm

    if args.role == "prefill":
        raise ValueError("--role prefill registers no model: use "
                         "serve_prefill_worker")
    engine = chain.engine
    if (args.remote_kv and args.role != "decode"
            and getattr(engine, "offload", None) is None):
        raise SystemExit(
            "--remote-kv needs a G2 host tier (--host-offload-pages > 0)")
    parts = []
    if args.role == "decode":
        from dynamo_tpu_torch.disagg import (
            DisaggConfig,
            DisaggConfigWatcher,
            DisaggDecodeEngine,
            set_disagg_config,
        )

        if (args.max_local_prefill_length is not None
                or args.max_prefill_queue_size is not None):
            conf = DisaggConfig()
            if args.max_local_prefill_length is not None:
                conf.max_local_prefill_length = args.max_local_prefill_length
            if args.max_prefill_queue_size is not None:
                conf.max_prefill_queue_size = args.max_prefill_queue_size
            await set_disagg_config(rt.kv, args.namespace, conf)
        watcher = await DisaggConfigWatcher(rt.kv, args.namespace).start()
        parts.append(watcher)
        engine = DisaggDecodeEngine(
            engine, rt, namespace=args.namespace, conf=watcher,
            prefill_timeout_s=args.prefill_timeout)
    if args.role == "decode" or args.remote_kv:
        # the descriptor key is a fresh id, independent of the lease: a
        # request must not enqueue a prefill job nobody can address
        parts.append(await _attach_data_plane(args, rt, engine,
                                              uuid.uuid4().hex))
    inner = getattr(engine, "engine", engine)
    if args.remote_kv and getattr(inner, "offload", None) is not None:
        from dynamo_tpu_torch.kv_transfer import RemoteKvFetcher

        inner.remote_kv = RemoteKvFetcher(
            rt.kv, args.namespace, engine.worker_id,
            chunk_pages=args.kv_transfer_chunk_pages)

    entry = ModelEntry(
        name=chain.name,
        namespace=args.namespace,
        component=args.component,
        endpoint=args.endpoint_name,
        block_size=args.page_size,
        router_mode=args.router_mode,
        model_path=args.model_path,
    )
    served = await register_llm(rt, engine, entry, lease_ttl_s=lease_ttl_s)
    served.engine, served.parts = engine, parts
    # graceful drain (resilience/drain.py): SIGTERM and POST /drain stop
    # admissions, deregister, let in-flight requests finish, then exit,
    # instead of killing warm KV and live streams
    from dynamo_tpu_torch.resilience.drain import DrainController

    served.drain = DrainController(engine, on_deregister=served.lease.revoke,
                                   timeout_s=args.drain_timeout)
    served.system = None
    if args.system_port is not None:
        from dynamo_tpu_torch.runtime.system_server import SystemServer

        served.system = await SystemServer(
            engine, port=args.system_port, worker_id=str(served.lease_id),
            drain=served.drain).start()
        parts.append(served.system)   # stopped with the other parts
    return served


async def _attach_data_plane(args, rt, engine, worker_id: str):
    """Serve the engine's KV pool on the block-transfer plane and publish
    its blockset descriptor under ``worker_id``; returns the server."""
    from dynamo_tpu_torch.kv_transfer import (
        BlocksetDescriptor,
        BlockTransferServer,
        KvCacheLayout,
        publish_descriptor,
    )

    inner = getattr(engine, "engine", engine)
    engine.worker_id = worker_id
    srv = BlockTransferServer(
        read_fn=inner.export_pages,
        write_fn=getattr(engine, "guarded_import", inner.import_pages),
        read_hashes_fn=inner.export_pages_by_hash,
        # chunk-pipelined G4 serving: cheap probes and streamed hash reads
        count_hashes_fn=inner.allocator.cached_prefix_len,
        read_hashes_stream_fn=inner.export_hash_stream)
    host, port = await srv.start()
    cfg, ecfg = inner.config, inner.ecfg
    await publish_descriptor(rt.kv, args.namespace, BlocksetDescriptor(
        worker_id=worker_id, host=host, port=port,
        layout=KvCacheLayout(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            page_size=ecfg.page_size, head_dim=cfg.head_dim,
            # what moves on the wire: int8 payloads (+ header scales) for
            # a quantized pool
            dtype=("int8" if ecfg.kv_quant == "int8"
                   else ecfg.cache_dtype))))
    return srv


async def serve_prefill_worker(args, chain, rt):
    """``--role prefill``: consume the prefill queue of ``--namespace``
    with ``chain.engine`` (no model registration, as the reference's
    prefill_worker.py). Returns the started disagg.PrefillWorker."""
    from dynamo_tpu_torch.disagg import PrefillWorker

    return await PrefillWorker(rt, chain.engine,
                               namespace=args.namespace).start()


def sigterm_event() -> asyncio.Event:
    """An event the running loop sets on SIGTERM (a clean exit, code 0).
    Call it before printing a ready line, so a SIGTERM sent on seeing
    that line finds the handler in place."""
    import signal

    ev = asyncio.Event()
    try:
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, ev.set)
    except (NotImplementedError, RuntimeError):
        pass  # loops without signal support
    return ev


async def _serve_worker(args, chain) -> None:
    """in=endpoint: serve until the lease is lost or a drain completes.
    SIGTERM (and POST /drain on the system server) requests the drain:
    admissions stop, the lease is revoked, in-flight streams finish (up
    to --drain-timeout), then the worker exits with code 0."""
    import signal

    rt = await connect_runtime(args)
    served = await serve_worker(args, chain, rt)
    drain = served.drain
    try:
        asyncio.get_running_loop().add_signal_handler(
            signal.SIGTERM, lambda: drain.request_drain(reason="SIGTERM"))
    except (NotImplementedError, RuntimeError):
        pass  # loops without signal support: /drain still works
    if served.system is not None:
        print(f"system server on :{served.system.port}", flush=True)
    print(
        f"worker {chain.name!r} instance {served.lease_id} "
        f"({args.role}) serving "
        f"{args.namespace}/{args.component}/{args.endpoint_name}",
        flush=True,
    )
    lost = asyncio.ensure_future(served.lease.lost.wait())
    drained = asyncio.ensure_future(drain.wait_drained())
    try:
        done, pending = await asyncio.wait(
            {lost, drained}, return_when=asyncio.FIRST_COMPLETED)
        for t in pending:
            t.cancel()
        print("drained; shutting down" if drained in done
              else "lease lost; shutting down", flush=True)
        print(f"worker instance {served.lease_id} served "
              f"{served.server.handler.requests} requests", flush=True)
    finally:
        await served.shutdown()
        await rt.close()


async def _serve_prefill_worker(args, chain) -> None:
    """in=endpoint --role prefill: serve until SIGTERM."""
    rt = await connect_runtime(args)
    worker = await serve_prefill_worker(args, chain, rt)
    stop = sigterm_event()
    print(f"prefill worker consuming {args.namespace}.prefill", flush=True)
    try:
        await stop.wait()
        print(f"SIGTERM; shutting down (prefill worker handled "
              f"{worker.jobs_handled} jobs)", flush=True)
    finally:
        await worker.stop()
        await rt.close()


async def _serve_http_dynamic(args) -> None:
    """in=http + --control-plane: discover models instead of building a
    local chain (reference _serve_http_dynamic, launch/run.py:1037)."""
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher

    rt = await connect_runtime(args)
    manager = ModelManager()
    kv_recorder = None
    if args.record_kv_events:
        from dynamo_tpu_torch.recorder import KvRecorder

        kv_recorder = KvRecorder(args.record_kv_events)
    watcher = await ModelWatcher(
        rt, manager, namespace=args.namespace, kv_recorder=kv_recorder,
        heartbeat_ttl_s=args.health_heartbeat_ttl).start()
    svc = HttpService(manager, host=args.http_host, port=args.http_port)
    await svc.start()
    stop = sigterm_event()
    print(
        f"dynamic frontend on http://{args.http_host}:{svc.port} "
        f"(namespace {args.namespace!r})", flush=True,
    )
    try:
        await stop.wait()
    finally:
        await svc.stop()
        await watcher.stop()
        await rt.close()
        if kv_recorder is not None:
            kv_recorder.close()


def _shutdown_chain(chain) -> None:
    """Stop the engine's loop thread before the interpreter exits."""
    if chain is None:
        return
    try:
        asyncio.run(chain.engine.stop())
    except Exception as e:  # noqa: BLE001 - teardown proceeds
        print(f"engine stop failed: {e}", file=sys.stderr)


def run_cli(argv: Optional[list[str]] = None) -> int:
    # intermixed: in=/out= positionals may appear between/after flags
    args = build_parser().parse_intermixed_args(argv)
    refuse_unported(args)
    # fault injection armed before anything starts serving
    chaos_spec = args.chaos or os.environ.get("DYNAMO_CHAOS")
    if chaos_spec:
        from dynamo_tpu_torch.resilience.chaos import CHAOS

        CHAOS.configure(chaos_spec)
    inp, _ = _parse_io(args.io)
    if not (inp in ("http", "text", "stdin", "endpoint")
            or inp.startswith("batch:")):
        raise SystemExit(f"unknown input in={inp!r}")
    if inp == "endpoint" and not args.control_plane:
        raise SystemExit("in=endpoint requires --control-plane")
    chain = None
    try:
        if inp == "http" and args.control_plane:
            asyncio.run(_serve_http_dynamic(args))
            return 0
        inp, chain = build_chain(args)
        device = getattr(chain.engine, "device", None)
        if device is not None:
            print(f"{type(chain.engine).__name__} on {device}",
                  file=sys.stderr, flush=True)
        if inp == "endpoint":
            # serve_engine (or the prefill worker) starts the engine
            asyncio.run(_serve_prefill_worker(args, chain)
                        if args.role == "prefill"
                        else _serve_worker(args, chain))
            return 0
        chain.engine.start()
        if inp == "http":
            asyncio.run(_serve_http(args, chain))
        elif inp == "text":
            asyncio.run(_serve_text(args, chain))
        elif inp == "stdin":
            asyncio.run(_serve_stdin(args, chain))
        else:
            asyncio.run(_serve_batch(args, chain, inp[len("batch:"):]))
    except KeyboardInterrupt:
        pass
    finally:
        _shutdown_chain(chain)
    return 0


if __name__ == "__main__":
    sys.exit(run_cli())
