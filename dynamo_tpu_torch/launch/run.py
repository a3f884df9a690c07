"""``python -m dynamo_tpu_torch.launch.run in=<input> out=<engine>``: the
port's launcher (a copy of the JAX package's launch/run.py, cut to local
serving; reference `dynamo-run`, launch/dynamo-run/src/lib.rs:94-165).

Inputs (reference entrypoint/input.rs:29-45):
  in=http        OpenAI HTTP frontend on --http-host:--http-port; with
                 --control-plane HOST:PORT it serves the models that
                 workers register there instead of a local engine, each
                 KV-routed one with a fleet view (/debug/kv_fleet) and,
                 with --kv-replication-target above 1, a replication
                 controller that pushes hints and hot prefixes to its
                 workers
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
  out=torch      TorchEngine on --device (default cuda: without a card the
                 engine raises), serving --model-path (an HF safetensors
                 directory, a cached hub id, or a .gguf file: config,
                 tokenizer, chat template and weights come from it;
                 --quantize int8 quantizes the weights as they load) or
                 random weights from --model-config;
                 --speculative ngram|draft (with --draft-model-config)
                 speculates the linear chain, with adaptive K
                 (--spec-adaptive, --spec-min-k) and the acceptance gate
                 (--spec-gate-*, --spec-rearm-tokens), or a token tree
                 under --spec-tree on (--spec-branches,
                 --spec-tree-budget): an n-gram trie or a comb draft;
                 --max-waiting-requests and --max-waiting-prefill-tokens
                 bound its waiting queue (429 + Retry-After past them)
                 and --preempt-running on lets a HIGH-priority request
                 migrate the lowest-priority running stream;
                 --prof-attribution, --slo-ttft-target, --slo-itl-target,
                 --slo-objective and --forensics-sample-rate set the
                 telemetry plane (round attribution, SLO burn rates,
                 dossier sampling), and --trace-sample-rate the share of
                 requests the frontend traces in full

The parser keeps every flag of the reference's, so a command line written
for it parses here; a flag of a plane the port does not serve yet is
refused with SystemExit when it is set away from its default (see
UNPORTED_FLAGS), never ignored. Without --model-path the chain uses the
test tokenizer and the default chat template, as the reference does.
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
_SERVED_CONFIGS = ("tiny", "tiny_moe", "llama3_1b", "llama3_8b",
                   "llama3_1b_int8", "llama3_8b_int8")

# flags of the reference's parser for planes the port does not serve:
# flag -> (argparse keywords with the reference's default, what it drives)
UNPORTED_FLAGS: dict[str, tuple[dict, str]] = {
    "--tensor-parallel-size": (dict(type=int, default=1),
                               "tensor parallelism"),
    "--num-nodes": (dict(type=int, default=1), "multi-host engines"),
    "--node-rank": (dict(type=int, default=0), "multi-host engines"),
    "--leader-addr": (dict(default=None, metavar="HOST:PORT"),
                      "multi-host engines"),
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
    p.add_argument("--model-path",
                   help="local HF model dir (config/tokenizer/safetensors), "
                        "a cached hub id, or a .gguf file")
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
    # overload plane (overload/)
    p.add_argument("--max-waiting-requests", type=int,
                   default=cfg.max_waiting_requests,
                   help="bounded admission: waiting-queue depth budget; "
                        "intake past it is refused with a retriable "
                        "overload error (HTTP 429 + Retry-After at the "
                        "frontend). 0 = unbounded")
    p.add_argument("--max-waiting-prefill-tokens", type=int,
                   default=cfg.max_waiting_prefill_tokens,
                   help="bounded admission: prompt-token budget over "
                        "the waiting queue. 0 = unbounded")
    p.add_argument("--preempt-running",
                   default="on" if cfg.preempt_running else "off",
                   choices=["on", "off"],
                   help="allow a waiting HIGH-priority request to "
                        "force-migrate the lowest-priority RUNNING "
                        "stream (preemption-as-migration via the "
                        "resilience plane; exactly-once, greedy "
                        "token-identical)")
    p.add_argument("--round-pipeline",
                   default="on" if cfg.round_pipeline else "off",
                   choices=["on", "off"],
                   help="round pipelining: dispatch round N+1 before "
                        "processing round N's tokens; off restores the "
                        "strict round order")
    # the telemetry plane (telemetry/), with the reference's help
    p.add_argument("--prof-attribution",
                   default="on" if cfg.prof_attribution else "off",
                   choices=["on", "off"],
                   help="per-round host-segment attribution "
                        "(dynamo_host_round_seconds{segment} + "
                        "/debug/prof); near-zero overhead, off only "
                        "for A/B measurement")
    p.add_argument("--slo-ttft-target", type=float,
                   default=cfg.slo_ttft_target_s,
                   help="TTFT SLO target in seconds backing the "
                        "dynamo_slo_ttft_burn_rate gauge")
    p.add_argument("--slo-itl-target", type=float,
                   default=cfg.slo_itl_target_s,
                   help="ITL SLO target in seconds backing the "
                        "dynamo_slo_itl_burn_rate gauge")
    p.add_argument("--slo-objective", type=float,
                   default=cfg.slo_objective,
                   help="SLO objective (fraction of observations that "
                        "must meet the target, e.g. 0.99); burn rate = "
                        "frac-over-target / (1 - objective)")
    p.add_argument("--forensics-sample-rate", type=float,
                   default=cfg.forensics_sample_rate,
                   help="fraction of NON-breaching requests that still "
                        "get an SLO-breach-style dossier captured into "
                        "/debug/outliers (breaches are always captured; "
                        "0 disables the healthy-baseline sample)")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="fraction of requests fully traced by the frontend "
                        "(high-QPS deployments sample; migrated/failed "
                        "requests are always traced)")
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
    # fleet prefix economy (kv_router/fleet.py + prefetch.py)
    p.add_argument("--kv-replication-target", type=int,
                   default=cfg.kv_replication_target,
                   help="desired fleet copies of a hot KV block: the "
                        "frontend's replication controller pushes "
                        "under-replicated hot prefix chains into workers' "
                        "G2 tiers ahead of demand and warm-starts cold "
                        "joiners from the fleet hot set (<= 1 disables "
                        "the controller)")
    p.add_argument("--kv-prefetch-hot-k", type=int,
                   default=cfg.kv_prefetch_hot_k,
                   help="hot prefix chains examined per controller tick "
                        "and pushed to a cold joiner")
    p.add_argument("--kv-prefetch-interval", type=float,
                   default=cfg.kv_prefetch_interval_s, metavar="SECONDS",
                   help="replication-controller tick period")
    p.add_argument("--kv-freq-halflife", type=float,
                   default=cfg.kv_freq_halflife_s, metavar="SECONDS",
                   help="KV indexer access-heat decay half-life (0 = raw "
                        "undecayed counters, the legacy behavior)")
    p.add_argument("--no-kv-dedup-admission", action="store_true",
                   help="disable dedup-by-hash admission hints: G4 "
                        "probes ignore the fleet holder digest")
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
    # speculative decoding (dynamo_tpu_torch/spec/)
    p.add_argument("--speculative", default="off",
                   choices=["off", "ngram", "draft"],
                   help="speculative decoding: ngram = model-free "
                        "prompt-lookup proposer; draft = small draft "
                        "model sharing the tokenizer (--draft-model-"
                        "config); eligible requests verify K proposed "
                        "tokens per target forward")
    p.add_argument("--num-speculative-tokens", type=int, default=4,
                   help="K: proposed tokens per verify step (the cap "
                        "when --spec-adaptive is on)")
    p.add_argument("--spec-adaptive", default="on", choices=["on", "off"],
                   help="acceptance-adaptive K: each slot's effective K "
                        "walks within [--spec-min-k, K] on its rolling "
                        "acceptance rate, and slots whose rate collapses "
                        "de-speculate back to the fused decode round "
                        "(exported as dynamo_spec_effective_k)")
    p.add_argument("--spec-min-k", type=int, default=1,
                   help="adaptive-K floor per slot")
    p.add_argument("--spec-tree", default="off", choices=["on", "off"],
                   help="tree speculation: draft up to --spec-branches "
                        "candidates per divergence point and verify the "
                        "whole tree in one forward under a tree-causal "
                        "mask; acceptance keeps the deepest surviving "
                        "root-to-leaf path")
    p.add_argument("--spec-branches", type=int, default=4,
                   help="branch fan per tree level (the cap when "
                        "--spec-adaptive walks the branches axis)")
    p.add_argument("--spec-tree-budget", type=int, default=0,
                   help="packed tree node budget incl. the root (one "
                        "compiled verify shape serves every tree); 0 = "
                        "auto: 1 + K * branches")
    p.add_argument("--spec-gate-acceptance", type=float, default=0.0,
                   help="de-speculate a stream whose live acceptance "
                        "EWMA stays below this for --spec-gate-window "
                        "consecutive verify steps (0 = no gate); gated "
                        "streams may re-arm after --spec-rearm-tokens "
                        "emitted tokens")
    p.add_argument("--spec-gate-window", type=int, default=4,
                   help="consecutive below-gate verify steps before a "
                        "stream de-speculates")
    p.add_argument("--spec-rearm-tokens", type=int, default=256,
                   help="emitted tokens before a gated stream re-arms "
                        "speculation (doubles each time it re-gates; "
                        "0 = gated streams never re-arm)")
    p.add_argument("--draft-model-config", default=None,
                   help="canned ModelConfig name for the draft model "
                        "(speculative=draft; must share the target "
                        "vocab, e.g. tiny for --model-config tiny). "
                        "Drafting is batched across speculating slots "
                        "into one device program per round")
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


def _resolve_checkpoint(args) -> tuple[Any, Any, str, Optional[dict]]:
    """(tokenizer, formatter, served name, GGUF metadata or None) of
    ``--model-path`` (the reference's resolution: a directory, a cached
    hub id or a .gguf file; the name is the basename); ``args.model_path``
    becomes the resolved path."""
    from dynamo_tpu_torch.model_resolver import resolve_model
    from dynamo_tpu_torch.preprocessor import PromptFormatter
    from dynamo_tpu_torch.tokenizer import HfTokenizer

    resolved = resolve_model(args.model_path)
    args.model_path = resolved.path
    if resolved.kind == "gguf":
        # single-file serving: config, tokenizer and dequantized weights
        # all come out of the .gguf
        from dynamo_tpu_torch.gguf import gguf_tokenizer, read_gguf

        meta, _ = read_gguf(resolved.path)
        name = os.path.basename(resolved.path).removesuffix(".gguf")
        return gguf_tokenizer(meta), PromptFormatter(), name, meta
    name = os.path.basename(resolved.path.rstrip("/"))
    return (HfTokenizer.from_dir(resolved.path),
            PromptFormatter.from_dir(resolved.path), name, None)


def _load_checkpoint(args, cfg, gguf_meta) -> tuple[Any, Any]:
    """(config, params) of the checkpoint on the engine's device: the
    weights load in the model dtype (bf16, the reference's), quantized as
    they load under --quantize, and are widened to --cache-dtype when it
    differs (the engine computes in one dtype)."""
    import torch

    from dynamo_tpu_torch.models import llama

    device = args.device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchEngine runs on CUDA unless device='cpu' is passed, and no "
            "CUDA device is available")
    if gguf_meta is not None:
        from dynamo_tpu_torch.gguf import load_gguf_params

        params = load_gguf_params(cfg, args.model_path, device=device)
    else:
        params = llama.load_hf_params(cfg, args.model_path, device=device)
    if args.cache_dtype != cfg.dtype:
        params = llama.cast_params(params, llama.torch_dtype(args.cache_dtype))
    return dataclasses.replace(cfg, dtype=args.cache_dtype), params


def build_chain(args, *, params: Any = None, tokenizer: Any = None) -> tuple:
    """(input, ModelChain) for the selected engine. Programmatic callers
    may pass prebuilt ``params`` (the engine's weights, on its device) and
    a ``tokenizer``; the default tokenizer is the checkpoint's
    (``--model-path``) or the test tokenizer."""
    from dynamo_tpu_torch.backend import Backend
    from dynamo_tpu_torch.frontend.model_manager import ModelChain
    from dynamo_tpu_torch.preprocessor import (
        OpenAIPreprocessor,
        PromptFormatter,
    )
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    inp, out = _parse_io(args.io)
    gguf_meta = None
    fmt = PromptFormatter()
    name = args.model_name or "echo"
    if args.model_path:
        ck_tok, fmt, ck_name, gguf_meta = _resolve_checkpoint(args)
        tok = tokenizer if tokenizer is not None else ck_tok
        name = args.model_name or ck_name
    else:
        tok = tokenizer if tokenizer is not None else make_test_tokenizer()

    if out == "echo":
        from dynamo_tpu_torch.engines import EchoEngine

        engine: Any = EchoEngine()
    elif out == "torch":
        from dynamo_tpu_torch.engine.config import EngineConfig
        from dynamo_tpu_torch.engine.engine import TorchEngine
        from dynamo_tpu_torch.models.config import ModelConfig

        if args.model_path:
            if gguf_meta is not None:
                from dynamo_tpu_torch.gguf import config_from_gguf

                cfg = config_from_gguf(gguf_meta)
            else:
                cfg = ModelConfig.from_pretrained(args.model_path)
            if args.quantize:
                cfg = dataclasses.replace(cfg, quant=args.quantize)
            if params is None:
                cfg, params = _load_checkpoint(args, cfg, gguf_meta)
            else:
                cfg = dataclasses.replace(cfg, dtype=args.cache_dtype)
        elif args.model_config is None:
            raise SystemExit("out=torch needs --model-config "
                             f"({'|'.join(_SERVED_CONFIGS)}) or --model-path")
        elif args.model_config not in _SERVED_CONFIGS:
            raise SystemExit(
                f"--model-config {args.model_config!r} is not served by the "
                f"PyTorch port (served: {', '.join(_SERVED_CONFIGS)})")
        else:
            # the engine computes in one dtype: random weights are made in
            # the cache dtype (the reference promotes bf16 weights to it)
            cfg = getattr(ModelConfig, args.model_config)(
                dtype=args.cache_dtype)
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
            kv_dedup_admission=not args.no_kv_dedup_admission,
            speculative=args.speculative,
            num_speculative_tokens=args.num_speculative_tokens,
            spec_adaptive=args.spec_adaptive == "on",
            spec_min_k=args.spec_min_k,
            spec_tree=args.spec_tree == "on",
            spec_branches=args.spec_branches,
            spec_tree_budget=args.spec_tree_budget,
            spec_gate_acceptance=args.spec_gate_acceptance,
            spec_gate_window=args.spec_gate_window,
            spec_rearm_tokens=args.spec_rearm_tokens,
            max_waiting_requests=args.max_waiting_requests,
            max_waiting_prefill_tokens=args.max_waiting_prefill_tokens,
            preempt_running=args.preempt_running == "on",
            prof_attribution=args.prof_attribution == "on",
            slo_ttft_target_s=args.slo_ttft_target,
            slo_itl_target_s=args.slo_itl_target,
            slo_objective=args.slo_objective,
            forensics_sample_rate=args.forensics_sample_rate,
        )
        draft_cfg = None
        if args.speculative == "draft":
            if not args.draft_model_config:
                raise SystemExit(
                    "--speculative draft needs --draft-model-config")
            # the draft computes in the engine's one dtype, as the target
            draft_cfg = getattr(ModelConfig, args.draft_model_config)(
                dtype=args.cache_dtype)
        engine = TorchEngine(cfg, ecfg, params=params, device=args.device,
                             draft_config=draft_cfg)
    elif out in _UNPORTED_ENGINES:
        raise SystemExit(f"out={out}: {_UNPORTED_ENGINES[out]} is not "
                         f"served by the PyTorch port")
    else:
        raise SystemExit(f"unknown engine out={out!r}")

    pre = OpenAIPreprocessor(tokenizer=tok, formatter=fmt, model_name=name)
    return inp, ModelChain(
        name=name, preprocessor=pre, engine=engine, backend=Backend(tok)
    )


async def _serve_http(args, chain) -> None:
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService

    manager = ModelManager()
    manager.register(chain)
    svc = HttpService(manager, host=args.http_host, port=args.http_port,
                      trace_sample_rate=args.trace_sample_rate,
                      forensics_sample_rate=args.forensics_sample_rate)
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


def fleet_configs(args) -> dict:
    """The dynamic frontend's router and fleet-controller configs from the
    flags (the ModelWatcher's ``router_config`` and ``prefetch_config``):
    the indexer's heat half-life (0: raw counters), and a replication
    controller only when --kv-replication-target > 1 ("one copy is
    enough" runs none)."""
    from dynamo_tpu_torch.kv_router.prefetch import PrefetchConfig
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig

    prefetch = None
    if args.kv_replication_target > 1:
        prefetch = PrefetchConfig(
            replication_target=args.kv_replication_target,
            hot_k=args.kv_prefetch_hot_k,
            interval_s=args.kv_prefetch_interval)
    return dict(
        router_config=KvRouterConfig(
            freq_halflife_s=args.kv_freq_halflife or None),
        prefetch_config=prefetch)


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
        heartbeat_ttl_s=args.health_heartbeat_ttl,
        **fleet_configs(args)).start()
    svc = HttpService(manager, host=args.http_host, port=args.http_port,
                      trace_sample_rate=args.trace_sample_rate,
                      forensics_sample_rate=args.forensics_sample_rate)
    # /debug/kv_fleet serves the watcher's live per-model fleet views
    svc.fleet_views = watcher.fleet_views
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
