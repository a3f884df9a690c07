"""The fused engine round on the card, in three modes (the JAX package's
tools/profile_round.py for TorchEngine).

    python -m dynamo_tpu_torch.tools.profile_round [--device cpu|cuda]
    python -m dynamo_tpu_torch.tools.profile_round --dispatch-budget \
        [--model-config tiny|llama3_8b] [--kv-quant none|int8] \
        [--round-pipeline on|off] [--requests N] [--osl N] \
        [--baseline prior.json]
    python -m dynamo_tpu_torch.tools.profile_round --spec \
        [off|ngram|draft|draft-perslot|tree|tree-draft|tree-vs-linear|all]

The device is the card unless ``--device cpu`` is given. Each mode
prints JSON lines.

Default mode (kernel timing): the fused round at Llama-3.2-1B's width
(``--model-config`` llama3_1b), B = 32 lanes, S = 1024 positions, R =
16 steps a round, every lane decoding at a context of 356. Three
variants: the round with its ring -> ctx flush, the round without it,
and the flush alone. Each is captured as a CUDA graph of the engine's
own round functions (engine/graphs.py ``run_round``, ``round_steps``,
``flush_round``) on a TorchEngine's state, with the lanes' contexts
reset to 356 at its start, and timed with CUDA events over replays:
device ms a round and a step, the attention kernel's executions on the
card over the timed replays, and ``attn_roofline_frac``: for the two
rounds roofline.py's (the round's bytes a step, each lane's 355 ctx rows
below the ring base, at that step rate over the card's peak bandwidth),
for the flush alone its own bytes (each lane's ring rows read and
written into its context lane) over its time and the peak. The JAX tool
also sweeps the TPU kernel's chunk; the port's kernel has no such knob:
its wrapper picks the context-split count per call from the card's
cluster residency (ops/flash_decode.py ``context_splits``), so the mode
times that choice alone and prints it (``context_splits``). On the CPU
each variant runs once, eagerly, and no time is reported.

``--dispatch-budget``: TorchEngine through a steady decode workload
(``--requests`` prompts of 48 tokens from seed 0, ``--osl`` new tokens
each, after a warm-up of 8): the engine's dispatch counts over the
window and their number a decode round, the wall ms a step, the device
ms a step of the engine's round replayed alone (CUDA events on the card,
the host clock on the CPU), the host ms a step (wall - device), the host
time a step by attribution segment (``host_breakdown``,
telemetry/prof.py) with its coverage, the round-pipelining view, and the
byte accounting of roofline.py at the workload's steady context (the
weights are the engine's parameter tensors' bytes, int8 weights and
their scales for a w8a16 model; steps a second come from wall time).
``--baseline`` adds the deltas against a prior run's JSON.
``--model-config tiny`` (f32) runs on the CPU in seconds; ``llama3_8b``
(random bf16 weights from seed 0) is the card's configuration.

``--spec``: device dispatches per emitted token of the speculative
paths on ModelConfig.tiny (f32, random weights from seed 0), one JSON
line a mode: off, n-gram, draft (batched: one draft program a round),
draft-perslot (``EngineConfig.spec_batch_draft=False``), tree (n-gram
trie), tree-draft; ``tree-vs-linear`` runs off, n-gram and tree and adds
a comparison line; ``all`` (the default of a bare ``--spec``) the first
six.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import Optional

import numpy as np
import torch

# the default mode's shape (the JAX tool's)
N = 16
B, S = 32, 1024
CTX = 356


def _engine(model_config: str, device: str, n_req: int, kv_quant: str,
            round_pipeline: bool):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig

    if model_config == "tiny":
        cfg = ModelConfig.tiny(dtype="float32")
        ecfg = EngineConfig(
            num_pages=128, page_size=16, max_pages_per_seq=16,
            max_decode_slots=max(n_req, 2), prefill_buckets=(64,),
            cache_dtype="float32", kv_quant=kv_quant,
            round_pipeline=round_pipeline)
    else:
        cfg = getattr(ModelConfig, model_config)()
        ecfg = EngineConfig(max_decode_slots=max(n_req, 2),
                            kv_quant=kv_quant, round_pipeline=round_pipeline)
    return cfg, ecfg, TorchEngine(cfg, ecfg, device=device)


def _device_ms_per_step(eng, ctx_len: int, reps: int = 10) -> float:
    """One replayed greedy round (its graph on the card) at every lane
    decoding at ``ctx_len``, alone: ms a step. Run after the engine
    stopped, on its own state."""
    e = eng.ecfg
    B = e.max_decode_slots
    dev = eng._dev
    dev["ctx"].fill_(min(ctx_len, e.max_context))
    dev["dest"].copy_(torch.arange(B, dtype=dev["dest"].dtype,
                                   device=dev["dest"].device))
    dev["tokens"].fill_(1)
    one = lambda: eng.graphs.round(False, False, None)  # noqa: E731
    for _ in range(2):
        one()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            one()
        t1.record()
        t1.synchronize()
        ms = t0.elapsed_time(t1)
    else:
        t = time.monotonic()
        for _ in range(reps):
            one()
        ms = (time.monotonic() - t) * 1e3
    return ms / (reps * e.flush_every)


def _byte_accounting(eng, ctx_len: int, steps_per_s: Optional[float]
                     ) -> dict:
    """roofline.py's accounting of ``eng``'s round with every lane's ctx
    region at ``ctx_len`` live rows, against the card's peak when it is
    in the table."""
    from dynamo_tpu_torch.roofline import (
        chip_info,
        decode_byte_accounting,
        params_nbytes,
    )

    e = eng.ecfg
    _, peak, _ = chip_info(eng.device)
    return decode_byte_accounting(
        eng.config, e, [min(ctx_len, e.max_context)] * e.max_decode_slots,
        params_nbytes(eng.params), steps_per_s=steps_per_s,
        peak_bw=peak[1] if peak else None)


BYTE_FIELDS = ("kv_bytes_per_step", "total_bytes_per_step",
               "bytes_per_step_breakdown", "kv_ctx_bytes_vs_bf16",
               "attn_roofline_frac")


def dispatch_budget(model_config: str = "tiny", device: str = "cuda",
                    n_req: int = 4, osl: int = 32, kv_quant: str = "none",
                    round_pipeline: bool = True,
                    baseline: Optional[str] = None) -> dict:
    """The dispatch-budget JSON (see the module docstring)."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )

    cfg, ecfg, eng = _engine(model_config, device, n_req, kv_quant,
                             round_pipeline)
    eng.start()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, 48).tolist()
               for _ in range(n_req)]

    async def one(p, mt):
        n = 0
        async for out in eng.generate(PreprocessedRequest(
                token_ids=list(p),
                stop_conditions=StopConditions(max_tokens=mt,
                                               ignore_eos=True))):
            n += len(out.token_ids)
        return n

    async def run() -> dict:
        await asyncio.gather(*[one(p, 8) for p in prompts])  # warm-up
        d0 = dict(eng.dispatch_counts)
        p0 = eng.prof.totals()
        steps0 = eng.step_count
        t0 = time.monotonic()
        tokens = sum(await asyncio.gather(*[one(p, osl) for p in prompts]))
        wall = time.monotonic() - t0
        p1 = eng.prof.totals()
        return {
            "tokens": tokens, "wall_s": wall,
            "steps": eng.step_count - steps0,
            "delta": {k: v - d0.get(k, 0)
                      for k, v in eng.dispatch_counts.items()},
            "prof": {"rounds": p1["rounds"] - p0["rounds"],
                     "wall_s": p1["wall_s"] - p0["wall_s"],
                     "segments": {s: p1["segments"][s] - p0["segments"][s]
                                  for s in p1["segments"]}},
        }

    async def run_and_stop() -> dict:
        try:
            return await run()
        finally:
            # quiesce: the loop must not patch the state the timed
            # replays below run on
            await eng.stop()

    stats = asyncio.run(run_and_stop())
    pipe = eng.pipeline_stats()
    with torch.no_grad():   # as the engine loop runs its rounds
        device_ms = _device_ms_per_step(eng, 48 + osl)
    delta = stats["delta"]
    rounds = delta.get("round", 0) + delta.get("round_seal", 0)
    steps = max(stats["steps"], 1)
    wall_ms = stats["wall_s"] / steps * 1e3
    prof = stats["prof"]
    host_breakdown = {s: round(v / steps * 1e3, 5)
                      for s, v in prof["segments"].items()}
    attributed = sum(prof["segments"].values())
    byte_acct = _byte_accounting(
        eng, 48 + osl,
        stats["steps"] / stats["wall_s"] if stats["wall_s"] > 0 else None)
    out = {
        "mode": "dispatch-budget",
        "model_config": model_config,
        "device": str(eng.device),
        "kv_quant": kv_quant,
        "slots": n_req,
        "tokens": stats["tokens"],
        "steps": stats["steps"],
        "rounds": rounds,
        "dispatch_breakdown": delta,
        "dispatches_per_round": round(sum(delta.values()) / max(rounds, 1),
                                      3),
        "standalone_seal_dispatches": delta.get("seal", 0),
        "wall_ms_per_step": round(wall_ms, 4),
        "device_ms_per_step": round(device_ms, 4),
        "host_ms_per_step": round(wall_ms - device_ms, 4),
        "host_breakdown": host_breakdown,
        "host_prof_rounds": prof["rounds"],
        "host_prof_coverage": (round(attributed / prof["wall_s"], 4)
                               if prof["wall_s"] > 0 else 1.0),
        "round_pipeline": pipe["round_pipeline"],
        "pipelined_dispatches": pipe["pipelined_dispatches"],
        "pipeline_depth": round(pipe["pipeline_depth"], 4),
        "overlap_ratio": round(pipe["overlap_ratio"], 4),
        "pipe_flushes": pipe["pipe_flushes"],
        **{k: byte_acct[k] for k in BYTE_FIELDS},
    }
    if baseline:
        # negative: this run is cheaper than the baseline
        with open(baseline) as f:
            base = json.load(f)
        base_bd = base.get("host_breakdown") or {}
        base_bytes = base.get("bytes_per_step_breakdown") or {}
        out["baseline_deltas"] = {
            "host_ms_per_step": round(
                out["host_ms_per_step"] - base.get("host_ms_per_step", 0.0),
                4),
            "device_ms_per_step": round(
                device_ms - base.get("device_ms_per_step", 0.0), 4),
            "host_breakdown": {s: round(v - base_bd.get(s, 0.0), 5)
                               for s, v in host_breakdown.items()},
            "kv_bytes_per_step": (byte_acct["kv_bytes_per_step"]
                                  - base.get("kv_bytes_per_step", 0)),
            "bytes_per_step_breakdown": {
                s: v - base_bytes.get(s, 0)
                for s, v in byte_acct["bytes_per_step_breakdown"].items()},
        }
    return out


# --spec mode -> (speculative, spec_batch_draft, spec_tree)
SPEC_MODES = {
    "off": ("off", True, False),
    "ngram": ("ngram", True, False),
    "draft": ("draft", True, False),
    "draft-perslot": ("draft", False, False),
    # tree speculation: multi-branch drafts, a tree-masked verify, one
    # packed fetch a verify round
    "tree": ("ngram", True, True),
    "tree-draft": ("draft", True, True),
}
SPEC_ALL = list(SPEC_MODES)


def spec_dispatch(modes: list[str], n_req: int = 4, osl: int = 32,
                  device: str = "cuda", params=None) -> list[dict]:
    """Device dispatches per emitted token of each speculative path on
    ModelConfig.tiny (f32): the fused rounds, state patches, first-token
    samples (the engine's dispatch counts), draft programs (one a round
    batched, about K a slot a round per slot) and verify programs (the
    speculation counters), one dict a mode (``tree-vs-linear``: off,
    n-gram, tree and a comparison). ``params`` default to
    ``init_params(seed 0)`` on ``device``; the draft model is the target
    itself."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )

    cfg = ModelConfig.tiny(dtype="float32")
    if params is None:
        params = llama.init_params(cfg, 0, device=device)
    rng = np.random.RandomState(0)
    # repetitive prompts, so the n-gram path accepts drafts
    pat = rng.randint(1, cfg.vocab_size, 8).tolist()
    prompts = [pat * 6 for _ in range(n_req)]

    async def run_mode(mode: str) -> dict:
        speculative, batch_draft, tree = SPEC_MODES[mode]
        ekw = ({"draft_config": cfg, "draft_params": params}
               if speculative == "draft" else {})
        eng = TorchEngine(
            cfg,
            EngineConfig(
                num_pages=64, page_size=16, max_pages_per_seq=8,
                max_decode_slots=max(n_req, 2), prefill_buckets=(64,),
                cache_dtype="float32", speculative=speculative,
                num_speculative_tokens=4, spec_batch_draft=batch_draft,
                spec_tree=tree, spec_branches=4),
            params=params, device=device, **ekw)
        d0 = dict(eng.dispatch_counts)

        async def one(p):
            n = 0
            async for out in eng.generate(PreprocessedRequest(
                    token_ids=list(p),
                    stop_conditions=StopConditions(max_tokens=osl,
                                                   ignore_eos=True))):
                n += len(out.token_ids)
            return n

        eng.start()
        try:
            tokens = sum(await asyncio.gather(*[one(p) for p in prompts]))
            st = eng.spec.stats() if eng.spec else {}
        finally:
            await eng.stop()
        d = {k: v - d0.get(k, 0) for k, v in eng.dispatch_counts.items()}
        counts = {"round": d.get("round", 0) + d.get("round_seal", 0),
                  "patch": d.get("patch", 0),
                  "first": d.get("sample_first", 0)}
        draft_d = st.get("spec_draft_dispatch_total", 0)
        verify_d = st.get("spec_verify_dispatch_total", 0)
        total = sum(counts.values()) + draft_d + verify_d
        out = {
            "mode": mode,
            "slots": n_req,
            "tokens": tokens,
            "round_dispatches": counts["round"],
            "patch_dispatches": counts["patch"],
            "first_dispatches": counts["first"],
            "draft_dispatches": draft_d,
            "verify_dispatches": verify_d,
            "draft_dispatches_per_verify": round(
                draft_d / max(verify_d, 1), 3),
            "dispatches_per_token": round(total / max(tokens, 1), 4),
            "spec_acceptance_rate": round(
                st.get("spec_acceptance_rate", 0.0), 4),
            # accepted draft tokens per emitted token: 0 when off, toward
            # 1 as every emission comes from an accepted draft
            "accepted_per_emitted": round(
                st.get("spec_accepted_total", 0) / max(tokens, 1), 4),
        }
        if st.get("spec_tree"):
            out["tree_nodes_per_verify"] = round(
                st["spec_tree_nodes_total"]
                / max(st["spec_tree_verify_steps"], 1), 3)
            out["tree_mean_path_len"] = round(
                st["spec_tree_mean_path_len"], 4)
            # accepted nodes by branch ordinal (0 = the spine)
            out["branch_accept_hist"] = st["spec_branch_accept_hist"]
            out["gated_despecs"] = st["spec_gated_despec_total"]
        return out

    if "tree-vs-linear" in modes:
        res = {m: asyncio.run(run_mode(m)) for m in ("off", "ngram", "tree")}
        lin, tr = res["ngram"], res["tree"]
        return list(res.values()) + [{
            "mode": "tree-vs-linear",
            "linear_dispatches_per_token": lin["dispatches_per_token"],
            "tree_dispatches_per_token": tr["dispatches_per_token"],
            "linear_accepted_per_emitted": lin["accepted_per_emitted"],
            "tree_accepted_per_emitted": tr["accepted_per_emitted"],
            "tree_mean_path_len": tr.get("tree_mean_path_len", 0.0),
            "branch_accept_hist": tr.get("branch_accept_hist", []),
        }]
    return [asyncio.run(run_mode(m)) for m in modes]


def _replay_ms(fn, device: torch.device, reps: int
               ) -> tuple[Optional[float], Optional[int]]:
    """(device ms of one call of ``fn`` captured as a CUDA graph over
    ``reps`` replays after two, the dense attention kernel's executions
    over those ``reps``); on the CPU ``fn`` runs once and (None, None)
    comes back: no device time."""
    from dynamo_tpu_torch.engine.graphs import no_collection
    from dynamo_tpu_torch.ops import flash_decode as fd

    if device.type != "cuda":
        fn()
        return None, None
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()   # lazy initialisation stays out of the capture
    main.wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(g):
        fn()
    for _ in range(2):
        g.replay()
    fd.executed(device, reset=True)   # synchronises
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps, fd.executed(device)[0]


def round_timing(model_config: str = "llama3_1b", device: str = "cuda",
                 reps: int = 20) -> list[dict]:
    """The default mode (see the module docstring): one dict a variant.
    ``model_config`` tiny (f32) runs the same control flow at a small
    width."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.graphs import (
        flush_round,
        round_steps,
        run_round,
    )
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.roofline import chip_info

    f32 = model_config == "tiny"
    cfg = (ModelConfig.tiny(dtype="float32") if f32
           else getattr(ModelConfig, model_config)())
    page = 64
    ecfg = EngineConfig(max_decode_slots=B, page_size=page,
                        max_pages_per_seq=S // page, flush_every=N,
                        cache_dtype="float32" if f32 else "bfloat16")
    eng = TorchEngine(cfg, ecfg, device=device)
    dev, out = eng._dev, eng.graphs.out
    lanes = torch.arange(B, dtype=dev["dest"].dtype, device=eng.device)
    dev["dest"].copy_(lanes)
    dev["tokens"].fill_(1)
    ctx0 = torch.full_like(dev["ctx"], CTX)
    base0 = ctx0 - 1

    def rnd(flush):
        def fn():
            dev["ctx"].copy_(ctx0)
            if flush:
                run_round(cfg, ecfg, eng.params, eng.ctx, eng.ring,
                          eng.cache, dev, out, False, False)
            else:
                round_steps(cfg, ecfg, eng.params, eng.ctx, eng.ring, dev,
                            out, False, False)
        return fn

    def flush_only():
        flush_round(ecfg, eng.ctx, eng.ring, dev, base0)

    splits = (fd.context_splits(eng.ring["k"].dtype, B, cfg.num_kv_heads,
                                S, cfg.head_dim, False, eng.device)
              if eng.device.type == "cuda" else None)
    # the flush's own bytes: each lane's ring rows read, the same rows
    # written into its ctx lane (K and V, every layer)
    flush_bytes = (2 * cfg.num_layers * cfg.num_kv_heads * B * N
                   * cfg.head_dim * eng.ring["k"].element_size() * 2)
    _, peak, _ = chip_info(eng.device)
    rows = []
    with torch.no_grad():
        for variant, fn in (("round +flush", rnd(True)),
                            ("round no flush", rnd(False)),
                            ("flush only", flush_only)):
            ms, execs = _replay_ms(fn, eng.device, reps)
            step_ms = ms / N if ms is not None else None
            # each step reads the ctx rows below the round's ring base
            acct = _byte_accounting(eng, CTX - 1,
                                    1e3 / step_ms if step_ms else None)
            if variant == "flush only":
                acct["attn_roofline_frac"] = (
                    flush_bytes / (ms * 1e-3) / peak[1]
                    if ms and peak else None)
            rows.append({
                "mode": "round", "variant": variant,
                "model_config": model_config, "device": str(eng.device),
                "slots": B, "max_context": S, "flush_every": N, "ctx": CTX,
                "context_splits": splits,
                "ms_per_round": ms, "ms_per_step": step_ms,
                "kernel_executions": execs,
                "flush_bytes_per_round": flush_bytes,
                **{k: acct[k] for k in BYTE_FIELDS},
            })
    return rows


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--spec", default=None, nargs="?", const="all",
                    choices=SPEC_ALL + ["tree-vs-linear", "all"],
                    help="dispatch-count mode instead of kernel timing")
    ap.add_argument("--dispatch-budget", action="store_true",
                    help="the plain round's dispatch budget, host ms a "
                         "step and bytes a step, as one JSON line")
    ap.add_argument("--model-config", default=None,
                    choices=["tiny", "llama3_1b", "llama3_8b"],
                    help="default: tiny for --dispatch-budget, llama3_1b "
                         "for the timing mode")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the card")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="KV quantization for --dispatch-budget")
    ap.add_argument("--round-pipeline", default="on", choices=["on", "off"],
                    help="round pipelining for --dispatch-budget")
    ap.add_argument("--baseline", default=None, metavar="JSON",
                    help="a prior --dispatch-budget output; adds the "
                         "deltas against it")
    ap.add_argument("--requests", type=int, default=4,
                    help="concurrent requests (= speculating slots)")
    ap.add_argument("--osl", type=int, default=32,
                    help="output tokens a request in --spec and "
                         "--dispatch-budget")
    args = ap.parse_args(argv)
    device = args.device or "cuda"
    if args.dispatch_budget:
        lines = [dispatch_budget(
            args.model_config or "tiny", device, args.requests, args.osl,
            args.kv_quant, args.round_pipeline == "on", args.baseline)]
    elif args.spec:
        if args.model_config not in (None, "tiny"):
            ap.error("--spec runs ModelConfig.tiny")
        modes = SPEC_ALL if args.spec == "all" else [args.spec]
        lines = spec_dispatch(modes, args.requests, args.osl, device)
    else:
        lines = round_timing(args.model_config or "llama3_1b", device)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
