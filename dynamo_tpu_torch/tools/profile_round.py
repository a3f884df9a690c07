"""The plain decode path's dispatch budget and host attribution (the
``--dispatch-budget`` mode of the JAX package's tools/profile_round.py).

    python -m dynamo_tpu_torch.tools.profile_round --dispatch-budget \
        [--model-config tiny|llama3_8b] [--device cpu|cuda] \
        [--kv-quant none|int8] [--round-pipeline on|off] \
        [--requests N] [--osl N] [--baseline prior.json]

Runs TorchEngine through a steady decode workload (``--requests`` prompts
of 48 tokens from seed 0, ``--osl`` new tokens each, after a warm-up of 8)
and prints one JSON line: the engine's dispatch counts over the window
and their number a decode round, the wall ms a step, the device ms a step
of the engine's round replayed alone (CUDA events on the card, the host
clock on the CPU), the host ms a step (wall - device), the host time a
step by attribution segment (``host_breakdown``, telemetry/prof.py) with
its coverage, and the round-pipelining view. ``--baseline`` adds the
deltas against a prior run's JSON. ``--model-config tiny`` (f32) runs
on the CPU in seconds; ``llama3_8b`` (random bf16 weights from seed 0)
is the card's configuration. The device is the card unless ``--device
cpu`` is given.

Left for later: the XLA-program timings and the ``--spec`` dispatch modes
of the JAX package's tool.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import Optional

import numpy as np
import torch


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
    }
    if baseline:
        # negative: this run is cheaper than the baseline
        with open(baseline) as f:
            base = json.load(f)
        base_bd = base.get("host_breakdown") or {}
        out["baseline_deltas"] = {
            "host_ms_per_step": round(
                out["host_ms_per_step"] - base.get("host_ms_per_step", 0.0),
                4),
            "device_ms_per_step": round(
                device_ms - base.get("device_ms_per_step", 0.0), 4),
            "host_breakdown": {s: round(v - base_bd.get(s, 0.0), 5)
                               for s, v in host_breakdown.items()},
        }
    return out


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dispatch-budget", action="store_true",
                    help="the plain round's dispatch budget and host "
                         "ms a step, as one JSON line")
    ap.add_argument("--model-config", default="tiny",
                    choices=["tiny", "llama3_8b"])
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="default: the card")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"])
    ap.add_argument("--round-pipeline", default="on", choices=["on", "off"])
    ap.add_argument("--baseline", default=None, metavar="JSON",
                    help="a prior --dispatch-budget output; adds the "
                         "deltas against it")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--osl", type=int, default=32)
    args = ap.parse_args(argv)
    if not args.dispatch_budget:
        ap.error("only --dispatch-budget is served")
    print(json.dumps(dispatch_budget(
        args.model_config, args.device or "cuda", args.requests, args.osl,
        args.kv_quant, args.round_pipeline == "on", args.baseline)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
