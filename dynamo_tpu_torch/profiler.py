"""Pre-deployment SLA profiler: sweep serving configs, measure TTFT/ITL
(the port's copy of the JAX package's profiler.py).

Parity: reference benchmarks/profiler/profile_sla.py — before deploying,
sweep engine parallelism/config against genai-perf load to find the
cheapest config meeting TTFT/ITL SLAs, emitting interpolation tables the
SLA planner consumes (docs/architecture/load_planner.md:40-60). Here the
load generator is built in (no genai-perf): for each config and each
concurrency level it drives the engine with synthetic prompts and records
TTFT p50/p99, ITL p50/p99, and throughput.

Output (JSON): {"configs": [{"name", "config", "points": [{"concurrency",
"ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s", "tok_s"}]}]}
The SLA planner (planner.py SlaCapacity) reads this to answer "how many
concurrent streams can one replica hold within SLA?".
"""
from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    StopConditions,
)


def _pct(vals: list[float], q: float) -> Optional[float]:
    if not vals:
        return None
    import numpy as np

    return float(np.percentile(vals, q * 100.0))


@dataclass
class ProfilePoint:
    concurrency: int
    ttft_p50_s: float
    ttft_p99_s: float
    itl_p50_s: float
    itl_p99_s: float
    tok_s: float

    def to_dict(self) -> dict[str, Any]:
        return {
            "concurrency": self.concurrency,
            "ttft_p50_s": round(self.ttft_p50_s, 5),
            "ttft_p99_s": round(self.ttft_p99_s, 5),
            "itl_p50_s": round(self.itl_p50_s, 5),
            "itl_p99_s": round(self.itl_p99_s, 5),
            "tok_s": round(self.tok_s, 2),
        }


async def measure_point(
    engine: Any,
    *,
    concurrency: int,
    isl: int,
    osl: int,
    rounds: int = 2,
    vocab: int = 250,
) -> ProfilePoint:
    """Drive `concurrency` simultaneous streams through the engine and
    measure TTFT/ITL/throughput over `rounds` waves. An output that
    carries k tokens after the first (TorchEngine emits a round's
    ``flush_every`` tokens at once) counts k gaps of its wait over k: the
    reference counts them as k - 1 gaps of 0, which reads an ITL p50 of 0
    off an engine that emits four tokens a round."""
    import numpy as np

    rng = np.random.RandomState(7)
    ttfts: list[float] = []
    itls: list[float] = []
    total_tokens = 0
    t_start = time.monotonic()

    async def one() -> None:
        nonlocal total_tokens
        req = PreprocessedRequest(
            token_ids=rng.randint(1, vocab, size=isl).tolist(),
            stop_conditions=StopConditions(max_tokens=osl, ignore_eos=True),
        )
        t0 = time.monotonic()
        prev = None
        async for out in engine.generate(req):
            now = time.monotonic()
            n = len(out.token_ids)
            if n and prev is None:
                ttfts.append(now - t0)
                itls.extend([0.0] * (n - 1))
            elif n:
                itls.extend([(now - prev) / n] * n)
            if n:
                prev = now
            total_tokens += n

    for _ in range(rounds):
        await asyncio.gather(*[one() for _ in range(concurrency)])
    wall = time.monotonic() - t_start
    ttfts.sort()
    itls.sort()
    return ProfilePoint(
        concurrency=concurrency,
        ttft_p50_s=_pct(ttfts, 0.5) or 0.0,
        ttft_p99_s=_pct(ttfts, 0.99) or 0.0,
        itl_p50_s=_pct(itls, 0.5) or 0.0,
        itl_p99_s=_pct(itls, 0.99) or 0.0,
        tok_s=total_tokens / wall if wall else 0.0,
    )


async def profile_engine(
    make_engine: Callable[[dict], Any],
    configs: list[dict],
    *,
    concurrencies: tuple[int, ...] = (1, 2, 4, 8),
    isl: int = 64,
    osl: int = 32,
    rounds: int = 2,
) -> dict[str, Any]:
    """Sweep configs × concurrency levels; returns the profile table."""
    out: list[dict[str, Any]] = []
    for cfg in configs:
        engine = make_engine(cfg)
        start = getattr(engine, "start", None)
        if start:
            start()
        points = []
        try:
            # warmup at the HIGHEST measured concurrency: compiles are per
            # (bucket, width) shape, and the widest shapes only appear at
            # full batch — a narrow warmup would leave compile stalls
            # inside the measured latencies
            await measure_point(engine, concurrency=max(concurrencies),
                                isl=isl, osl=4, rounds=1)
            for c in concurrencies:
                pt = await measure_point(
                    engine, concurrency=c, isl=isl, osl=osl, rounds=rounds
                )
                points.append(pt.to_dict())
        finally:
            stop = getattr(engine, "stop", None)
            if stop:
                res = stop()
                if asyncio.iscoroutine(res):
                    await res
        out.append({
            "name": cfg.get("name", "config"),
            "config": {k: v for k, v in cfg.items() if k != "name"},
            "points": points,
        })
    return {"isl": isl, "osl": osl, "configs": out}


@dataclass
class SlaCapacity:
    """Answers 'how many concurrent streams fit one replica within SLA?'
    from a profile table (the planner-side consumer,
    reference utils/perf_interpolation.py)."""

    profile: dict[str, Any]
    ttft_sla_s: Optional[float] = None
    itl_sla_s: Optional[float] = None
    config_name: Optional[str] = None
    percentile: str = "p50"  # p50 | p99

    def _config_points(self) -> list[list[dict[str, Any]]]:
        """Per-config point lists (each sorted by concurrency). Each config
        is its own latency curve — merging them would let one bad config
        poison another's capacity."""
        cfgs = self.profile.get("configs", [])
        if self.config_name is not None:
            cfgs = [c for c in cfgs if c.get("name") == self.config_name]
        return [
            sorted(c.get("points", []), key=lambda p: p["concurrency"])
            for c in cfgs if c.get("points")
        ]

    def interpolate(
        self, concurrency: float, pts: Optional[list[dict[str, Any]]] = None
    ) -> tuple[Optional[float], Optional[float]]:
        """(ttft, itl) at a concurrency level, piecewise-linear between
        profiled points (reference utils/perf_interpolation.py: the SLA
        planner reads the profiled latency SURFACE, not just the grid).
        Clamps outside the profiled range to the nearest endpoint. With
        several configs selected, reads the FIRST config's curve unless
        `pts` picks one."""
        if pts is None:
            groups = self._config_points()
            pts = groups[0] if groups else []
        if not pts:
            return None, None

        def interp(key: str) -> Optional[float]:
            xs = [p["concurrency"] for p in pts if p.get(key) is not None]
            ys = [p[key] for p in pts if p.get(key) is not None]
            if not xs:
                return None
            if concurrency <= xs[0]:
                return ys[0]
            if concurrency >= xs[-1]:
                return ys[-1]
            for (x0, y0), (x1, y1) in zip(zip(xs, ys), zip(xs[1:], ys[1:])):
                if x0 <= concurrency <= x1:
                    if x1 == x0:
                        return max(y0, y1)
                    t = (concurrency - x0) / (x1 - x0)
                    return y0 + t * (y1 - y0)
            return ys[-1]

        return (interp(f"ttft_{self.percentile}_s"),
                interp(f"itl_{self.percentile}_s"))

    def _point_ok(self, pt: dict[str, Any]) -> bool:
        ttft = pt.get(f"ttft_{self.percentile}_s")
        itl = pt.get(f"itl_{self.percentile}_s")
        good = True
        if self.ttft_sla_s is not None:
            # a point MISSING the measurement cannot prove the SLA
            good = good and ttft is not None and ttft <= self.ttft_sla_s
        if self.itl_sla_s is not None:
            good = good and itl is not None and itl <= self.itl_sla_s
        return good

    def max_concurrency(self) -> int:
        """Highest concurrency meeting the SLA (0 if no profiled point
        does). Base semantics: the highest PASSING PROFILED point of any
        selected config (noise at low load never zeroes out capacity a
        higher point proved). Interpolation then refines INTO the segment
        between that point and the next profiled point, finding the SLA
        crossing on the piecewise-linear curve (reference
        utils/perf_interpolation.py reads the surface, not just the grid)."""
        best = 0
        for pts in self._config_points():
            passing = [i for i, p in enumerate(pts) if self._point_ok(p)]
            if not passing:
                continue
            i = passing[-1]
            cap = float(pts[i]["concurrency"])
            if i + 1 < len(pts):
                # refine toward the next (failing) profiled point
                def ok(c: float, pts=pts) -> bool:
                    ttft, itl = self.interpolate(c, pts)
                    good = True
                    if self.ttft_sla_s is not None:
                        good = (good and ttft is not None
                                and ttft <= self.ttft_sla_s)
                    if self.itl_sla_s is not None:
                        good = (good and itl is not None
                                and itl <= self.itl_sla_s)
                    return good

                flo, fhi = cap, float(pts[i + 1]["concurrency"])
                for _ in range(40):
                    mid = (flo + fhi) / 2
                    if ok(mid):
                        flo = mid
                    else:
                        fhi = mid
                cap = flo
            best = max(best, int(cap))
        return best

    def replicas_for(self, concurrent_streams: int,
                     min_replicas: int = 1) -> int:
        cap = self.max_concurrency()
        if cap <= 0:
            return max(min_replicas, 1)
        import math

        return max(min_replicas, math.ceil(concurrent_streams / cap))


def torch_engine_config(cfg: dict, cache_dtype: str = "bfloat16"):
    """The EngineConfig a profiled TorchEngine runs (the reference's for
    its engine: 512 pages of 64 tokens, one 128-token prefill bucket),
    with the config's slot count."""
    from dynamo_tpu_torch.engine.config import EngineConfig

    return EngineConfig(
        num_pages=cfg.get("num_pages", 512),
        page_size=cfg.get("page_size", 64),
        max_decode_slots=cfg.get("max_decode_slots", 8),
        prefill_buckets=(128,),
        cache_dtype=cfg.get("cache_dtype", cache_dtype),
    )


async def run_profile(args) -> None:
    """CLI entry: profile the mocker (CPU) or a TorchEngine with random
    weights of ``--model-config`` on ``--device`` (default cuda: without a
    card it raises, it does not fall back to the CPU)."""
    device = getattr(args, "device", None) or "cuda"
    cache_dtype = getattr(args, "cache_dtype", "bfloat16")
    if args.engine == "torch":
        import torch

        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                "profile --engine torch runs on CUDA unless --device cpu "
                "is passed, and no CUDA device is available")

    def make(cfg: dict):
        if args.engine == "mocker":
            from dynamo_tpu_torch.mocker import MockerArgs, MockerEngine

            return MockerEngine(MockerArgs(
                speedup_ratio=cfg.get("speedup_ratio", 1.0),
                max_decode_slots=cfg.get("max_decode_slots", 8),
                page_size=cfg.get("page_size", 16),
                num_pages=cfg.get("num_pages", 512),
            ))
        from dynamo_tpu_torch.engine.engine import TorchEngine
        from dynamo_tpu_torch.models.config import ModelConfig

        ecfg = torch_engine_config(cfg, cache_dtype)
        mc = getattr(ModelConfig, args.model_config)(dtype=ecfg.cache_dtype)
        return TorchEngine(mc, ecfg, device=device)

    configs = [
        {"name": f"slots{s}", "max_decode_slots": s}
        for s in args.slots
    ]
    table = await profile_engine(
        make, configs,
        concurrencies=tuple(args.concurrency),
        isl=args.isl, osl=args.osl,
    )
    with open(args.output, "w") as f:
        json.dump(table, f, indent=1)
    print(f"profile written to {args.output} "
          f"({len(configs)} configs x {len(args.concurrency)} points)",
          flush=True)
