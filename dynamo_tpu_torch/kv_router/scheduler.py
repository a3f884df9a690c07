"""Worker selection: cost function + softmax-temperature sampling (the
port's copy of the JAX package's kv_router/scheduler.py).

Parity: reference kv_router/scheduler.rs — DefaultWorkerSelector (:348)
computes per-worker ``logit = overlap_score_weight * prefill_blocks +
potential_active_blocks`` (lower is better), min-max normalizes, negates,
and softmax-samples at ``router_temperature`` (:276-344). Temperature 0 is
argmin with random tie-break. Emits KVHitRateEvent per decision (:37).

The draws from the random source are the JAX package's, one for one (one
``choice`` at temperature 0, one ``random()`` otherwise), so two routers
seeded alike make the same decisions.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.kv_router.indexer import OverlapScores, WorkerId


@dataclass
class KvRouterConfig:
    """reference kv_router.rs:61-78 defaults."""

    overlap_score_weight: float = 1.0
    router_temperature: float = 0.5
    # access-heat EWMA decay half-life for the indexer's per-block
    # frequency counters (None = raw counters, no decay) — the hot-set
    # ranking the fleet prefix economy (kv_router/fleet.py) builds on
    freq_halflife_s: Optional[float] = 600.0


@dataclass
class KVHitRateEvent:
    """Routing-decision telemetry (scheduler.rs:37)."""

    worker_id: WorkerId
    isl_blocks: int       # prompt length in blocks
    overlap_blocks: int   # blocks already cached on the chosen worker


@dataclass
class SchedulingRequest:
    """What the selector sees for one request (scheduler.rs SchedulingRequest)."""

    isl_tokens: int
    overlap: OverlapScores
    # worker -> blocks it would hold if this request were scheduled there
    potential_blocks: dict[WorkerId, int] = field(default_factory=dict)


class NoEndpoints(RuntimeError):
    pass


def softmax_sample(
    logits: dict[WorkerId, float],
    temperature: float,
    rng: Optional[random.Random] = None,
) -> WorkerId:
    """Sample a worker; LOWER logit = better (scheduler.rs:276-344)."""
    if not logits:
        raise NoEndpoints("empty logits for softmax sampling")
    rng = rng or random
    keys = list(logits)
    vals = [logits[k] for k in keys]
    if temperature == 0.0:
        lo = min(vals)
        best = [k for k, v in zip(keys, vals) if v == lo]
        return rng.choice(best)
    lo, hi = min(vals), max(vals)
    if lo == hi:
        probs = [1.0 / len(keys)] * len(keys)
    else:
        scaled = [-(v / (hi - lo)) / temperature for v in vals]
        m = max(scaled)
        exps = [math.exp(s - m) for s in scaled]
        z = sum(exps)
        probs = [e / z for e in exps]
    x = rng.random()
    acc = 0.0
    for k, p in zip(keys, probs):
        acc += p
        if x <= acc:
            return k
    return keys[-1]


class DefaultWorkerSelector:
    """The reference's default cost function (scheduler.rs:348,390-392)."""

    def __init__(self, config: Optional[KvRouterConfig] = None,
                 rng: Optional[random.Random] = None):
        self.config = config or KvRouterConfig()
        self.rng = rng

    def select_worker(
        self,
        worker_ids: list[WorkerId],
        request: SchedulingRequest,
        block_size: int,
    ) -> tuple[WorkerId, int]:
        """Returns (worker_id, overlap_blocks on that worker)."""
        if not worker_ids:
            raise NoEndpoints("no workers registered")
        assert request.isl_tokens > 0
        request_blocks = -(-request.isl_tokens // block_size)  # ceil div
        logits: dict[WorkerId, float] = {}
        for w in worker_ids:
            cached = float(request.overlap.scores.get(w, 0))
            prefill_blocks = request_blocks - cached
            potential = float(request.potential_blocks.get(w, 0))
            logits[w] = (
                self.config.overlap_score_weight * prefill_blocks + potential
            )
        best = softmax_sample(
            logits, self.config.router_temperature, self.rng
        )
        return best, request.overlap.scores.get(best, 0)


class KvScheduler:
    """Binds selector + per-decision telemetry (scheduler.rs KvScheduler:100)."""

    def __init__(
        self,
        block_size: int,
        selector: Optional[DefaultWorkerSelector] = None,
        on_hit_rate: Optional[Callable[[KVHitRateEvent], None]] = None,
    ):
        self.block_size = block_size
        self.selector = selector or DefaultWorkerSelector()
        self.on_hit_rate = on_hit_rate

    def schedule(
        self, worker_ids: list[WorkerId], request: SchedulingRequest
    ) -> tuple[WorkerId, int]:
        worker, overlap = self.selector.select_worker(
            worker_ids, request, self.block_size
        )
        if self.on_hit_rate is not None:
            self.on_hit_rate(
                KVHitRateEvent(
                    worker_id=worker,
                    isl_blocks=-(-request.isl_tokens // self.block_size),
                    overlap_blocks=overlap,
                )
            )
        return worker, overlap
