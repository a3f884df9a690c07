"""Worker load-metrics aggregation for the router/planner plane (the
port's copy of the JAX package's kv_router/metrics_aggregator.py).

Parity: reference kv_router/metrics_aggregator.rs:31 EndpointCollector +
scoring.rs ProcessedEndpoints: collect the latest ForwardPassMetrics per
worker and expose an aggregate snapshot. Transport-agnostic: callers feed
``update()`` from engine callbacks (in-process) or from the runtime's
metrics endpoints (remote).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics


@dataclass
class ProcessedEndpoints:
    """Snapshot of worker load (reference scoring.rs:24)."""

    metrics: dict[str, ForwardPassMetrics] = field(default_factory=dict)

    @property
    def worker_ids(self) -> list[str]:
        return sorted(self.metrics)

    def load_avg(self) -> float:
        if not self.metrics:
            return 0.0
        return sum(
            m.kv_stats.gpu_cache_usage_perc for m in self.metrics.values()
        ) / len(self.metrics)

    def load_std(self) -> float:
        if not self.metrics:
            return 0.0
        mu = self.load_avg()
        var = sum(
            (m.kv_stats.gpu_cache_usage_perc - mu) ** 2
            for m in self.metrics.values()
        ) / len(self.metrics)
        return var ** 0.5


class MetricsAggregator:
    """Latest ForwardPassMetrics per worker, with staleness eviction."""

    def __init__(
        self,
        stale_after_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.stale_after_s = stale_after_s
        # injectable: a simulated fleet must judge staleness in its own
        # time, or a compressed run ages every worker out instantly
        self.clock = clock
        self._latest: dict[str, tuple[float, ForwardPassMetrics]] = {}

    def update(self, metrics: ForwardPassMetrics) -> None:
        self._latest[metrics.worker_id] = (self.clock(), metrics)

    def remove_worker(self, worker_id: str) -> None:
        self._latest.pop(worker_id, None)

    def snapshot(self) -> ProcessedEndpoints:
        now = self.clock()
        out: dict[str, ForwardPassMetrics] = {}
        for w, (t, m) in list(self._latest.items()):
            if self.stale_after_s is not None and now - t > self.stale_after_s:
                del self._latest[w]
                continue
            out[w] = m
        return ProcessedEndpoints(metrics=out)
