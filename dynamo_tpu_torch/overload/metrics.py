"""Overload-protection counters (a copy of the JAX package's
overload/metrics.py): one process-wide registry, two scrape surfaces.

Admission rejections, deadline sheds, priority preemptions, frontend
429s and router spills all increment here; the frontend's ``/metrics``
and the per-worker system server append ``render()``'s Prometheus text,
so the series exist on both surfaces.
"""
from __future__ import annotations

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

# (name, type, help) — the fixed family set.
FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_overload_rejected_total", "counter",
     "requests refused admission at the engine queue budget (retriable)"),
    ("dynamo_overload_shed_total", "counter",
     "still-waiting requests dropped because their deadline expired"),
    ("dynamo_overload_preempted_total", "counter",
     "waiting entries evicted by a higher-priority arrival (retriable)"),
    ("dynamo_overload_preempt_migrations_total", "counter",
     "running low-priority streams force-migrated to free a lane"),
    ("dynamo_overload_http_429_total", "counter",
     "frontend responses rejected with HTTP 429 + Retry-After"),
    ("dynamo_overload_router_spills_total", "counter",
     "requests bounced off an overloaded worker and re-routed to a peer"),
    ("dynamo_overload_queue_depth", "gauge",
     "requests waiting for admission at this process's engine"),
    ("dynamo_overload_queue_tokens", "gauge",
     "prompt tokens waiting for prefill at this process's engine"),
)

# process-wide registry: engines, the router and the frontend in one
# process share it (parity with resilience.RESILIENCE)
OVERLOAD = CounterRegistry(FAMILIES, label="overload")
