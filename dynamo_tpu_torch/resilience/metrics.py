"""Resilience counters: one process-wide registry (a copy of the JAX
package's resilience/metrics.py, cut to the families the router, the
health tracker and the retry policy increment; drain and chaos bring
theirs with ROADMAP Queue 1 item 5).

The frontend's ``/metrics`` appends ``render()``'s Prometheus text, so
the series exist there, zero-valued until their event happens.
"""
from __future__ import annotations

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

# (name, type, help) — the JAX package's family names and help texts.
# Counters follow the Prometheus naming contract (`*_total`); gauges are
# plain names.
FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_migration_total", "counter",
     "mid-stream request migrations completed (stream resumed on a new worker)"),
    ("dynamo_migration_failed_total", "counter",
     "mid-stream migrations that found no healthy worker or failed replay"),
    ("dynamo_migration_replayed_tokens_total", "counter",
     "emitted tokens replayed as prefill context during migrations"),
    ("dynamo_resilience_reroute_total", "counter",
     "pre-first-token re-routes after an unreachable worker"),
    ("dynamo_resilience_breaker_trips_total", "counter",
     "circuit breakers tripped open (consecutive-failure threshold hit)"),
    ("dynamo_resilience_breaker_open", "gauge",
     "workers currently tripped out of routing (breaker OPEN or HALF_OPEN)"),
    ("dynamo_resilience_retries_total", "counter",
     "retry attempts made under a RetryPolicy (backoff sleeps taken)"),
)

# process-wide registry: routers, health trackers and retry policies in
# one process share it
RESILIENCE = CounterRegistry(FAMILIES, label="resilience")
