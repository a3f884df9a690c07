"""Resilience counters: one process-wide registry (a copy of the JAX
package's resilience/metrics.py, with all of its families).

The frontend's ``/metrics`` and each worker's system server append
``render()``'s Prometheus text, so the series exist on both surfaces,
zero-valued until their event happens.
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
    ("dynamo_resilience_chaos_injections_total", "counter",
     "chaos faults injected by armed injection points"),
    ("dynamo_resilience_draining", "gauge",
     "1 while this process is draining (stop admitting, finish in-flight)"),
    ("dynamo_resilience_drains_total", "counter",
     "graceful drains completed by this process"),
)

# process-wide registry: routers, health trackers, retry policies, the
# drain controller and the chaos hooks in one process share it
RESILIENCE = CounterRegistry(FAMILIES, label="resilience")
