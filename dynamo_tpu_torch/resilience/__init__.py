"""Resilience plane of the port (a copy of the JAX package's resilience/,
cut to what the KV router and the runtime's reconnect loops use):

  policy.py     RetryPolicy (jittered exponential backoff) and the
                CircuitBreaker state machine (CLOSED -> OPEN -> HALF_OPEN)
  health.py     WorkerHealthTracker: one breaker per worker, heartbeats
                off the load-metrics stream
  migration.py  mid-stream request migration: rebuild a dead worker's
                stream as prompt + emitted tokens and replay it as a
                prefill on a healthy worker
  metrics.py    dynamo_migration_* / dynamo_resilience_* counters

Graceful drain, chaos hooks, heartbeat TTLs and shared breakers come with
ROADMAP Queue 1 item 5.
"""
from dynamo_tpu_torch.resilience.health import WorkerHealthTracker
from dynamo_tpu_torch.resilience.metrics import RESILIENCE
from dynamo_tpu_torch.resilience.migration import (
    MigrationPolicy,
    build_replay_request,
)
from dynamo_tpu_torch.resilience.policy import (
    BreakerState,
    CircuitBreaker,
    RetryPolicy,
)

__all__ = [
    "BreakerState",
    "CircuitBreaker",
    "MigrationPolicy",
    "RESILIENCE",
    "RetryPolicy",
    "WorkerHealthTracker",
    "build_replay_request",
]
