"""Resilience plane of the port (a copy of the JAX package's resilience/):

  policy.py     RetryPolicy (jittered exponential backoff) and the
                CircuitBreaker state machine (CLOSED -> OPEN -> HALF_OPEN)
  health.py     WorkerHealthTracker: one breaker per worker, heartbeats
                off the load-metrics stream with an optional TTL, and the
                remote blocks of the shared breaker board
  migration.py  mid-stream request migration: rebuild a dead worker's
                stream as prompt + emitted tokens and replay it as a
                prefill on a healthy worker
  drain.py      graceful drain: stop admitting, finish in-flight, exit
                (/drain on the system server, SIGTERM on the worker)
  chaos.py      fault-injection points armed through the environment, the
                launcher's --chaos or the system server's /chaos
  shared.py     SharedBreakerBoard: breaker trips and closes published on
                the store's pub/sub plane to sibling frontends
  metrics.py    dynamo_migration_* / dynamo_resilience_* counters
"""
from dynamo_tpu_torch.resilience.chaos import CHAOS, ChaosHooks, ChaosPoint
from dynamo_tpu_torch.resilience.drain import (
    DrainController,
    WorkerDrainingError,
)
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
from dynamo_tpu_torch.resilience.shared import SharedBreakerBoard

__all__ = [
    "BreakerState",
    "CHAOS",
    "ChaosHooks",
    "ChaosPoint",
    "CircuitBreaker",
    "DrainController",
    "MigrationPolicy",
    "RESILIENCE",
    "RetryPolicy",
    "SharedBreakerBoard",
    "WorkerDrainingError",
    "WorkerHealthTracker",
    "build_replay_request",
]
