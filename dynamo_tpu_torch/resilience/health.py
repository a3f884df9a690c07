"""Worker health plane: one circuit breaker per worker, and the last
heartbeat of each off the load-metrics stream (a copy of the JAX
package's resilience/health.py).

The distributed runtime already has hard liveness (registration keys die
with the worker's store lease). This tracker adds the SOFT layer routers
need *between* lease expiries: per-worker breakers trip a worker out of
routing after consecutive request failures — a worker can be lease-alive
yet unable to serve (wedged device, stalled streams), and waiting for the
lease to expire would feed it traffic the whole time.

Left out until ROADMAP Queue 1 item 5 (resilience): the heartbeat TTL
that blocks a worker whose metrics went silent (``--health-heartbeat-ttl``;
the heartbeats are recorded, nothing reads them for staleness yet), and
the shared-breaker hooks (``note_remote_open``, ``clear_remote_open``,
``on_state_change``) that let sibling frontends exchange trips.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Optional

from dynamo_tpu_torch.resilience.metrics import RESILIENCE
from dynamo_tpu_torch.resilience.policy import BreakerState, CircuitBreaker

log = logging.getLogger(__name__)


class WorkerHealthTracker:
    """Per-worker breaker + last-heartbeat table."""

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        reset_timeout_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}
        self._last_seen: dict[str, float] = {}
        # control-plane degraded mode (StoreSession listener): while
        # frozen, the metrics stream's silence says nothing about worker
        # health — it rides the store (stale-while-revalidate)
        self._frozen_at: Optional[float] = None

    def breaker(self, worker_id: str) -> CircuitBreaker:
        b = self._breakers.get(worker_id)
        if b is None:
            b = self._breakers[worker_id] = CircuitBreaker(
                self.failure_threshold, self.reset_timeout_s, self.clock
            )
        return b

    # ---- heartbeats (fed by the load-metrics stream) ----

    def heartbeat(self, worker_id: str) -> None:
        self._last_seen[worker_id] = self.clock()

    def observe_metrics(self, m) -> None:
        """Feed one ForwardPassMetrics publication (watcher tap)."""
        wid = getattr(m, "worker_id", "") or ""
        if wid:
            self.heartbeat(wid)

    # ---- control-plane degraded mode ----

    def freeze(self) -> None:
        """Store unreachable: hold the last-known picture. Breakers keep
        working off live request outcomes."""
        if self._frozen_at is None:
            self._frozen_at = self.clock()
            log.warning("health view frozen (control plane degraded)")

    def thaw(self) -> None:
        """Store back: every known worker's heartbeat restarts from now,
        so the outage's silence never counts against it."""
        if self._frozen_at is None:
            return
        now = self.clock()
        for wid in self._last_seen:
            self._last_seen[wid] = now
        self._frozen_at = None
        log.info("health view thawed (control plane resynced)")

    # ---- routing decisions ----

    def blocked(self, worker_ids: Iterable[str]) -> set[str]:
        """Workers that must NOT receive traffic right now. Side-effect
        free (peek_allow): the half-open probe grant is consumed only by
        ``on_routed`` for the worker actually dispatched to — consuming
        it here would starve a recovered worker whenever the scheduler
        picked someone else for that decision."""
        out = set()
        for wid in worker_ids:
            b = self._breakers.get(wid)
            if b is not None and not b.peek_allow():
                out.add(wid)
        self._export_open_gauge()
        return out

    def on_routed(self, worker_id: str) -> None:
        """A request is being dispatched to this worker: if its breaker
        is not CLOSED, this dispatch IS the half-open probe."""
        b = self._breakers.get(worker_id)
        if b is not None and b.state is not BreakerState.CLOSED:
            b.begin_probe()
            self._export_open_gauge()

    def record_success(self, worker_id: str) -> None:
        b = self._breakers.get(worker_id)
        if b is not None:
            b.record_success()
            self._export_open_gauge()

    def record_failure(self, worker_id: str) -> None:
        self.breaker(worker_id).record_failure()
        self._export_open_gauge()

    def forget(self, worker_id: str) -> None:
        """Worker left the fleet: drop its breaker + heartbeat."""
        self._breakers.pop(worker_id, None)
        self._last_seen.pop(worker_id, None)
        self._export_open_gauge()

    def states(self) -> dict[str, str]:
        return {w: b.state.value for w, b in self._breakers.items()}

    def _export_open_gauge(self) -> None:
        RESILIENCE.set(
            "dynamo_resilience_breaker_open",
            sum(1 for b in self._breakers.values()
                if b.state is not BreakerState.CLOSED),
        )
