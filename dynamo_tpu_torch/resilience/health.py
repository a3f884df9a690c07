"""Worker health plane: one circuit breaker per worker, and the last
heartbeat of each off the load-metrics stream (a copy of the JAX
package's resilience/health.py).

The distributed runtime already has hard liveness (registration keys die
with the worker's store lease). This tracker adds the SOFT layer routers
need *between* lease expiries: per-worker breakers trip a worker out of
routing after consecutive request failures — a worker can be lease-alive
yet unable to serve (wedged device, stalled streams), and waiting for the
lease to expire would feed it traffic the whole time.

With ``heartbeat_ttl_s`` (the launcher's ``--health-heartbeat-ttl``) a
worker whose metrics went silent longer than the TTL is blocked before its
lease expires. ``note_remote_open``, ``clear_remote_open`` and
``on_state_change`` are the hooks of the shared breaker board
(resilience/shared.py), through which sibling frontends exchange trips.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Optional

from dynamo_tpu_torch.resilience.metrics import RESILIENCE
from dynamo_tpu_torch.resilience.policy import BreakerState, CircuitBreaker

log = logging.getLogger(__name__)


class WorkerHealthTracker:
    """Per-worker breaker + last-heartbeat table.

    ``heartbeat_ttl_s`` only applies to workers that have heartbeated at
    least once: a fleet without a wired metrics stream (unit tests,
    embedded local engines) stays routable on breaker state alone.
    """

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        reset_timeout_s: float = 5.0,
        heartbeat_ttl_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.heartbeat_ttl_s = heartbeat_ttl_s
        self.clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}
        self._last_seen: dict[str, float] = {}
        # trips observed by SIBLING frontends block routing here until
        # their window ends; local trips and closes fire the hook so a
        # board can publish them. Remote state never feeds the local
        # breaker's failure counts (another frontend's view of a worker
        # is not this frontend's evidence)
        self._remote_open: dict[str, float] = {}   # wid -> blocked until
        self.on_state_change: Optional[
            Callable[[str, str, float], None]
        ] = None    # (worker_id, "open"|"closed", window_s)
        # control-plane degraded mode (StoreSession listener): while
        # frozen, heartbeat staleness never blocks — the metrics stream
        # rides the store, so its silence says nothing about worker
        # health (stale-while-revalidate)
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

    def stale(self, worker_id: str) -> bool:
        if self.heartbeat_ttl_s is None or self._frozen_at is not None:
            return False
        seen = self._last_seen.get(worker_id)
        if seen is None:
            return False  # never heartbeated: no signal, not stale
        return self.clock() - seen > self.heartbeat_ttl_s

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
        now = self.clock()
        for wid in worker_ids:
            if self.stale(wid):
                out.add(wid)
                continue
            until = self._remote_open.get(wid)
            if until is not None:
                if until > now:
                    out.add(wid)
                    continue
                del self._remote_open[wid]   # window over: probe freely
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
            was_open = b.state is not BreakerState.CLOSED
            b.record_success()
            if was_open and b.state is BreakerState.CLOSED:
                # the probe succeeded: lift any remote block too and tell
                # sibling frontends the worker recovered
                self._remote_open.pop(worker_id, None)
                self._fire(worker_id, "closed", 0.0)
            self._export_open_gauge()

    def record_failure(self, worker_id: str) -> None:
        b = self.breaker(worker_id)
        trips_before = b.trips
        b.record_failure()
        if b.trips > trips_before:
            self._fire(worker_id, "open", self.reset_timeout_s)
        self._export_open_gauge()

    # ---- cross-frontend sharing (resilience/shared.py) ----

    def note_remote_open(self, worker_id: str, window_s: float) -> None:
        """A sibling frontend's breaker tripped for this worker: block
        routing here for the rest of its reset window."""
        if window_s <= 0:
            return
        self._remote_open[worker_id] = self.clock() + window_s
        self._export_open_gauge()

    def clear_remote_open(self, worker_id: str) -> None:
        self._remote_open.pop(worker_id, None)

    def _fire(self, worker_id: str, state: str, window_s: float) -> None:
        if self.on_state_change is None:
            return
        try:
            self.on_state_change(worker_id, state, window_s)
        except Exception:  # noqa: BLE001 — publishing is best-effort
            log.warning("breaker state-change publish failed for %s",
                        worker_id, exc_info=True)

    def forget(self, worker_id: str) -> None:
        """Worker left the fleet: drop its breaker, heartbeat and remote
        block."""
        self._breakers.pop(worker_id, None)
        self._last_seen.pop(worker_id, None)
        self._remote_open.pop(worker_id, None)
        self._export_open_gauge()

    def states(self) -> dict[str, str]:
        return {w: b.state.value for w, b in self._breakers.items()}

    def _export_open_gauge(self) -> None:
        RESILIENCE.set(
            "dynamo_resilience_breaker_open",
            sum(1 for b in self._breakers.values()
                if b.state is not BreakerState.CLOSED),
        )
