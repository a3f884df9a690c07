"""Router-side live load view: the backpressure half of the overload
plane (a copy of the JAX package's overload/load.py).

Every worker publishes queue depth (and, once the overload budgets are
ported, its queue budgets) in ``ForwardPassMetrics``; the frontend's
metrics subscription feeds them here, and ``KvPushRouter`` consults the
view BEFORE dispatch so overload at one worker spills traffic to warm
peers instead of bouncing requests off a full queue one RTT at a time:

  - a worker whose published backlog is at its budget is skipped
    (proactive spill);
  - a worker that just bounced a request with ``EngineOverloadedError``
    is skipped for the bounce's ``retry_after_s`` (reactive cooldown —
    the wire told us exactly how long);
  - a deadline-carrying request skips workers whose estimated queue
    wait (published depth x observed per-request queue wait) cannot
    meet the deadline — routing work to a queue where it will be shed
    is strictly worse than a peer or an immediate 429.

Entries go stale after ``stale_after_s``: a worker that stopped
publishing says nothing about its load (the health plane owns liveness),
so stale load data never blocks routing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from dynamo_tpu_torch.telemetry import metrics as tmetrics
from dynamo_tpu_torch.telemetry.metrics import percentile_from_snapshot

# floor for the per-request queue-wait estimate: a worker that has never
# observed queue wait still takes SOME time per backlog entry
MIN_QUEUE_WAIT_S = 0.01


@dataclass
class _WorkerLoad:
    t: float
    waiting: int
    waiting_tokens: int
    max_waiting: int
    max_waiting_tokens: int
    queue_wait_s: Optional[float]       # observed per-request queue p50
    cooldown_until: float = 0.0         # wire-observed overload bounce


class WorkerLoadView:
    """Last-published load per worker + overload cooldowns."""

    def __init__(
        self,
        stale_after_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.stale_after_s = stale_after_s
        self.clock = clock
        self._load: dict[str, _WorkerLoad] = {}
        # control-plane degraded mode: while frozen, last-published load
        # stays "fresh" — stale-while-revalidate beats forgetting every
        # budget/backlog hint the moment the metrics stream pauses
        self._frozen_at: Optional[float] = None

    # ---- feeds ----

    def observe(self, m) -> None:
        """One ForwardPassMetrics publication (watcher metrics tap)."""
        wid = getattr(m, "worker_id", "") or ""
        if not wid:
            return
        ws = m.worker_stats
        qsnap = (getattr(m, "histograms", None) or {}).get(
            tmetrics.QUEUE[0]
        )
        qwait = percentile_from_snapshot(qsnap, 0.5) if qsnap else None
        prev = self._load.get(wid)
        self._load[wid] = _WorkerLoad(
            t=self.clock(),
            waiting=int(ws.num_requests_waiting),
            waiting_tokens=int(
                getattr(ws, "num_waiting_prefill_tokens", 0)
            ),
            max_waiting=int(getattr(ws, "max_waiting_requests", 0)),
            max_waiting_tokens=int(
                getattr(ws, "max_waiting_prefill_tokens", 0)
            ),
            queue_wait_s=qwait,
            cooldown_until=prev.cooldown_until if prev else 0.0,
        )

    def note_overloaded(self, worker_id: str,
                        retry_after_s: float) -> None:
        """A live bounce (EngineOverloadedError off the wire): skip this
        worker for exactly the window it asked for."""
        until = self.clock() + max(0.0, float(retry_after_s))
        cur = self._load.get(worker_id)
        if cur is None:
            cur = self._load[worker_id] = _WorkerLoad(
                t=self.clock(), waiting=0, waiting_tokens=0,
                max_waiting=0, max_waiting_tokens=0, queue_wait_s=None,
            )
        cur.cooldown_until = max(cur.cooldown_until, until)

    def forget(self, worker_id: str) -> None:
        self._load.pop(worker_id, None)

    # ---- routing decisions ----

    def _fresh(self, wl: _WorkerLoad, now: float) -> bool:
        if self._frozen_at is not None:
            return True
        return now - wl.t <= self.stale_after_s

    # ---- control-plane degraded mode ----

    def freeze(self) -> None:
        """Store unreachable (metrics stream paused): hold the last-known
        load hints instead of aging them out."""
        if self._frozen_at is None:
            self._frozen_at = self.clock()

    def thaw(self) -> None:
        """Store back: restart freshness clocks from now so last-known
        entries get one full stale_after_s to be re-published."""
        if self._frozen_at is None:
            return
        now = self.clock()
        for wl in self._load.values():
            wl.t = now
        self._frozen_at = None

    def saturated(self, worker_id: str) -> bool:
        """Published backlog at budget, or inside a bounce cooldown."""
        wl = self._load.get(worker_id)
        if wl is None:
            return False
        now = self.clock()
        if wl.cooldown_until > now:
            return True
        if not self._fresh(wl, now):
            return False
        if wl.max_waiting and wl.waiting >= wl.max_waiting:
            return True
        if (wl.max_waiting_tokens
                and wl.waiting_tokens >= wl.max_waiting_tokens):
            return True
        return False

    def est_wait_s(self, worker_id: str) -> Optional[float]:
        """Estimated admission-queue wait at this worker: published
        backlog depth x observed per-request queue wait. None without
        fresh data (no signal — never blocks)."""
        wl = self._load.get(worker_id)
        if wl is None or not self._fresh(wl, self.clock()):
            return None
        per_req = max(wl.queue_wait_s or 0.0, MIN_QUEUE_WAIT_S)
        return wl.waiting * per_req

    def cant_meet(self, worker_id: str,
                  deadline: Optional[float]) -> bool:
        """Would this worker's estimated queue wait blow the deadline?
        ``deadline`` is absolute unix time (wall clock — it crossed a
        process boundary)."""
        if deadline is None:
            return False
        est = self.est_wait_s(worker_id)
        if est is None:
            return False
        return time.time() + est > deadline

    def blocked(self, worker_ids: Iterable[str],
                deadline: Optional[float] = None) -> set[str]:
        """Workers the overload plane would steer this request away
        from. Advisory: the router relaxes this set before failing a
        request that has somewhere ELSE to go, and drops it entirely
        when it would empty the candidate list."""
        out = set()
        for wid in worker_ids:
            if self.saturated(wid) or self.cant_meet(wid, deadline):
                out.add(wid)
        return out
