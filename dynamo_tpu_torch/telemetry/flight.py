"""Flight recorder: a fixed-size ring of recent engine-round events (a
copy of the JAX package's telemetry/flight.py).

The engine records one entry per device-work dispatch (fused decode
round, spec verify, prefill chunk / batch, sp prefill) with the slot
set, speculative participation, and the host wall time the dispatch
took. The ring is served live at ``/debug/flight`` and dumped to the
log when an engine round fails — the last N dispatches before a crash
are exactly what postmortems need and exactly what logs never have.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional


class FlightRecorder:
    """Bounded ring of event dicts; thread-safe (engine thread writes,
    asyncio debug handlers read)."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._ring: list[Optional[dict[str, Any]]] = [None] * self.capacity
        self._next = 0          # ring write index
        self._seq = 0           # monotonically increasing event id
        self._lock = threading.Lock()

    def record(self, kind: str, **fields: Any) -> None:
        # the dict is assembled OUTSIDE the lock (it's built from
        # caller-local data; only the seq stamp and ring write need
        # exclusion) — record() sits on the engine's dispatch hot path
        ev = {"seq": 0, "ts": round(time.time(), 6), "kind": kind,
              **fields}
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self._ring[self._next] = ev
            self._next = (self._next + 1) % self.capacity

    def __len__(self) -> int:
        with self._lock:
            return min(self._seq, self.capacity)

    @property
    def recorded_total(self) -> int:
        with self._lock:
            return self._seq

    def snapshot(self) -> list[dict[str, Any]]:
        """Events oldest -> newest."""
        with self._lock:
            # strict <: at exactly `capacity` events _next has wrapped to
            # 0 and the ring is full — the sliced-prefix form would
            # return nothing
            if self._seq < self.capacity:
                out = self._ring[: self._next]
            else:
                out = self._ring[self._next:] + self._ring[: self._next]
            return [dict(e) for e in out if e is not None]

    def dump(self, log: Any, reason: str = "") -> None:
        """Write the ring to ``log`` (error level) — called on engine
        failure so the crash report carries the recent dispatch history."""
        events = self.snapshot()
        log.error(
            "flight recorder dump (%d of %d events)%s",
            len(events), self.recorded_total,
            f": {reason}" if reason else "",
        )
        for ev in events:
            log.error("  flight %s", ev)
