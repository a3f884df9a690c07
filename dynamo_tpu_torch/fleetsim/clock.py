"""Injectable clock: real time by default, compressed time in the sim
(the port's copy of the JAX package's fleetsim/clock.py).

Every sim-visible timestamp in the mocker, planner, metrics aggregator,
health tracker and load view routes through one of these objects (or a
bound ``.monotonic`` passed to components that take a bare callable).
``REAL_CLOCK`` delegates straight to ``time``/``asyncio`` so production
behavior is byte-identical when nothing injects a clock.

``VirtualClock`` is RATE-BASED, not discrete-event: virtual time is
``origin + wall_elapsed * rate`` and ``sleep(v)`` parks for ``v / rate``
wall seconds. That keeps ordinary asyncio semantics (timeouts, servers,
TCP all still work under it) while an hour of simulated traffic replays
in a minute at ``rate=60``. Determinism comes from seeded traces and the
mocker's deterministic token streams, not from the clock itself.

Invariants (tests/test_torch_fleetsim.py):
  - ``monotonic()`` never goes backwards;
  - after ``sleep(v)``, virtual time has advanced by at least ``v``;
  - wall time spent in ``sleep(v)`` is ~``v / rate``.
"""
from __future__ import annotations

import asyncio
import time


class Clock:
    """Real clock — the default injected everywhere. Subclasses override
    the four methods as one consistent unit: components must never mix
    timestamps from two different clock objects."""

    #: virtual seconds per wall second (1.0 = real time)
    rate: float = 1.0

    def monotonic(self) -> float:
        """Monotonic seconds (interval arithmetic: deadlines, staleness)."""
        return time.monotonic()

    def time(self) -> float:
        """Wall-clock seconds (absolute deadlines that cross processes)."""
        return time.time()

    async def sleep(self, seconds: float) -> None:
        """Park the current task for ``seconds`` of THIS clock's time."""
        await asyncio.sleep(seconds)

    def to_wall(self, seconds: float) -> float:
        """Convert a duration of this clock's time to wall seconds — for
        APIs that only take wall-clock timeouts (``asyncio.wait``)."""
        return seconds


REAL_CLOCK = Clock()


class VirtualClock(Clock):
    """Compressed clock: ``rate`` virtual seconds pass per wall second.

    ``monotonic()``/``time()`` are anchored at construction so a sim's
    virtual epoch starts where the wall clock stood (components mixing a
    virtual clock with un-swept ``time.*`` reads degrade gracefully to
    "no compression" instead of seeing decades-wide skews)."""

    def __init__(self, rate: float = 60.0):
        if rate <= 0:
            raise ValueError(f"clock rate must be positive, got {rate}")
        self.rate = float(rate)
        self._origin_mono = time.monotonic()
        self._origin_wall = time.time()

    def monotonic(self) -> float:
        return (self._origin_mono
                + (time.monotonic() - self._origin_mono) * self.rate)

    def time(self) -> float:
        return (self._origin_wall
                + (time.time() - self._origin_wall) * self.rate)

    async def sleep(self, seconds: float) -> None:
        await asyncio.sleep(max(0.0, seconds) / self.rate)

    def to_wall(self, seconds: float) -> float:
        return seconds / self.rate
