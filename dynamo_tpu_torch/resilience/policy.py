"""Retry and circuit-breaker policy objects (a copy of the JAX package's
resilience/policy.py).

``RetryPolicy`` is the one backoff implementation shared by the runtime
client's connect loop, the store session's reconnect loop and the KV
router's re-route/migration attempts — exponential with equal-style
jitter (the delay lands uniformly in the top ``jitter`` fraction of the
backoff window), so a fleet of clients recovering from a control-plane
blip doesn't stampede it on synchronized retry ticks while still
guaranteeing a floor between attempts.

``CircuitBreaker`` is the classic three-state machine, one per worker
(health.py): CLOSED passes traffic; ``failure_threshold`` consecutive
failures trip it OPEN (the worker leaves routing); after
``reset_timeout_s`` the next ``allow()`` grants exactly one HALF_OPEN
probe — its success re-closes the breaker, its failure re-opens with the
timer restarted. The clock is injectable so the state machine unit-tests
with a fake clock.
"""
from __future__ import annotations

import asyncio
import enum
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

from dynamo_tpu_torch.resilience.metrics import RESILIENCE


@dataclass
class RetryPolicy:
    """Jittered exponential backoff: delay(i) lands uniformly in
    ((1-jitter) * b, b] for b = min(base * multiplier^i, max) — equal-
    style jitter: randomized spread with a guaranteed inter-attempt
    floor (full U(0, b] jitter would allow near-immediate retries)."""

    max_attempts: int = 4
    base_delay_s: float = 0.25
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.5          # fraction of the delay randomized away
    rng: Optional[random.Random] = None

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based: the sleep taken
        after the attempt-th failure)."""
        base = min(
            self.base_delay_s * (self.multiplier ** max(attempt, 0)),
            self.max_delay_s,
        )
        r = (self.rng or random).random()
        return base * (1.0 - self.jitter * r)

    async def sleep(self, attempt: int) -> None:
        RESILIENCE.inc("dynamo_resilience_retries_total")
        d = self.delay(attempt)
        if d > 0:
            await asyncio.sleep(d)


class BreakerState(str, enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe."""

    def __init__(
        self,
        failure_threshold: int = 3,
        reset_timeout_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.trips = 0
        self._opened_at = 0.0
        self._probe_outstanding = False

    def peek_allow(self) -> bool:
        """Side-effect-free: could a request be sent right now? Routing
        filters use this — the probe grant must only be CONSUMED
        (begin_probe) for the worker a request is actually dispatched to,
        or a probe 'spent' on a routing decision that picked another
        worker would starve the recovered worker forever."""
        if self.state is BreakerState.CLOSED:
            return True
        if self.state is BreakerState.OPEN:
            return self.clock() - self._opened_at >= self.reset_timeout_s
        return not self._probe_outstanding  # HALF_OPEN: one probe at a time

    def begin_probe(self) -> None:
        """A request is being dispatched while not CLOSED: this is the
        half-open probe. Resolves via record_success/record_failure."""
        if self.state is BreakerState.OPEN:
            self.state = BreakerState.HALF_OPEN
        self._probe_outstanding = True

    def allow(self) -> bool:
        """May a request be sent right now? OPEN past the reset timeout
        grants exactly ONE half-open probe (consumed — the caller WILL
        dispatch); further calls return False until that probe resolves
        via record_success/record_failure."""
        if not self.peek_allow():
            return False
        if self.state is not BreakerState.CLOSED:
            self.begin_probe()
        return True

    def record_success(self) -> None:
        if self.state is BreakerState.CLOSED:
            self.consecutive_failures = 0
            return
        if self._probe_outstanding:
            # the half-open probe succeeded: re-close
            self._probe_outstanding = False
            self.consecutive_failures = 0
            self.state = BreakerState.CLOSED
        # else: a STRAY success (a stream that was already in flight when
        # the breaker tripped, completing late) — it says nothing about
        # whether NEW requests succeed, so it must not short-circuit the
        # reset timeout + probe protocol

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        self._probe_outstanding = False
        if self.state is BreakerState.HALF_OPEN:
            self._trip()
        elif (self.state is BreakerState.CLOSED
              and self.consecutive_failures >= self.failure_threshold):
            self._trip()

    def _trip(self) -> None:
        self.state = BreakerState.OPEN
        self._opened_at = self.clock()
        self.trips += 1
        RESILIENCE.inc("dynamo_resilience_breaker_trips_total")
