"""Retry policy (a copy of the JAX package's resilience/policy.py, cut to
``RetryPolicy``: the runtime client's connect loop and the store
session's reconnect loop use it).

``RetryPolicy`` is exponential backoff with equal-style jitter (the delay
lands uniformly in the top ``jitter`` fraction of the backoff window), so
a fleet of clients recovering from a control-plane blip doesn't stampede
it on synchronized retry ticks while still guaranteeing a floor between
attempts. The circuit breaker and the resilience counters come with the
rest of the resilience plane.
"""
from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass
from typing import Optional


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
        d = self.delay(attempt)
        if d > 0:
            await asyncio.sleep(d)
