"""Bounded admission: per-engine waiting-queue budgets (a copy of the JAX
package's overload/admission.py).

The engine's waiting queue was unbounded — a traffic storm grew
``_waiting`` without limit and every admitted request's TTFT degraded
with it. The controller enforces two budgets over the NOT-yet-prefilling
backlog (requests holding a lane don't count — they are active work):

  ``max_waiting_requests``        queue-depth budget (0 = unbounded)
  ``max_waiting_prefill_tokens``  prompt-token budget (0 = unbounded) —
                                  ten 10k-token prompts are a different
                                  storm than ten 10-token ones

Intake past either bound raises the retriable ``EngineOverloadedError``
carrying a LOAD-DERIVED retry hint: the expected queue drain time
(observed per-request queue wait x backlog depth), clamped to a sane
window — a barely-full queue says "come back in a second", a deep one
says "come back in ten".
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

from dynamo_tpu_torch.overload.errors import EngineOverloadedError

log = logging.getLogger(__name__)

# Retry-After clamp: never tell a client to hammer faster than this,
# never park it longer than that (the fleet may recover any moment).
RETRY_AFTER_MIN_S = 0.5
RETRY_AFTER_MAX_S = 30.0
# fallback per-request queue wait when no observation exists yet
DEFAULT_QUEUE_WAIT_S = 1.0


class AdmissionController:
    """Pure budget arithmetic — the engine supplies live queue state, a
    ``queue_wait_s`` callable supplies the observed per-request queue
    wait (e.g. the p50 of ``dynamo_request_queue_seconds``)."""

    def __init__(
        self,
        max_waiting_requests: int = 0,
        max_waiting_prefill_tokens: int = 0,
        queue_wait_s: Optional[Callable[[], Optional[float]]] = None,
    ):
        self.max_waiting_requests = max(0, int(max_waiting_requests))
        self.max_waiting_prefill_tokens = max(
            0, int(max_waiting_prefill_tokens)
        )
        self._queue_wait_s = queue_wait_s

    @property
    def bounded(self) -> bool:
        return bool(self.max_waiting_requests
                    or self.max_waiting_prefill_tokens)

    def over_budget(self, waiting_requests: int,
                    waiting_tokens: int) -> bool:
        """Is the CURRENT backlog at/over either budget? (A new arrival
        on a full queue is what tips over.)"""
        if (self.max_waiting_requests
                and waiting_requests >= self.max_waiting_requests):
            return True
        if (self.max_waiting_prefill_tokens
                and waiting_tokens >= self.max_waiting_prefill_tokens):
            return True
        return False

    def retry_after_s(self, waiting_requests: int) -> float:
        """Expected drain time of the backlog ahead of a retry: observed
        per-request queue wait x depth, clamped."""
        per_req = None
        if self._queue_wait_s is not None:
            try:
                per_req = self._queue_wait_s()
            except Exception:  # noqa: BLE001 — a hint, never a failure
                log.debug("queue-wait hint probe failed", exc_info=True)
                per_req = None
        if per_req is None or per_req <= 0:
            per_req = DEFAULT_QUEUE_WAIT_S
        est = max(1, waiting_requests) * per_req
        return min(RETRY_AFTER_MAX_S, max(RETRY_AFTER_MIN_S, est))

    def check(self, waiting_requests: int, waiting_tokens: int) -> None:
        """Raise the retriable overload error when the backlog is at
        budget (callers admit otherwise)."""
        if not self.over_budget(waiting_requests, waiting_tokens):
            return
        raise EngineOverloadedError(
            f"engine overloaded: {waiting_requests} waiting requests / "
            f"{waiting_tokens} waiting prefill tokens at budget "
            f"(max {self.max_waiting_requests} requests, "
            f"{self.max_waiting_prefill_tokens} tokens)",
            retry_after_s=self.retry_after_s(waiting_requests),
        )
