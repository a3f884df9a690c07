"""Overload-plane error types (a copy of the JAX package's
overload/errors.py).

Both subclass ``ConnectionError`` so every retriable-error path (the
endpoint wire's ``retriable`` frames, a router's failover loop) treats
them as "this worker, right now" problems rather than request failures.

``EngineOverloadedError`` additionally carries a load-derived
``retry_after_s`` hint end to end: the engine computes it from its queue
state, the endpoint wire ships it in the error frame, the router uses it
as the spill cooldown for the bounced worker, and the frontend surfaces
it as the HTTP 429 ``Retry-After`` header.
"""
from __future__ import annotations


class EngineOverloadedError(ConnectionError):
    """Admission refused: the engine's waiting-queue budget is full.

    Retriable by construction — the request was never admitted, so a
    retry (on a peer now, or here after ``retry_after_s``) cannot
    duplicate work or tokens.
    """

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 tenant: str = ""):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))
        # which tenant's budget refused the request ("" = the global
        # backlog budget). Rides the wire error frame.
        self.tenant = str(tenant)


class PreemptedError(ConnectionError):
    """A running low-priority stream was force-evicted to free a lane
    for a higher-priority request.

    Deliberately NOT ``EngineOverloadedError``: the router must treat
    this as a mid-stream loss and run the migration plane (replay prompt
    + emitted tokens on a peer, exactly-once) — preemption IS a forced
    migration, not a shed. The endpoint wire types only overload, so a
    remote PreemptedError arrives as a retriable connection error, as
    the JAX package's does.
    """
