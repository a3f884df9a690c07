"""Overload-plane error types (a copy of the JAX package's
overload/errors.py, cut to ``EngineOverloadedError``: the endpoint wire
carries it in-band with its ``retry_after_s`` hint).

It subclasses ``ConnectionError`` so every retriable-error path (the
endpoint wire's ``retriable`` frames, a router's failover loop) treats
it as a "this worker, right now" problem rather than a request failure.
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
