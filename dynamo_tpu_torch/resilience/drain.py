"""Graceful drain: stop admitting, finish in-flight, then exit (a copy of
the JAX package's resilience/drain.py).

Killing a warm worker throws away its KV cache and its in-flight streams;
draining lets the streams finish (and the router stop choosing it) before
the process exits. Two triggers share one controller: ``POST /drain`` on
the worker's system server, and SIGTERM on the worker process.

Engine contract (TorchEngine and the disagg wrapper implement it):
  begin_drain()     stop admitting: new generate() calls raise
                    WorkerDrainingError (a ConnectionError, so routers
                    re-route instead of failing the request)
  drained() -> bool in-flight work is done
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Optional

from dynamo_tpu_torch.resilience.metrics import RESILIENCE

log = logging.getLogger(__name__)


class WorkerDrainingError(ConnectionError):
    """Raised by a draining engine's generate(): retriable by routers
    (the drain is this worker's problem, not the request's)."""


class DrainController:
    """Orchestrates one process's drain:

      1. engine.begin_drain(): refuse new admissions (synchronously)
      2. deregister (optional hook: revoke the lease so discovery stops
         routing here; racing requests bounce off WorkerDrainingError)
      3. poll engine.drained() until in-flight requests finish (or the
         timeout passes: then exit anyway)
      4. fire on_drained (the worker loop exits on it)
    """

    def __init__(
        self,
        engine: Any,
        *,
        on_deregister: Optional[Callable[[], Any]] = None,
        on_drained: Optional[Callable[[], Any]] = None,
        timeout_s: float = 60.0,
        poll_s: float = 0.05,
    ):
        self.engine = engine
        self.on_deregister = on_deregister
        self.on_drained = on_drained
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.state = "serving"           # serving | draining | drained
        self.requested_at: Optional[float] = None
        self.drained_event = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    def request_drain(self, reason: str = "") -> asyncio.Event:
        """Idempotent; safe from signal handlers on the event loop.
        Admissions stop SYNCHRONOUSLY (before the deregister round trip
        can lose a race with new arrivals); the wait runs as a task."""
        if self.state == "serving":
            self.state = "draining"
            self.requested_at = time.monotonic()
            RESILIENCE.set("dynamo_resilience_draining", 1)
            log.warning("drain requested%s", f" ({reason})" if reason else "")
            begin = getattr(self.engine, "begin_drain", None)
            if begin is not None:
                begin()
            self._task = asyncio.get_running_loop().create_task(self._run())
        return self.drained_event

    async def wait_drained(self) -> None:
        await self.drained_event.wait()

    async def _run(self) -> None:
        try:
            if self.on_deregister is not None:
                out = self.on_deregister()
                if asyncio.iscoroutine(out):
                    await out
        except Exception:  # noqa: BLE001 — drain proceeds regardless
            log.exception("drain: deregister hook failed")
        deadline = time.monotonic() + self.timeout_s
        drained_fn = getattr(self.engine, "drained", None)
        while drained_fn is not None and not drained_fn():
            if time.monotonic() > deadline:
                log.warning("drain timed out after %.1fs; exiting with "
                            "requests in flight", self.timeout_s)
                break
            await asyncio.sleep(self.poll_s)
        self.state = "drained"
        RESILIENCE.set("dynamo_resilience_draining", 0)
        RESILIENCE.inc("dynamo_resilience_drains_total")
        log.warning("drain complete (%.2fs)",
                    time.monotonic() - (self.requested_at or 0.0))
        self.drained_event.set()
        try:
            if self.on_drained is not None:
                out = self.on_drained()
                if asyncio.iscoroutine(out):
                    await out
        except Exception:  # noqa: BLE001
            log.exception("drain: on_drained hook failed")

    def status(self) -> dict[str, Any]:
        return {
            "state": self.state,
            "requested_at": self.requested_at,
            "timeout_s": self.timeout_s,
        }
