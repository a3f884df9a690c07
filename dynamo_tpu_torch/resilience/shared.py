"""Cross-frontend circuit-breaker sharing over the runtime store (a copy
of the JAX package's resilience/shared.py; the topic and the JSON are
its, so port and JAX-package frontends on one store exchange trips).

Each frontend would otherwise rediscover a dead worker on its own, paying
``failure_threshold`` failed requests per frontend before tripping. The
board closes that gap over the store's pub/sub plane:

  - a LOCAL trip publishes ``{worker_id, state: "open", until}`` on the
    namespace's breaker topic; sibling frontends block routing to that
    worker for the rest of the reset window
    (``WorkerHealthTracker.note_remote_open``);
  - a LOCAL probe success publishes ``state: "closed"``, lifting the
    remote block early everywhere.

Remote state is advisory: it never feeds a local breaker's failure
counts, and it expires on its own. Events carry an origin id so a
frontend ignores its own publications, and absolute unix ``until`` times
so the window survives the process hop.
"""
from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from typing import Any, Optional

log = logging.getLogger(__name__)

BREAKER_TOPIC = "health_breakers"


def breaker_topic(namespace: str) -> str:
    return f"{BREAKER_TOPIC}.{namespace}"


class SharedBreakerBoard:
    """Publish local breaker transitions; apply siblings' to the local
    health tracker."""

    def __init__(self, kv: Any, health: Any, namespace: str = "dynamo",
                 origin: Optional[str] = None):
        self.kv = kv
        self.health = health
        self.namespace = namespace
        self.origin = origin or uuid.uuid4().hex
        self.published = 0
        self.applied = 0
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    async def start(self) -> "SharedBreakerBoard":
        self._loop = asyncio.get_running_loop()
        sub = await self.kv.subscribe(breaker_topic(self.namespace))
        self._task = self._loop.create_task(self._follow(sub))
        self.health.on_state_change = self._on_local_change
        return self

    async def stop(self) -> None:
        if self.health.on_state_change == self._on_local_change:
            self.health.on_state_change = None
        if self._task is not None:
            self._task.cancel()
            self._task = None

    # ---- local -> fleet ----

    def _on_local_change(self, worker_id: str, state: str,
                         window_s: float) -> None:
        """Health-tracker hook; runs wherever record_failure/success ran,
        so the publish is scheduled onto the board's loop (best effort: a
        lost publish only costs siblings their own rediscovery)."""
        if self._loop is None or self._loop.is_closed():
            return
        payload = json.dumps({
            "worker_id": worker_id,
            "state": state,
            "until": time.time() + max(0.0, window_s),
            "origin": self.origin,
        })

        async def _pub() -> None:
            try:
                await self.kv.publish(breaker_topic(self.namespace), payload)
                self.published += 1
            except (ConnectionError, OSError):
                log.debug("breaker publish failed (store unreachable)")

        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop:
            self._loop.create_task(_pub())
        else:
            asyncio.run_coroutine_threadsafe(_pub(), self._loop)

    # ---- fleet -> local ----

    async def _follow(self, sub) -> None:
        async for ev in sub:
            try:
                msg = json.loads(ev["value"])
                wid = msg["worker_id"]
                state = msg["state"]
            except (KeyError, ValueError, TypeError):
                continue
            if msg.get("origin") == self.origin:
                continue  # our own publication echoing back
            if state == "open":
                window = float(msg.get("until", 0.0)) - time.time()
                if window > 0:
                    self.health.note_remote_open(wid, window)
                    self.applied += 1
            elif state == "closed":
                self.health.clear_remote_open(wid)
                self.applied += 1
