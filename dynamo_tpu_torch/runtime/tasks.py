"""Supervised critical tasks (a copy of the JAX package's runtime/tasks.py;
reference lib/runtime/src/utils/task.rs:42
``CriticalTaskExecutionHandle``): long-lived background loops whose death
must never be silent.

A ``CriticalTask`` wraps an async-callable factory: exceptions are
logged, the task restarts with exponential backoff up to
``max_restarts`` within ``restart_window_s``, and exhausting the budget
invokes ``on_give_up`` (default: log loudly) — mirroring the reference's
"critical task failure cancels the runtime" semantics, with the policy
injectable instead of hard-wired.
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Optional

log = logging.getLogger(__name__)


class CriticalTask:
    """Supervised background loop."""

    def __init__(
        self,
        factory: Callable[[], Awaitable[None]],
        name: str,
        *,
        restart: bool = True,
        max_restarts: int = 5,
        restart_window_s: float = 300.0,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        on_give_up: Optional[Callable[[BaseException], None]] = None,
    ):
        self.factory = factory
        self.name = name
        self.restart = restart
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.on_give_up = on_give_up
        self.restarts = 0
        self.failures = 0
        self._task: Optional[asyncio.Task] = None
        self._stopping = False

    def start(self) -> "CriticalTask":
        self._task = asyncio.get_running_loop().create_task(
            self._supervise(), name=f"critical:{self.name}"
        )
        return self

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception:  # noqa: BLE001
                log.debug("task %s raised during stop", self.name,
                          exc_info=True)
            self._task = None

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    async def _supervise(self) -> None:
        window_start = time.monotonic()
        failures_in_window = 0
        while not self._stopping:
            try:
                await self.factory()
                return  # clean completion
            except asyncio.CancelledError:
                raise
            except BaseException as e:  # noqa: BLE001 — that's the job
                self.failures += 1
                now = time.monotonic()
                if now - window_start > self.restart_window_s:
                    window_start = now
                    failures_in_window = 0
                failures_in_window += 1
                if not self.restart or failures_in_window > self.max_restarts:
                    log.critical(
                        "critical task %r failed permanently "
                        "(%d failures in window): %s",
                        self.name, failures_in_window, e, exc_info=True,
                    )
                    if self.on_give_up is not None:
                        self.on_give_up(e)
                    return
                delay = min(
                    self.backoff_base_s * (2 ** (failures_in_window - 1)),
                    self.backoff_max_s,
                )
                log.exception(
                    "critical task %r failed (restart %d in %.1fs)",
                    self.name, failures_in_window, delay,
                )
                self.restarts += 1
                await asyncio.sleep(delay)
