"""Worker-side event/metrics publishing onto the runtime's pub/sub plane
(the port's copy of the JAX package's runtime/publisher.py).

Parity: reference kv_router/publisher.rs — KvEventPublisher (:99) pushes
block stored/removed events on the ``kv_events`` subject;
WorkerMetricsPublisher (:463) exposes ForwardPassMetrics. Engine callbacks
are synchronous; a queue + drain task bridges them onto the async client.
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics, KvCacheEvent
from dynamo_tpu_torch.runtime.client import KvClient

log = logging.getLogger(__name__)

KV_EVENTS_TOPIC = "kv_events"
METRICS_TOPIC = "load_metrics"


class _TopicPublisher:
    def __init__(self, kv: KvClient, topic: str):
        self.kv = kv
        self.topic = topic
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=4096)
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    def start(self) -> None:
        if self._task is None:
            self._loop = asyncio.get_running_loop()
            self._task = self._loop.create_task(self._drain())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def offer(self, payload: dict) -> None:
        """Thread-safe: engine callbacks fire from the engine's dedicated
        thread; asyncio.Queue is not thread-safe, so hop onto the
        publisher's loop unless already on it."""
        loop = self._loop
        if loop is None or loop.is_closed():
            # not started yet: buffer directly (put_nowait is safe pre-loop);
            # drained once start() spawns the task
            self._enqueue(payload)
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            self._enqueue(payload)
        else:
            loop.call_soon_threadsafe(self._enqueue, payload)

    def _enqueue(self, payload: dict) -> None:
        try:
            self.queue.put_nowait(payload)
        except asyncio.QueueFull:
            log.warning("publisher queue full; dropping %s event", self.topic)

    def rekey(self, worker_id: str, topic: str) -> None:
        """Retarget the publisher after a session lease rekey. worker_id
        is stamped into each payload at offer time but the topic is read
        at drain time, so payloads already queued under the old id are
        rewritten in place — they must not go out on the NEW topic still
        carrying the OLD worker_id (routers attribute KV blocks by the
        id inside the event, not the topic). Runs synchronously on the
        publisher's loop, so it is atomic wrt the drain task."""
        old = getattr(self, "worker_id", None)
        self.worker_id = worker_id
        self.topic = topic
        requeued = []
        while True:
            try:
                p = self.queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if isinstance(p, dict) and p.get("worker_id") == old:
                p = dict(p, worker_id=worker_id)
            requeued.append(p)
        for p in requeued:
            self.queue.put_nowait(p)

    async def _drain(self) -> None:
        while True:
            payload = await self.queue.get()
            try:
                await self.kv.publish(
                    self.topic, json.dumps(payload, separators=(",", ":"))
                )
            except (ConnectionError, OSError):
                log.warning("publish to %s failed; control plane down?", self.topic)
                await asyncio.sleep(0.5)


class KvEventPublisher(_TopicPublisher):
    """Callable sink for engine on_kv_event (publisher.rs:99)."""

    def __init__(self, kv: KvClient, worker_id: str):
        super().__init__(kv, f"{KV_EVENTS_TOPIC}.{worker_id}")
        self.worker_id = worker_id

    def __call__(self, event: KvCacheEvent) -> None:
        event.worker_id = self.worker_id
        self.offer(event.to_dict())


class WorkerMetricsPublisher(_TopicPublisher):
    """Callable sink for engine on_metrics (publisher.rs:463). Engines
    fire per scheduling round; publishes are throttled to min_interval_s
    so the event plane carries load snapshots, not a per-round firehose."""

    def __init__(self, kv: KvClient, worker_id: str,
                 min_interval_s: float = 0.25):
        super().__init__(kv, f"{METRICS_TOPIC}.{worker_id}")
        self.worker_id = worker_id
        self.min_interval_s = min_interval_s
        self._last = 0.0
        self._pending: Optional[dict] = None
        self._flush_task: Optional[asyncio.Task] = None

    def start(self) -> None:
        super().start()
        if self._flush_task is None:
            self._flush_task = self._loop.create_task(self._flush_pending())

    async def stop(self) -> None:
        if self._flush_task is not None:
            self._flush_task.cancel()
            self._flush_task = None
        await super().stop()

    def rekey(self, worker_id: str, topic: str) -> None:
        super().rekey(worker_id, topic)
        if self._pending is not None:  # throttled trailing sample
            self._pending = dict(self._pending, worker_id=worker_id)

    def __call__(self, metrics: ForwardPassMetrics) -> None:
        import time

        metrics.worker_id = self.worker_id
        payload = metrics.to_dict()
        now = time.monotonic()
        if now - self._last < self.min_interval_s and self.min_interval_s > 0:
            # trailing sample: remembered and flushed by the timer — the
            # LAST snapshot (e.g. "now idle") must eventually publish even
            # if the engine goes quiet right after it
            self._pending = payload
            return
        self._last = now
        self._pending = None
        self.offer(payload)

    async def _flush_pending(self) -> None:
        import time

        while True:
            await asyncio.sleep(max(self.min_interval_s, 0.05))
            p = self._pending
            if p is not None and (
                time.monotonic() - self._last >= self.min_interval_s
            ):
                self._pending = None
                self._last = time.monotonic()
                self.offer(p)
