"""Standalone KV-router component (the port's copy of the JAX package's
router_service.py; reference components/router — the dynamo-router
binary, src/main.rs:53-77): a routing service OTHER processes query,
instead of routing embedded in the frontend.

It watches a component's worker instances, feeds its KvRouter from the
``kv_events`` pub/sub plane (events filtered to the watched fleet; a
departed worker's blocks leave the indexer), and serves a ``find_best``
endpoint on the runtime at ``{component}-router``: ``{token_ids,
request_id?, salt?} -> {worker_id, overlap_blocks, request_id}``.
Callers (custom frontends, gateways, schedulers) direct-route to the
chosen worker themselves and SHOULD send ``{"op": "free", "request_id":
...}`` on completion so the predicted-load estimate stays honest;
unfreed requests are swept after ``request_ttl_s`` as a backstop. The
wire is the JAX package's, so either package's clients query either
package's service.
"""
from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from collections import deque
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.kv_router.protocols import KvCacheEvent
from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.publisher import KV_EVENTS_TOPIC
from dynamo_tpu_torch.runtime.tasks import CriticalTask

log = logging.getLogger(__name__)


class RouterService:
    """Routing-as-a-service over the distributed runtime."""

    def __init__(
        self,
        rt: Any,
        namespace: str = "dynamo",
        component: str = "backend",
        endpoint: str = "generate",
        block_size: int = 64,
        router_config: Optional[KvRouterConfig] = None,
        worker_id: str = "router-0",
        request_ttl_s: float = 600.0,
    ):
        self.rt = rt
        self.namespace = namespace
        self.component = component
        self.endpoint = endpoint
        self.router = KvRouter(block_size, router_config)
        self.worker_id = worker_id
        self.request_ttl_s = request_ttl_s
        self.requests_routed = 0
        self._client = None
        self._served = None
        self._sub_task: Optional[asyncio.Task] = None
        self._sweep_task: Optional[asyncio.Task] = None
        self._fleet: set[str] = set()
        # routed-request ages for the TTL backstop sweep
        self._routed: dict[str, float] = {}
        # events racing discovery wait here and replay on fleet change
        self._deferred: deque = deque(maxlen=256)

    async def start(self) -> "RouterService":
        # watch the worker fleet
        self._client = await self.rt.namespace(self.namespace).component(
            self.component
        ).endpoint(self.endpoint).client()
        self._client.on_change = lambda instances: self._sync_fleet(
            {str(i.id) for i in instances}
        )
        self._sync_fleet(
            {str(i.id) for i in self._client.instances.values()}
        )
        # follow the KV-event plane (all workers of the watched component);
        # supervised — routing quality decays silently if this loop dies
        # (reference utils/task.rs:42)
        sub = await self.rt.kv.subscribe(f"{KV_EVENTS_TOPIC}.>")
        self._sub_task = CriticalTask(
            lambda: self._follow(sub), "router-kv-events"
        ).start()
        # serve find_best
        ep = self.rt.namespace(self.namespace).component(
            f"{self.component}-router"
        ).endpoint("find_best")
        self._served = await ep.serve(self._handle, worker_id=self.worker_id)
        self._sweep_task = CriticalTask(
            self._sweep_loop, "router-ttl-sweep"
        ).start()
        return self

    def _sync_fleet(self, fleet: set[str]) -> None:
        """Apply fleet membership: departed workers leave the indexer
        (their blocks died with them — watcher.py does the same), arrivals
        get racing events replayed."""
        for wid in self._fleet - fleet:
            self.router.indexer.remove_worker(wid)
        grew = bool(fleet - self._fleet)
        self._fleet = fleet
        self.router.update_workers(sorted(fleet))
        if grew and self._deferred:
            deferred, self._deferred = list(self._deferred), deque(maxlen=256)
            for event in deferred:
                self._apply_event(event)

    def _apply_event(self, event: KvCacheEvent) -> None:
        if event.worker_id in self._fleet:
            self.router.indexer.apply_event(event)
        else:
            # unknown worker: either foreign (dropped at replay too once
            # it never joins) or racing discovery (replayed on join)
            self._deferred.append(event)

    async def _sweep_loop(self) -> None:
        """TTL backstop: callers that never send free must not inflate
        predicted load forever."""
        while True:
            await asyncio.sleep(min(self.request_ttl_s / 4, 30.0))
            cutoff = time.monotonic() - self.request_ttl_s
            for rid, t in list(self._routed.items()):
                if t < cutoff:
                    self._routed.pop(rid, None)
                    self.router.free(rid)

    async def _follow(self, sub) -> None:
        async for ev in sub:
            try:
                event = KvCacheEvent.from_dict(json.loads(ev["value"]))
            except (KeyError, ValueError, TypeError):
                continue
            self._apply_event(event)

    async def _handle(self, payload: dict) -> AsyncIterator[dict]:
        if payload.get("op") == "free":
            rid = payload.get("request_id", "")
            self._routed.pop(rid, None)
            self.router.free(rid)
            yield {"freed": rid}
            return
        tokens = payload.get("token_ids") or []
        rid = payload.get("request_id") or uuid.uuid4().hex
        worker_id, overlap = self.router.find_best_match(
            rid, tokens, salt=payload.get("salt", "")
        )
        self._routed[rid] = time.monotonic()
        self.requests_routed += 1
        yield {"worker_id": worker_id, "overlap_blocks": overlap,
               "request_id": rid}

    async def stop(self) -> None:
        for t in (self._sub_task, self._sweep_task):
            if t is not None:
                await t.stop()
        self._sub_task = self._sweep_task = None
        if self._served is not None:
            await self._served.shutdown()
            self._served = None
        if self._client is not None:
            await self._client.stop()
            self._client = None


async def run_router(args) -> None:
    """CLI entry: ``python -m dynamo_tpu_torch.cli router`` (the
    dynamo-router binary shape). Serves until SIGTERM (exit code 0)."""
    from dynamo_tpu_torch.launch.run import sigterm_event

    host, _, port = args.control_plane.partition(":")
    rt = await DistributedRuntime.connect(
        host=host or "127.0.0.1", port=int(port or 7111)
    )
    svc = await RouterService(
        rt,
        namespace=args.namespace,
        component=args.component,
        endpoint=args.endpoint_name,
        block_size=args.block_size,
        router_config=KvRouterConfig(
            router_temperature=args.router_temperature
        ),
    ).start()
    # the handler goes in before the ready line, so a SIGTERM sent on
    # seeing that line exits 0
    stop = sigterm_event()
    print(f"router serving {args.namespace}/{args.component}-router/"
          f"find_best (watching {args.component}/{args.endpoint_name})",
          flush=True)
    try:
        await stop.wait()
    finally:
        await svc.stop()
        await rt.close()
