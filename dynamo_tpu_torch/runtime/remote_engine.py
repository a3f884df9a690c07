"""Engine <-> endpoint adapters: serve a local engine over the runtime, or
consume a remote endpoint as an AsyncEngine (the port's copy of the JAX
package's runtime/remote_engine.py).

Parity: worker side mirrors the reference PushEndpoint binding an
AsyncEngine to the network (pipeline/network/ingress/push_endpoint.rs:26);
client side mirrors PushRouter-as-engine (egress/push_router.rs +
kv_router.rs KvPushRouter's inner client). Payloads are
PreprocessedRequest/LLMEngineOutput dicts (protocols/common.py to_dict).
"""
from __future__ import annotations

import logging
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.runtime.component import Endpoint, EndpointClient, ServedEndpoint
from dynamo_tpu_torch.protocols.common import LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.resilience.chaos import CHAOS

log = logging.getLogger(__name__)


async def invoke_clear(clear) -> int:
    """Run an engine's clear_kv_blocks without blocking the event loop:
    async engines are awaited; a sync TpuEngine clear (which blocks until
    a round boundary) runs in a worker thread."""
    import asyncio
    import inspect

    if inspect.iscoroutinefunction(clear):
        return int(await clear() or 0)
    return int(await asyncio.to_thread(clear) or 0)


def engine_handler(engine: Any):
    """Wrap an AsyncEngine into an endpoint handler (worker side).

    Beyond generate, the handler services control verbs sent as
    ``{"__op__": ...}`` payloads — currently ``clear_kv``, the worker side
    of the frontend's /clear_kv_blocks fan-out (reference
    http/service/clear_kv_blocks.rs posts to every instance).

    Armed chaos points (resilience/chaos.py) wrap the response stream
    here, where a real worker death shows: a kill drops the connection
    with no done frame, and the router re-routes or migrates."""

    async def handler(payload: dict[str, Any]) -> AsyncIterator[dict[str, Any]]:
        if payload.get("__op__") == "clear_kv":
            clear = getattr(engine, "clear_kv_blocks", None)
            n = await invoke_clear(clear) if clear is not None else 0
            yield {"cleared": n}
            return
        req = PreprocessedRequest.from_dict(payload)
        handler.requests += 1
        src = engine.generate(req)
        if CHAOS.any_armed():
            src = CHAOS.wrap_stream(src)
        try:
            async for out in src:
                yield out.to_dict()
        finally:
            close = getattr(src, "aclose", None)
            if close is not None:
                await close()

    handler.requests = 0  # generate requests taken (the worker's own count)
    return handler


async def serve_engine(
    endpoint: Endpoint,
    engine: Any,
    *,
    worker_id: str = "",
    metadata: Optional[dict[str, Any]] = None,
    lease_ttl_s: float = 5.0,
) -> ServedEndpoint:
    """Expose `engine.generate` at an endpoint instance (lease-bound)."""
    start = getattr(engine, "start", None)
    if start is not None:
        start()
    return await endpoint.serve(
        engine_handler(engine),
        worker_id=worker_id,
        metadata=metadata,
        lease_ttl_s=lease_ttl_s,
    )


class RemoteEngine:
    """AsyncEngine over a remote endpoint: the frontend's view of a worker
    fleet. Routing mode is round_robin/random/direct per request."""

    def __init__(self, client: EndpointClient, mode: str = "round_robin"):
        self.client = client
        self.mode = mode

    async def generate(
        self, request: PreprocessedRequest, instance_id: Optional[int] = None
    ) -> AsyncIterator[LLMEngineOutput]:
        async for item in self.client.generate(
            request.to_dict(),
            mode="direct" if instance_id is not None else self.mode,
            instance_id=instance_id,
            request_id=request.request_id,
        ):
            yield LLMEngineOutput.from_dict(item)

    async def clear_kv_blocks(self) -> int:
        """Fan the clear_kv control verb out to EVERY live instance;
        returns total blocks cleared (reference clear_kv_blocks.rs
        broadcasts to all workers). A worker failing mid-clear is skipped —
        its lease expiry will drop it from the fleet anyway."""
        total = 0
        flt = self.client.instance_filter
        for iid, inst in list(self.client.instances.items()):
            if flt is not None and not flt(inst):
                continue
            try:
                async for item in self.client.generate(
                    {"__op__": "clear_kv"}, mode="direct", instance_id=iid,
                ):
                    total += int(item.get("cleared", 0))
            except Exception:  # noqa: BLE001 — best-effort per worker
                log.warning("clear_kv broadcast failed on instance %s",
                            iid, exc_info=True)
                continue
        return total


class RemoteWorkerEngine:
    """Per-worker direct engine view keyed by instance id — what the KV
    router's worker table holds for remote workers."""

    def __init__(self, client: EndpointClient, instance_id: int):
        self.client = client
        self.instance_id = instance_id

    async def clear_kv_blocks(self) -> int:
        total = 0
        async for item in self.client.generate(
            {"__op__": "clear_kv"}, mode="direct",
            instance_id=self.instance_id,
        ):
            total += int(item.get("cleared", 0))
        return total

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[LLMEngineOutput]:
        async for item in self.client.generate(
            request.to_dict(),
            mode="direct",
            instance_id=self.instance_id,
            request_id=request.request_id,
        ):
            yield LLMEngineOutput.from_dict(item)
