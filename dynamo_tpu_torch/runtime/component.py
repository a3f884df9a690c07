"""Namespace -> Component -> Endpoint model with lease-bound discovery (the
port's copy of the JAX package's runtime/component.py).

Parity: reference lib/runtime/src/component.rs:114 — an *instance* is
(namespace, component, endpoint, lease_id); registration lives at an
etcd-style path bound to the instance's lease, so a dead worker's
registration vanishes when its lease expires (component.rs:67-92,
transports/etcd.rs:66-148). Clients watch the instance prefix and
route via RoundRobin / Random / Direct (egress/push_router.rs:43-81).

Key layout (EtcdPath scheme, component.rs:72):
    dynamo://{namespace}/_components/{component}/{endpoint}/{lease_id}
        -> JSON {host, port, worker_id, metadata}
"""
from __future__ import annotations

import asyncio
import itertools
import json
import logging
import random
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.runtime.client import KvClient, Lease
from dynamo_tpu_torch.runtime.endpoint import EndpointServer, Handler, call_endpoint

log = logging.getLogger(__name__)

PREFIX = "dynamo://"


def instance_prefix(namespace: str, component: str, endpoint: str) -> str:
    return f"{PREFIX}{namespace}/_components/{component}/{endpoint}/"


@dataclass
class Instance:
    """One live endpoint instance (component.rs:92 Instance)."""

    namespace: str
    component: str
    endpoint: str
    lease_id: int
    host: str
    port: int
    worker_id: str = ""
    metadata: dict[str, Any] = field(default_factory=dict)

    @property
    def id(self) -> int:
        return self.lease_id


class ServedEndpoint:
    """A locally served endpoint: TCP server + lease-bound registration."""

    def __init__(self, server: EndpointServer, lease: Lease, key: str,
                 client: KvClient):
        self.server = server
        self.lease = lease
        self.key = key
        self._client = client

    @property
    def lease_id(self) -> int:
        return self.lease.id

    async def shutdown(self) -> None:
        """Graceful drain: revoke lease (deregisters) then stop serving.
        The publishers register_llm attached and the worker's ``parts``
        (the launcher's disagg config watch and block-transfer server)
        stop with it."""
        for part in getattr(self, "parts", ()):
            await part.stop()
        task = getattr(self, "kv_resync_task", None)
        if task is not None:
            task.cancel()
        for name in ("kv_publisher", "metrics_publisher"):
            pub = getattr(self, name, None)
            if pub is not None:
                await pub.stop()
        await self.lease.revoke()
        await self.server.stop()


class EndpointClient:
    """Watches an endpoint's instances; routes request streams.

    Modes mirror the reference PushRouter (push_router.rs:43-81):
    round_robin / random / direct(instance_id).
    """

    def __init__(self, kv: KvClient, namespace: str, component: str,
                 endpoint: str):
        self.kv = kv
        self.namespace = namespace
        self.component = component
        self.endpoint = endpoint
        self.prefix = instance_prefix(namespace, component, endpoint)
        self.instances: dict[int, Instance] = {}
        self._rr = itertools.count()
        self._watch_task: Optional[asyncio.Task] = None
        self.on_change: Optional[Any] = None  # callback(list[Instance])
        # optional predicate restricting routing to a subset of instances
        # (e.g. only workers serving a given model)
        self.instance_filter: Optional[Any] = None  # callback(Instance)->bool

    async def start(self) -> "EndpointClient":
        watch = await self.kv.watch_prefix(self.prefix)
        for k, v, lease in watch.initial:
            self._apply("put", k, v)
        self._watch_task = asyncio.get_running_loop().create_task(
            self._follow(watch)
        )
        return self

    async def stop(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None

    async def _follow(self, watch) -> None:
        async for ev in watch:
            self._apply(ev["event"], ev["key"], ev.get("value"))

    def _apply(self, event: str, key: str, value: Optional[str]) -> None:
        try:
            lease_id = int(key.rsplit("/", 1)[-1])
        except ValueError:
            return
        if event == "put" and value is not None:
            info = json.loads(value)
            self.instances[lease_id] = Instance(
                namespace=self.namespace,
                component=self.component,
                endpoint=self.endpoint,
                lease_id=lease_id,
                host=info["host"],
                port=info["port"],
                worker_id=info.get("worker_id", ""),
                metadata=info.get("metadata", {}),
            )
        elif event == "delete":
            self.instances.pop(lease_id, None)
        if self.on_change is not None:
            self.on_change(list(self.instances.values()))

    def instance_ids(self) -> list[int]:
        return sorted(self.instances)

    async def wait_for_instances(self, n: int = 1, timeout_s: float = 10.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout_s
        while len(self.instances) < n:
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(
                    f"{self.prefix}: {len(self.instances)}/{n} instances"
                )
            await asyncio.sleep(0.05)

    # ---- routing (push_router.rs modes) ----

    def _pick(self, mode: str, instance_id: Optional[int]) -> Instance:
        pool = self.instances
        if self.instance_filter is not None:
            pool = {i: inst for i, inst in pool.items()
                    if self.instance_filter(inst)}
        if not pool:
            raise ConnectionError(f"no instances for {self.prefix}")
        if mode == "direct":
            if instance_id not in self.instances:
                raise ConnectionError(f"instance {instance_id} not found")
            return self.instances[instance_id]
        ids = sorted(pool)
        if mode == "random":
            return pool[random.choice(ids)]
        return pool[ids[next(self._rr) % len(ids)]]

    async def generate(
        self,
        payload: dict[str, Any],
        *,
        mode: str = "round_robin",
        instance_id: Optional[int] = None,
        request_id: str = "",
    ) -> AsyncIterator[dict[str, Any]]:
        inst = self._pick(mode, instance_id)
        async for item in call_endpoint(
            inst.host, inst.port, payload, request_id
        ):
            yield item


class Endpoint:
    """One endpoint of a component; serve it or get a client for it."""

    def __init__(self, rt: "DistributedRuntime", namespace: str,
                 component: str, name: str):
        self.rt = rt
        self.namespace = namespace
        self.component = component
        self.name = name

    async def serve(
        self,
        handler: Handler,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        worker_id: str = "",
        metadata: Optional[dict[str, Any]] = None,
        lease_ttl_s: float = 5.0,
    ) -> ServedEndpoint:
        """Start serving + register lease-bound (component/service.rs:57-96)."""
        server = EndpointServer(handler, host, port)
        h, p = await server.start()
        lease = await self.rt.kv.lease_grant(lease_ttl_s)
        key = instance_prefix(self.namespace, self.component, self.name) + str(lease.id)
        await self.rt.kv.put(
            key,
            json.dumps({
                "host": h, "port": p, "worker_id": worker_id,
                "metadata": metadata or {},
            }),
            lease=lease.id,
        )
        return ServedEndpoint(server, lease, key, self.rt.kv)

    async def client(self) -> EndpointClient:
        c = EndpointClient(self.rt.kv, self.namespace, self.component, self.name)
        return await c.start()


class Component:
    def __init__(self, rt: "DistributedRuntime", namespace: str, name: str):
        self.rt = rt
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> Endpoint:
        return Endpoint(self.rt, self.namespace, self.name, name)


class Namespace:
    def __init__(self, rt: "DistributedRuntime", name: str):
        self.rt = rt
        self.name = name

    def component(self, name: str) -> Component:
        return Component(self.rt, self.name, name)


class DistributedRuntime:
    """Entry object (reference lib.rs:80 DistributedRuntime): one
    control-plane connection shared by everything in the process."""

    def __init__(self, kv: KvClient):
        self.kv = kv

    @classmethod
    async def connect(
        cls, host: str = "127.0.0.1", port: int = 7111,
        *, resync: bool = False,
    ) -> "DistributedRuntime":
        """With ``resync=True``, ``rt.kv`` is a `StoreSession` (duck-typed
        KvClient) that survives control-plane outages: auto-reconnect,
        lease re-grant + key re-registration, watch resync with
        synthesized deltas. Default False keeps the one-connection
        semantics tests rely on (a store death fails calls loudly)."""
        if resync:
            from dynamo_tpu_torch.runtime.session import StoreSession

            session = await StoreSession(host, port).connect()
            return cls(session)
        kv = await KvClient(host, port).connect()
        return cls(kv)

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    async def close(self) -> None:
        await self.kv.close()
