"""Service-authoring SDK: ``@service`` / ``@endpoint`` / ``depends`` and
build/deploy (a copy of the JAX package's sdk.py; reference
deploy/sdk/src/dynamo/sdk/core/lib.py:88,121 and
core/protocol/deployment.py).

A decorated class is a runtime COMPONENT; its ``@endpoint`` methods serve
on the push-RPC plane (runtime/component.py); ``depends(Other)`` resolves
to a live endpoint client at serve time, through discovery, never a
direct object reference. The same declaration drives every deploy
target:

  serve_graph(...)   in-process: instantiate and register on a runtime
  build(...)         -> the launch/serve.py graph dict (the supervisor's
                        and ``serve --emit-k8s``'s input)
  deploy(...)        -> write the graph to the store key the operator's
                        reconcile loop watches (k8s.py)

A service's accelerator count is ``gpus`` (the graph's ``gpus`` key,
which the k8s manifests request as ``nvidia.com/gpu``); the JAX
package's is ``tpu_chips``.

Example::

    @service(namespace="app", args=["out=torch", "--model-config",
                                    "llama3_8b"], gpus=1)
    class Backend:
        @endpoint()
        async def generate(self, payload):
            yield {"data": ...}

    @service(namespace="app")
    class Api:
        backend = depends(Backend)

        @endpoint()
        async def chat(self, payload):
            async for out in self.backend.generate(payload):
                yield out
"""
from __future__ import annotations

import inspect
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Request stats: the SDK-side read of the engine's in-band annotations.
# The engine attaches per-request speculation counters (annotations
# ["spec"]) and timing (annotations["timing"]) to the finishing output;
# request_stats folds a request's output stream into one record.

@dataclass
class RequestStats:
    """Per-request generation statistics folded from an output stream."""

    output_tokens: int = 0
    finish_reason: Optional[str] = None
    # speculative decoding (zero when the request did not speculate)
    spec_proposed: int = 0
    spec_accepted: int = 0
    # from the engine's finishing annotation (annotations["timing"]);
    # None when the engine exported none (the echo and mocker engines)
    ttft_s: Optional[float] = None
    itl_p50_s: Optional[float] = None
    itl_p95_s: Optional[float] = None
    e2e_s: Optional[float] = None
    queue_s: Optional[float] = None

    @property
    def spec_acceptance_rate(self) -> Optional[float]:
        if self.spec_proposed <= 0:
            return None
        return self.spec_accepted / self.spec_proposed


def request_stats(outputs: Iterable[Any]) -> RequestStats:
    """Fold a request's LLMEngineOutput stream (objects or to_dict()
    payloads) into a RequestStats."""
    st = RequestStats()
    for out in outputs:
        if isinstance(out, dict):
            toks = out.get("token_ids") or []
            ann = out.get("annotations") or {}
            fr = out.get("finish_reason")
        else:
            toks = out.token_ids or []
            ann = out.annotations or {}
            fr = out.finish_reason.value if out.finish_reason else None
        st.output_tokens += len(toks)
        if fr is not None:
            st.finish_reason = fr
        spec = ann.get("spec")
        if spec:
            st.spec_proposed = int(spec.get("proposed", 0))
            st.spec_accepted = int(spec.get("accepted", 0))
        timing = ann.get("timing")
        if timing:
            for key in ("ttft_s", "itl_p50_s", "itl_p95_s", "e2e_s",
                        "queue_s"):
                if timing.get(key) is not None:
                    setattr(st, key, float(timing[key]))
    return st


@dataclass
class ServiceMeta:
    name: str
    namespace: str = "dynamo"
    replicas: int = 1
    gpus: int = 0
    args: list[str] = field(default_factory=list)
    endpoints: dict[str, str] = field(default_factory=dict)  # ep -> method
    dependencies: dict[str, type] = field(default_factory=dict)


class _Depends:
    """Declared dependency edge; resolved to an endpoint-client proxy at
    serve time (class attribute -> instance attribute)."""

    def __init__(self, target: type):
        if not hasattr(target, "_dynamo_service"):
            raise TypeError(
                f"depends() target {target!r} is not a @service class")
        self.target = target


def depends(target: type) -> Any:
    return _Depends(target)


def endpoint(name: Optional[str] = None) -> Callable:
    """Mark an async-generator method as a served endpoint."""

    def mark(fn):
        fn._dynamo_endpoint = name or fn.__name__
        return fn

    return mark


def service(
    name: Optional[str] = None,
    *,
    namespace: str = "dynamo",
    replicas: int = 1,
    gpus: int = 0,
    args: Optional[list[str]] = None,
) -> Callable[[type], type]:
    """Class decorator: declare a runtime component."""

    def wrap(cls: type) -> type:
        meta = ServiceMeta(
            name=name or cls.__name__.lower(),
            namespace=namespace,
            replicas=replicas,
            gpus=gpus,
            args=list(args or []),
        )
        for attr, value in list(vars(cls).items()):
            ep = getattr(value, "_dynamo_endpoint", None)
            if ep is not None:
                if not inspect.isasyncgenfunction(value):
                    raise TypeError(
                        f"@endpoint {cls.__name__}.{attr} must be an "
                        "async generator (yield response payloads)")
                meta.endpoints[ep] = attr
            if isinstance(value, _Depends):
                meta.dependencies[attr] = value.target
        if not meta.endpoints:
            raise TypeError(
                f"@service {cls.__name__} declares no @endpoint methods")
        cls._dynamo_service = meta
        return cls

    return wrap


class _ClientProxy:
    """What a depends() attribute becomes at serve time: the target
    service's endpoint names as async-generator calls."""

    def __init__(self, rt: Any, meta: ServiceMeta):
        self._rt = rt
        self._meta = meta
        self._clients: dict[str, Any] = {}

    def __getattr__(self, ep: str):
        if ep not in self._meta.endpoints:
            raise AttributeError(
                f"service {self._meta.name!r} has no endpoint {ep!r}")

        async def call(payload: dict):
            client = self._clients.get(ep)
            if client is None:
                client = await self._rt.namespace(
                    self._meta.namespace
                ).component(self._meta.name).endpoint(ep).client()
                self._clients[ep] = client
            async for item in client.generate(payload):
                yield item

        return call

    async def stop(self) -> None:
        for client in self._clients.values():
            await client.stop()
        self._clients.clear()


@dataclass
class ServedGraph:
    instances: list[Any]
    served: list[Any]

    async def stop(self) -> None:
        for s in self.served:
            await s.shutdown()
        for inst in self.instances:
            for value in vars(inst).values():
                if isinstance(value, _ClientProxy):
                    await value.stop()
            stop = getattr(inst, "stop", None)
            if stop is not None:
                await stop()


async def serve_graph(rt: Any, *services: type,
                      worker_id: str = "sdk-0") -> ServedGraph:
    """Instantiate the services and register every @endpoint on the
    runtime; depends() attributes become live client proxies (the
    reference ``dynamo serve`` in-process path, cli/serving.py:66)."""
    out = ServedGraph([], [])
    for cls in services:
        meta: ServiceMeta = cls._dynamo_service
        inst = cls()
        for attr, target in meta.dependencies.items():
            setattr(inst, attr, _ClientProxy(rt, target._dynamo_service))
        out.instances.append(inst)
        for ep, attr in meta.endpoints.items():
            handler = getattr(inst, attr)
            served = await rt.namespace(meta.namespace).component(
                meta.name
            ).endpoint(ep).serve(
                handler, worker_id=f"{worker_id}-{meta.name}")
            out.served.append(served)
        log.info("sdk: served %s (%s)", meta.name,
                 ", ".join(meta.endpoints))
    return out


def build(*services: type, control_plane_port: int = 7111,
          http_port: int = 8080) -> dict[str, Any]:
    """Declarations -> the launch/serve.py graph dict (``dynamo build``):
    run by ``python -m dynamo_tpu_torch.cli serve``, rendered by its
    ``--emit-k8s``, rolled out by its ``operator``."""
    if not services:
        raise ValueError("build() needs at least one @service class")
    ns = services[0]._dynamo_service.namespace
    workers = []
    for cls in services:
        meta: ServiceMeta = cls._dynamo_service
        workers.append({
            "name": meta.name,
            "replicas": meta.replicas,
            "gpus": meta.gpus,
            "args": list(meta.args),
        })
    return {
        "namespace": ns,
        "control_plane": {"port": control_plane_port},
        "frontend": {"http_port": http_port},
        "workers": workers,
    }


async def deploy(kv: Any, *services: type, **build_kw) -> str:
    """``dynamo deploy``: publish the built graph to the operator's spec
    key; its reconcile loop (k8s.DynamoOperator) rolls it out."""
    from dynamo_tpu_torch.k8s import graph_key

    graph = build(*services, **build_kw)
    key = graph_key(graph["namespace"])
    await kv.put(key, json.dumps(graph))
    return key
