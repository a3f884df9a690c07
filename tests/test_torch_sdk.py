"""The port's SDK (dynamo_tpu_torch/sdk.py) against the JAX package's: the
decorators collect the same metadata and refuse the same mistakes; a
graph served in-process over the port's runtime answers through its
depends() proxy (discovery and push RPC, not a direct reference); and
build() and deploy() of the same declarations give the reference's graph
and store key, the accelerator count under the port's ``gpus`` key where
the reference's is ``tpu_chips``."""
import json

import pytest

from dynamo_tpu import sdk as rsdk
from dynamo_tpu.runtime.client import KvClient as RKvClient
from dynamo_tpu.runtime.store import serve_store as r_serve_store
from dynamo_tpu_torch import sdk as psdk
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.store import serve_store

ARGS = ["out=torch", "--model-config", "llama3_1b"]


def declare(sdk, accel):
    """The reference test's two services in ``sdk``; ``accel`` is its
    accelerator-count keyword."""
    @sdk.service(namespace="sdkt", replicas=2, args=ARGS, **{accel: 4})
    class Backend:
        @sdk.endpoint()
        async def generate(self, payload):
            for t in payload.get("token_ids", []):
                yield {"tok": t * 2}

    @sdk.service(namespace="sdkt")
    class Api:
        backend = sdk.depends(Backend)

        @sdk.endpoint()
        async def chat(self, payload):
            async for out in self.backend.generate(payload):
                yield {"chat": out["tok"]}

    return Backend, Api


Backend, Api = declare(psdk, "gpus")
RBackend, RApi = declare(rsdk, "tpu_chips")


def test_decorators_collect_metadata():
    meta = Backend._dynamo_service
    assert meta.name == "backend" and meta.replicas == 2 and meta.gpus == 4
    assert meta.endpoints == {"generate": "generate"}
    assert Api._dynamo_service.dependencies["backend"] is Backend
    ref = RBackend._dynamo_service
    assert (meta.name, meta.namespace, meta.replicas, meta.args,
            meta.endpoints) == (ref.name, ref.namespace, ref.replicas,
                                ref.args, ref.endpoints)


@pytest.mark.parametrize("sdk", [rsdk, psdk], ids=["ref", "port"])
def test_endpoint_must_be_async_generator(sdk):
    with pytest.raises(TypeError, match="async generator"):
        @sdk.service()
        class Bad:
            @sdk.endpoint()
            async def f(self, payload):
                return payload


@pytest.mark.parametrize("sdk", [rsdk, psdk], ids=["ref", "port"])
def test_depends_requires_service(sdk):
    with pytest.raises(TypeError, match="not a @service"):
        sdk.depends(dict)
    with pytest.raises(TypeError, match="no @endpoint"):
        @sdk.service()
        class Empty:
            pass


async def test_serve_graph_end_to_end():
    """Both services live on the port's runtime; the Api's depends()
    proxy routes through discovery and push RPC."""
    server, _ = await serve_store(port=0, sweep_interval_s=0.1)
    port = server.sockets[0].getsockname()[1]
    rt_s = await DistributedRuntime.connect(port=port)
    rt_c = await DistributedRuntime.connect(port=port)
    graph = await psdk.serve_graph(rt_s, Backend, Api)
    client = None
    try:
        client = await rt_c.namespace("sdkt").component("api").endpoint(
            "chat").client()
        got = [item["chat"] async for item in
               client.generate({"token_ids": [1, 2, 3]})]
        assert got == [2, 4, 6]
    finally:
        if client is not None:
            await client.stop()
        await graph.stop()
        await rt_c.close()
        await rt_s.close()
        server.close()


def test_request_stats_fold_equal_the_reference():
    outs = [{"token_ids": [1, 2]},
            {"token_ids": [3], "finish_reason": "length", "annotations": {
                "spec": {"proposed": 8, "accepted": 6},
                "timing": {"ttft_s": 0.1, "itl_p50_s": 0.02,
                           "itl_p95_s": None, "e2e_s": 0.5,
                           "queue_s": 0.01}}}]
    ref, port = rsdk.request_stats(outs), psdk.request_stats(outs)
    assert vars(port) == vars(ref)
    assert port.spec_acceptance_rate == ref.spec_acceptance_rate == 0.75
    assert psdk.RequestStats().spec_acceptance_rate is None


def _as_port(graph):
    """The reference's graph with its accelerator key renamed."""
    g = json.loads(json.dumps(graph))
    for w in g["workers"]:
        w["gpus"] = w.pop("tpu_chips")
    return g


async def test_build_and_deploy_equal_the_reference():
    g = psdk.build(Backend, Api, http_port=9090)
    assert g == _as_port(rsdk.build(RBackend, RApi, http_port=9090))
    assert g["namespace"] == "sdkt" and g["frontend"]["http_port"] == 9090
    names = {w["name"]: w for w in g["workers"]}
    assert names["backend"]["replicas"] == 2
    assert names["backend"]["gpus"] == 4 and "api" in names
    with pytest.raises(ValueError):
        psdk.build()

    # the built graph renders to k8s objects (the operator's input)
    from dynamo_tpu_torch.k8s import emit_k8s_manifests, graph_key

    objs = emit_k8s_manifests(g)
    backend = next(o for o in objs if o["metadata"]["name"] == "sdkt-backend")
    container = backend["spec"]["template"]["spec"]["containers"][0]
    assert container["resources"]["limits"] == {"nvidia.com/gpu": 4}

    # deploy writes the operator's spec key: the port's and the
    # reference's deploy each into a store of their package
    server, _ = await serve_store(port=0, sweep_interval_s=0.1)
    rserver, _ = await r_serve_store(port=0, sweep_interval_s=0.1)
    kv = await KvClient(port=server.sockets[0].getsockname()[1]).connect()
    rkv = await RKvClient(port=rserver.sockets[0].getsockname()[1]).connect()
    try:
        key = await psdk.deploy(kv, Backend, Api)
        rkey = await rsdk.deploy(rkv, RBackend, RApi)
        assert key == rkey == graph_key("sdkt")
        assert json.loads(await kv.get(key)) == _as_port(
            json.loads(await rkv.get(rkey)))
    finally:
        await kv.close()
        await rkv.close()
        server.close()
        rserver.close()
