"""The port's distributed stack against the JAX package's, on the CPU: a
store, in=endpoint workers registered with register_llm, and a frontend
whose ModelWatcher discovers them (dynamo_tpu_torch/runtime/,
frontend/watcher.py). On tiny f32 weights shared through
params_from_jax, the port's store, TorchEngine worker and frontend answer
greedy requests token-identically to the JAX package's store, TpuEngine
worker and frontend, and the two packages' parts mix: a JAX-package
KV-routing frontend over a port worker, a port frontend over a
JAX-package worker. Everything runs on 127.0.0.1 with port 0."""
import asyncio
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from dynamo_tpu.frontend import ModelManager as RManager
from dynamo_tpu.frontend.watcher import ModelEntry as RModelEntry
from dynamo_tpu.frontend.watcher import ModelWatcher as RModelWatcher
from dynamo_tpu.frontend.watcher import register_llm as r_register_llm
from dynamo_tpu.runtime.component import DistributedRuntime as RRuntime
from dynamo_tpu.runtime.store import serve_store as r_serve_store
from dynamo_tpu_torch.engines import EchoEngine as PEcho
from dynamo_tpu_torch.frontend.http import HttpClient
from dynamo_tpu_torch.frontend.model_manager import ModelManager as PManager
from dynamo_tpu_torch.frontend.watcher import ModelEntry as PModelEntry
from dynamo_tpu_torch.frontend.watcher import ModelWatcher as PModelWatcher
from dynamo_tpu_torch.frontend.watcher import model_key
from dynamo_tpu_torch.frontend.watcher import register_llm as p_register_llm
from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
from dynamo_tpu_torch.runtime.component import DistributedRuntime as PRuntime
from dynamo_tpu_torch.runtime.store import serve_store as p_serve_store
from tests.test_torch_frontend import (
    CHAT,
    COMPL,
    ENGINE_KW,
    _assert_close,
    _joined,
    _Port,
    _Ref,
    _strip,
)

ROOT = Path(__file__).resolve().parent.parent
BS = ENGINE_KW["page_size"]
TTL = 10.0
SIDE = {
    "port": dict(serve_store=p_serve_store, Runtime=PRuntime,
                 Entry=PModelEntry, register=p_register_llm,
                 Watcher=PModelWatcher, Manager=PManager, Http=_Port),
    "ref": dict(serve_store=r_serve_store, Runtime=RRuntime,
                Entry=RModelEntry, register=r_register_llm,
                Watcher=RModelWatcher, Manager=RManager, Http=_Ref),
}


@pytest.fixture(scope="module")
def engines():
    """Two TorchEngines and a TpuEngine on the same tiny f32 weights."""
    from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu.models import llama as jl
    from dynamo_tpu.models.config import ModelConfig as JConfig
    from dynamo_tpu.parallel.mesh import MeshConfig
    from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig as TConfig
    from dynamo_tpu_torch.models.llama import params_from_jax

    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    ref = TpuEngine(JConfig.tiny(dtype="float32"), JEngineConfig(**ENGINE_KW),
                    params=jparams, mesh_config=MeshConfig(tp=1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    ports = [TorchEngine(TConfig.tiny(dtype="float32"),
                         TEngineConfig(**ENGINE_KW), params=tparams,
                         device="cpu") for _ in range(2)]
    yield {"ref": ref, "port": ports[0], "port2": ports[1]}
    for e in ports + [ref]:
        asyncio.run(e.stop())


class Stack:
    """A store, workers and a frontend, each from either package."""

    def __init__(self, store_pk="port", front_pk="port", ns="t"):
        self.store_pk, self.front_pk, self.ns = store_pk, front_pk, ns
        self.workers = []   # (rt, engine, served)

    async def __aenter__(self):
        srv, self.store = await SIDE[self.store_pk]["serve_store"](
            port=0, sweep_interval_s=0.05)
        self.server = srv
        self.port = srv.sockets[0].getsockname()[1]
        side = SIDE[self.front_pk]
        self.front_rt = await side["Runtime"].connect(port=self.port)
        self.manager = side["Manager"]()
        self.watcher = await side["Watcher"](
            self.front_rt, self.manager, namespace=self.ns).start()
        self.http = side["Http"](self.manager)
        await self.http.__aenter__()
        return self

    async def add_worker(self, pk, engine, name="tiny",
                         router_mode="round_robin", **entry_kw):
        side = SIDE[pk]
        rt = await side["Runtime"].connect(port=self.port)
        entry = side["Entry"](name=name, namespace=self.ns,
                              component="backend", block_size=BS,
                              router_mode=router_mode, **entry_kw)
        served = await side["register"](rt, engine, entry, lease_ttl_s=TTL)
        self.workers.append((rt, engine, served))
        return served

    async def wait_models(self, names, timeout=30.0):
        deadline = asyncio.get_running_loop().time() + timeout
        while self.manager.list_models() != sorted(names):
            assert asyncio.get_running_loop().time() < deadline, \
                self.manager.list_models()
            await asyncio.sleep(0.02)

    async def wait_instances(self, name, n, timeout=30.0):
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            chain = self.watcher._chains.get(name)
            if chain is not None and len(chain[1].instances) == n:
                return chain
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.02)

    async def __aexit__(self, *exc):
        await self.http.__aexit__(*exc)
        await self.watcher.stop()
        await self.front_rt.close()
        for rt, engine, served in self.workers:
            # the engines outlive the test's loop: detach the publishers
            if hasattr(engine, "on_metrics"):
                engine.on_metrics = None
            alloc = getattr(engine, "allocator", None)
            if alloc is not None:
                alloc.on_event = None
            await served.shutdown()
            await rt.close()
        self.server.close()


REQUESTS = [
    ("chat unary", CHAT, {"model": "tiny", "max_tokens": 6, "messages": [
        {"role": "user", "content": "hello world w1 w2"}]}),
    ("chat stream", CHAT, {"model": "tiny", "max_tokens": 6, "stream": True,
                           "stream_options": {"include_usage": True},
                           "messages": [{"role": "system", "content": "w3"},
                                        {"role": "user", "content": "w4"}]}),
    ("completion token ids", COMPL, {"model": "tiny", "max_tokens": 8,
                                     "prompt": list(range(5, 40))}),
    ("completion stream", COMPL, {
        "model": "tiny", "max_tokens": 8, "stream": True,
        "prompt": list(range(40, 60)),
        "stream_options": {"include_usage": True}}),
    ("completion logprobs", COMPL, {"model": "tiny", "max_tokens": 5,
                                    "prompt": "w5 w6 w7", "logprobs": 2}),
]


def _same(path, body, got, want):
    (gs, _, gb), (ws, _, wb) = got, want
    assert gs == ws == 200, (gb, wb)
    if body.get("stream"):
        gj, wj = _joined(gb), _joined(wb)
        assert gj["done"] and wj["done"]
        _assert_close(gj, wj)
        assert gj["finish"]
    else:
        _assert_close(_strip(gb), _strip(wb))
        assert gb["usage"]["completion_tokens"] > 0


@pytest.mark.parametrize("label,path,body", REQUESTS,
                         ids=[r[0] for r in REQUESTS])
async def test_port_stack_matches_reference_stack(engines, label, path,
                                                  body):
    """Port store + TorchEngine worker + port frontend against the JAX
    package's store + TpuEngine worker + frontend, over HTTP."""
    out = []
    for pk in ("port", "ref"):
        async with Stack(pk, pk) as s:
            await s.add_worker(pk, engines[pk])
            await s.wait_models(["tiny"])
            out.append(await s.http.call("POST", path, body,
                                         stream=bool(body.get("stream"))))
    _same(path, body, *out)


async def _reference_answer(engines, path, body):
    async with Stack("ref", "ref") as s:
        await s.add_worker("ref", engines["ref"])
        await s.wait_models(["tiny"])
        return await s.http.call("POST", path, body,
                                 stream=bool(body.get("stream")))


async def test_reference_kv_frontend_over_port_worker(engines):
    """The JAX package's frontend with its default KV router serves a port
    worker: tokens as the reference stack's, and the reference indexer
    holds the port worker's blocks under its lease id."""
    # a prompt no other case sends: its blocks are new to the engine's
    # cache, so their STORED events go out while the publisher is attached
    path, body = COMPL, {"model": "tiny", "max_tokens": 8,
                         "prompt": list(range(60, 95))}
    want = await _reference_answer(engines, path, body)
    async with Stack("port", "ref") as s:
        served = await s.add_worker("port", engines["port"],
                                    router_mode="kv")
        await s.wait_models(["tiny"])
        got = await s.http.call("POST", path, body)
        _same(path, body, got, want)
        push = s.watcher._routers["tiny"]
        wid = str(served.lease_id)
        assert set(push.workers) == {wid}
        # 35 prompt tokens + 8 generated: 2 sealed blocks of 16 at least
        deadline = asyncio.get_running_loop().time() + 30
        while len(push.router.indexer._by_worker.get(wid, ())) < 2:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.05)
        assert set(push.router.indexer._by_worker) == {wid}


async def test_port_frontend_over_reference_worker(engines):
    _, path, body = REQUESTS[1]
    want = await _reference_answer(engines, path, body)
    async with Stack("ref", "port") as s:
        await s.add_worker("ref", engines["ref"])
        await s.wait_models(["tiny"])
        got = await s.http.call("POST", path, body, stream=True)
    _same(path, body, got, want)


async def test_round_robin_and_failover_across_two_port_workers(engines):
    _, path, body = REQUESTS[0]
    want = await _reference_answer(engines, path, body)
    async with Stack() as s:
        a = await s.add_worker("port", engines["port"])
        b = await s.add_worker("port", engines["port2"])
        await s.wait_models(["tiny"])
        await s.wait_instances("tiny", 2)
        for _ in range(4):
            _same(path, body, await s.http.call("POST", path, body), want)
        assert (a.server.handler.requests, b.server.handler.requests) \
            == (2, 2)
        # a worker whose lease is revoked leaves the rotation
        await a.lease.revoke()
        await s.wait_instances("tiny", 1)
        for _ in range(3):
            _same(path, body, await s.http.call("POST", path, body), want)
        assert (a.server.handler.requests, b.server.handler.requests) \
            == (2, 5)


async def test_models_sharing_component_do_not_cross_route():
    async with Stack() as s:
        served = {name: await s.add_worker("port", PEcho(delay_s=0.0),
                                           name=name)
                  for name in ("ma", "mb")}
        await s.wait_models(["ma", "mb"])
        for name in ("ma", "ma", "mb"):
            st, _, b = await s.http.call("POST", CHAT, {
                "model": name, "max_tokens": 3,
                "messages": [{"role": "user", "content": "w1 w2"}]})
            assert st == 200 and b["model"] == name
        assert served["ma"].server.handler.requests == 2
        assert served["mb"].server.handler.requests == 1
        # the model goes with its last instance
        await served["mb"].lease.revoke()
        await s.wait_models(["ma"])
        st, _, _ = await s.http.call("POST", CHAT, {
            "model": "mb", "messages": [{"role": "user", "content": "w1"}]})
        assert st == 404


async def test_clear_kv_fans_out_to_every_worker(engines):
    async with Stack() as s:
        for k in ("port", "port2"):
            await s.add_worker("port", engines[k])
        await s.wait_instances("tiny", 2)
        for i in range(4):
            st, _, _ = await s.http.call("POST", COMPL, {
                "model": "tiny", "max_tokens": 4,
                "prompt": list(range(10 + i, 60 + i))})
            assert st == 200
        allocs = [engines[k].allocator for k in ("port", "port2")]
        held = [len(a._lru) for a in allocs]
        assert all(held), held
        remote = s.manager.get("tiny").engine
        assert await remote.clear_kv_blocks() == sum(held)
        assert [len(a._lru) for a in allocs] == [0, 0]
        st, _, body = await s.http.call("POST", "/clear_kv_blocks")
        assert (st, body) == (200, {"cleared": ["tiny"]})


async def test_port_frontend_refuses_kv_and_checkpoint_entries(tmp_path):
    """An entry with an unknown router mode is refused (404, with the
    reason). A kv entry, refused before the KV router was ported, and
    checkpoint entries, refused before checkpoints were ported, are
    served: a checkpoint whose tokenizer does not load (a directory
    without tokenizer.json, an empty card) is served with the test
    tokenizer, as the reference serves it."""
    async with Stack() as s:
        await s.add_worker("port", PEcho(delay_s=0.0), name="kvm",
                           router_mode="kv")
        await s.add_worker("port", PEcho(delay_s=0.0), name="ckpt",
                           model_path=str(tmp_path))
        await s.add_worker("port", PEcho(delay_s=0.0), name="card",
                           card_ref="bucket")
        await s.add_worker("port", PEcho(delay_s=0.0), name="odd",
                           router_mode="broadcast")
        await s.add_worker("port", PEcho(delay_s=0.0), name="ok")
        await s.wait_models(["card", "ckpt", "kvm", "ok"])
        deadline = asyncio.get_running_loop().time() + 30
        while len(s.watcher.refused) < 1:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.02)
        assert set(s.watcher.refused) == {"odd"}
        assert "router_mode" in s.watcher.refused["odd"]
        st, _, body = await s.http.call("GET", "/v1/models")
        assert [m["id"] for m in body["data"]] == ["card", "ckpt", "kvm",
                                                    "ok"]
        st, _, _ = await s.http.call("POST", CHAT, {
            "model": "odd", "messages": [{"role": "user", "content": "w1"}]})
        assert st == 404
        answers = []
        for name in ("ckpt", "card", "ok"):
            st, _, body = await s.http.call("POST", CHAT, {
                "model": name, "max_tokens": 3,
                "messages": [{"role": "user", "content": "w1 w2"}]})
            assert st == 200 and body["model"] == name
            answers.append(body["choices"][0]["message"]["content"])
        assert answers[0] == answers[1] == answers[2]
        st, _, body = await s.http.call("POST", CHAT, {
            "model": "kvm", "max_tokens": 3,
            "messages": [{"role": "user", "content": "w1 w2"}]})
        assert st == 200 and body["model"] == "kvm"
        assert set(s.watcher._routers) == {"kvm"}
        # the entries in the store are the JAX package's format
        kvs = await s.front_rt.kv.get_prefix(model_key("t", "kvm"))
        assert RModelEntry.from_json(kvs[0][1]).router_mode == "kv"


async def test_on_metrics_beats_and_stored_event_snapshots(engines):
    from dynamo_tpu.engine.cache import PageAllocator as RAlloc
    from dynamo_tpu_torch.engine.cache import PageAllocator as PAlloc

    eng = engines["port2"]
    beats = []
    eng.on_metrics = beats.append
    eng.start()  # the beat needs the engine's thread, run alone too
    try:
        # the idle heartbeat, every 0.5 s
        deadline = asyncio.get_running_loop().time() + 30
        while len(beats) < 2:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.05)
        from dynamo_tpu_torch.protocols.common import (
            PreprocessedRequest,
            StopConditions,
        )

        n0 = len(beats)
        req = PreprocessedRequest(
            token_ids=list(range(5, 45)),
            stop_conditions=StopConditions(max_tokens=30, ignore_eos=True))
        busy = []
        async for out in eng.generate(req):
            busy.append(eng._slot_active.any())
        assert any(busy) and len(beats) > n0
        m = beats[-1]
        assert m.worker_stats.request_total_slots == ENGINE_KW[
            "max_decode_slots"]
        assert m.kv_stats.kv_total_blocks == eng.allocator.total_pages
    finally:
        eng.on_metrics = None

    # the allocators' snapshots for the same commits
    snaps = []
    for Alloc in (PAlloc, RAlloc):
        a = Alloc(32, 4, worker_id="w")
        pages = a.allocate(6)
        for i, p in enumerate(pages):
            a.commit(p, 1000 + i, 999 + i if i else 0)
        a.free(pages[:3])
        snaps.append([e.to_dict() for e in a.snapshot_stored_events(batch=4)])
    assert snaps[0] == snaps[1]
    assert [e["kind"] for e in snaps[0]] == ["cleared", "stored", "stored"]


# ---------------------------------------------------------------------------
# the KV router on the port's frontend


async def _wait_for(pred, what, timeout=30.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.02)


async def _fresh(engines, *keys):
    """Drop the engines' cached blocks, so the next request's blocks are
    stored anew (their STORED events go out while a publisher listens)."""
    for k in keys:
        await asyncio.to_thread(engines[k].clear_kv_blocks)


async def _kv_reference_answer(engines, path, body):
    async with Stack("ref", "ref") as s:
        await s.add_worker("ref", engines["ref"], router_mode="kv")
        await s.wait_models(["tiny"])
        return await s.http.call("POST", path, body,
                                 stream=bool(body.get("stream")))


@pytest.mark.parametrize("label,path,body", REQUESTS,
                         ids=[r[0] for r in REQUESTS])
async def test_port_kv_stack_matches_reference_kv_stack(engines, label,
                                                        path, body):
    """A port frontend KV-routing over two port workers answers as the
    JAX package's KV-routed stack over TpuEngine."""
    want = await _kv_reference_answer(engines, path, body)
    async with Stack() as s:
        for k in ("port", "port2"):
            await s.add_worker("port", engines[k], router_mode="kv")
        await s.wait_instances("tiny", 2)
        push = s.watcher._routers["tiny"]
        await _wait_for(lambda: len(push.workers) == 2, "two workers")
        got = await s.http.call("POST", path, body,
                                stream=bool(body.get("stream")))
    _same(path, body, got, want)


async def test_repeated_prompt_routes_to_its_warm_worker(engines):
    """The second time a prompt comes, the router sends it to the worker
    that served it, with the blocks that worker sealed as the overlap
    (the router salts with the model name, as the engine hashes)."""
    path, body = COMPL, {"model": "tiny", "max_tokens": 8,
                         "prompt": list(range(100, 150))}
    want = await _kv_reference_answer(engines, path, body)
    await _fresh(engines, "port", "port2")
    async with Stack() as s:
        # the router's argmin (temperature 0: no sampling)
        s.watcher.router_config = KvRouterConfig(router_temperature=0.0)
        served = [await s.add_worker("port", engines[k], router_mode="kv")
                  for k in ("port", "port2")]
        await s.wait_instances("tiny", 2)
        push = s.watcher._routers["tiny"]
        await _wait_for(lambda: len(push.workers) == 2, "two workers")
        hits = []
        push.router.scheduler.on_hit_rate = hits.append
        _same(path, body, await s.http.call("POST", path, body), want)
        first = [str(x.lease_id) for x in served
                 if x.server.handler.requests == 1]
        assert len(first) == 1 and hits[-1].worker_id == first[0]
        # 50 prompt tokens: 3 sealed blocks of 16 under the lease id
        idx = push.router.indexer
        await _wait_for(lambda: len(idx._by_worker.get(first[0], ())) >= 3,
                        "the warm worker's blocks")
        for _ in range(3):
            _same(path, body, await s.http.call("POST", path, body), want)
            assert hits[-1].worker_id == first[0]
            assert hits[-1].overlap_blocks >= 3
        assert sorted(x.server.handler.requests for x in served) == [0, 4]
        # the metrics tap: both workers heartbeat into the shared views
        wids = {str(x.lease_id) for x in served}
        await _wait_for(lambda: set(s.watcher.health._last_seen) >= wids,
                        "heartbeats")
        assert set(s.watcher.load._load) >= wids


async def test_port_kv_frontend_over_reference_worker(engines):
    """The port's KV-routing frontend serves a JAX-package worker and
    holds that worker's blocks under its lease id."""
    path, body = COMPL, {"model": "tiny", "max_tokens": 8,
                         "prompt": list(range(150, 190))}
    want = await _kv_reference_answer(engines, path, body)
    await _fresh(engines, "ref")
    async with Stack("port", "port") as s:
        served = await s.add_worker("ref", engines["ref"], router_mode="kv")
        await s.wait_models(["tiny"])
        push = s.watcher._routers["tiny"]
        await _wait_for(lambda: len(push.workers) == 1, "the worker")
        _same(path, body, await s.http.call("POST", path, body), want)
        wid = str(served.lease_id)
        idx = push.router.indexer
        await _wait_for(lambda: len(idx._by_worker.get(wid, ())) >= 2,
                        "the reference worker's blocks")
        assert set(idx._by_worker) == {wid}
        # its lease gone, the model goes with its router
        await served.lease.revoke()
        await s.wait_models([])
        assert not s.watcher._routers


async def test_clear_kv_through_a_kv_routed_port_frontend(engines):
    await _fresh(engines, "port", "port2")
    async with Stack() as s:
        for k in ("port", "port2"):
            await s.add_worker("port", engines[k], router_mode="kv")
        await s.wait_instances("tiny", 2)
        push = s.watcher._routers["tiny"]
        await _wait_for(lambda: len(push.workers) == 2, "two workers")
        # prompts of their own family each, spread by the seeded draws
        push.router.scheduler.selector.rng = random.Random(1)
        for i in range(4):
            st, _, _ = await s.http.call("POST", COMPL, {
                "model": "tiny", "max_tokens": 4,
                "prompt": list(range(20 + 50 * i, 70 + 50 * i))})
            assert st == 200
        idx = push.router.indexer
        await _wait_for(lambda: len(idx._by_worker) == 2,
                        "both workers' blocks")
        allocs = [engines[k].allocator for k in ("port", "port2")]
        assert all(len(a._lru) for a in allocs)
        st, _, body = await s.http.call("POST", "/clear_kv_blocks")
        assert (st, body) == (200, {"cleared": ["tiny"]})
        assert [len(a._lru) for a in allocs] == [0, 0]
        assert idx._by_worker == {} and idx.total_blocks() == 0


async def test_kv_events_racing_discovery_are_buffered_and_replayed():
    """An event for a worker the frontend has not discovered yet waits in
    the bounded buffer (never in a foreign router's indexer), and is
    applied when the worker appears; one past the TTL is dropped; the
    store session's degraded state freezes the health and load views."""
    from dynamo_tpu_torch.frontend import watcher as pw
    from dynamo_tpu_torch.kv_router.protocols import (
        KvCacheEvent,
        KvEventKind,
        StoredBlock,
    )
    from dynamo_tpu_torch.runtime.component import Instance

    async with Stack() as s:
        await s.add_worker("port", PEcho(delay_s=0.0), router_mode="kv")
        await s.wait_models(["tiny"])
        push = s.watcher._routers["tiny"]
        await _wait_for(lambda: len(push.workers) == 1, "the worker")

        def ev(wid, h):
            return KvCacheEvent(kind=KvEventKind.STORED, worker_id=wid,
                                blocks=[StoredBlock(block_hash=h)])

        assert not s.watcher._route_kv_event(ev("777", 11))
        assert not s.watcher._route_kv_event(ev("888", 12))
        s.watcher._unclaimed_events[1] = (
            s.watcher._unclaimed_events[1][0] - pw.UNCLAIMED_TTL_S - 1,
            s.watcher._unclaimed_events[1][1])
        assert push.router.indexer.total_blocks() == 0
        chain = s.watcher._chains["tiny"][1]
        late = [Instance(namespace="t", component="backend",
                         endpoint="generate", lease_id=lid, host="127.0.0.1",
                         port=1, metadata={"model": "tiny"})
                for lid in (777, 888)]
        chain.on_change(list(chain.instances.values()) + late)
        assert push.router.indexer._by_worker.get("777") == {11}
        assert "888" not in push.router.indexer._by_worker
        assert not s.watcher._unclaimed_events
    # the store-state listener
    srv, _ = await p_serve_store(port=0, sweep_interval_s=0.05)
    rt = await PRuntime.connect(port=srv.sockets[0].getsockname()[1],
                                resync=True)
    w = await PModelWatcher(rt, PManager(), namespace="t2").start()
    try:
        rt.kv._set_degraded(True)
        assert w.health._frozen_at is not None
        assert w.load._frozen_at is not None
        rt.kv._set_degraded(False)
        assert w.health._frozen_at is None and w.load._frozen_at is None
    finally:
        await w.stop()
        await rt.close()
        srv.close()


# ---------------------------------------------------------------------------
# the entry points in subprocesses, with jax, the JAX package and aiohttp
# unimportable: cli cp, two in=endpoint workers and in=http --control-plane

BLOCKED = ("jax", "dynamo_tpu", "aiohttp")
RUNNER = (
    "import sys, runpy\n"
    f"BLOCKED = {BLOCKED!r}\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in BLOCKED:\n"
    "            raise ImportError(f'{name} is blocked')\n"
    "sys.meta_path.insert(0, Block())\n"
    "mod, sys.argv = sys.argv[1], sys.argv[1:]\n"
    "runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mod, *argv):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DYNTPU_")}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.Popen(
        [sys.executable, "-c", RUNNER, mod, *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_entry_points_serve_from_two_workers():
    cp_port, http_port = _free_port(), _free_port()
    tiny = ["out=torch", "--model-config", "tiny", "--cache-dtype",
            "float32", "--device", "cpu", "--model-name", "tiny"]
    procs = [_spawn("dynamo_tpu_torch.cli", "cp", "--port", str(cp_port))]
    try:
        assert "listening on 127.0.0.1:" in procs[0].stdout.readline()
        cp = ["--control-plane", f"127.0.0.1:{cp_port}"]
        workers = [_spawn("dynamo_tpu_torch.launch.run", "in=endpoint",
                          "--router-mode", "round_robin", *tiny, *cp)
                   for _ in range(2)]
        procs += workers
        for w in workers:
            lines = [w.stdout.readline() for _ in range(2)]
            assert "TorchEngine on cpu" in lines[0], lines
            assert "serving dynamo/backend/generate" in lines[1], lines
        front = _spawn("dynamo_tpu_torch.launch.run", "in=http",
                       "--http-host", "127.0.0.1", "--http-port",
                       str(http_port), *cp)
        procs.append(front)
        assert "dynamic frontend on" in front.stdout.readline()

        async def ask():
            async with HttpClient("127.0.0.1", http_port) as c:
                for _ in range(600):
                    r = await c.request("GET", "/v1/models")
                    if r.json()["data"]:
                        break
                    await asyncio.sleep(0.05)
                texts = []
                for _ in range(4):
                    r = await c.request("POST", CHAT, json_body={
                        "model": "tiny", "max_tokens": 6, "messages": [
                            {"role": "user", "content": "w1 w2 w3"}]})
                    assert r.status == 200, r.json()
                    texts.append(r.json()["choices"][0]["message"]["content"])
                return texts

        texts = asyncio.run(asyncio.wait_for(ask(), 120))
        text = _spawn("dynamo_tpu_torch.launch.run", "in=text", *tiny,
                      "--prompt", "w1 w2 w3", "--max-tokens", "6")
        out, _ = text.communicate(timeout=120)
        assert text.returncode == 0, out
        assert texts == [out.splitlines()[-1]] * 4, (texts, out)
        for p in workers:
            p.terminate()
        counts = []
        for w in workers:
            out, _ = w.communicate(timeout=60)
            assert w.returncode == 0, out
            counts += [int(line.split()[-2]) for line in out.splitlines()
                       if line.startswith("worker instance")]
        assert counts == [2, 2], counts
        for p in (front, procs[0]):
            p.terminate()
            out, _ = p.communicate(timeout=60)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_remote_worker_serves_its_trace_prof_flight_and_dossier():
    """The remote-worker path of the telemetry plane, as processes: a
    worker (in=endpoint --system-port, forensics sample rate 1.0) and a
    frontend in another process. The frontend's /debug/trace/{id} holds
    its own tokenize and route spans merged with the worker's, which
    crossed the endpoint hop in the finishing output; the worker's system
    server serves the same worker spans (recorded with no frontend in its
    process), a sampled dossier with a Perfetto export, its round
    attribution (coverage 1 +- 0.02) and its flight ring."""
    cp_port, http_port, sys_port = _free_port(), _free_port(), _free_port()
    tiny = ["out=torch", "--model-config", "tiny", "--cache-dtype",
            "float32", "--device", "cpu", "--model-name", "tiny"]
    procs = [_spawn("dynamo_tpu_torch.cli", "cp", "--port", str(cp_port))]
    try:
        assert "listening on 127.0.0.1:" in procs[0].stdout.readline()
        cp = ["--control-plane", f"127.0.0.1:{cp_port}"]
        worker = _spawn("dynamo_tpu_torch.launch.run", "in=endpoint", *tiny,
                        *cp, "--system-port", str(sys_port),
                        "--forensics-sample-rate", "1.0",
                        "--slo-ttft-target", "60", "--slo-itl-target", "60")
        procs.append(worker)
        for _ in range(2):
            worker.stdout.readline()
        front = _spawn("dynamo_tpu_torch.launch.run", "in=http",
                       "--http-host", "127.0.0.1", "--http-port",
                       str(http_port), "--trace-sample-rate", "1.0", *cp)
        procs.append(front)
        assert "dynamic frontend on" in front.stdout.readline()

        async def get(port, path):
            async with HttpClient("127.0.0.1", port) as c:
                r = await c.request("GET", path)
                return r.status, r.json()

        async def ask():
            async with HttpClient("127.0.0.1", http_port) as c:
                for _ in range(600):
                    r = await c.request("GET", "/v1/models")
                    if r.json()["data"]:
                        break
                    await asyncio.sleep(0.05)
                r = await c.request("POST", COMPL, json_body={
                    "model": "tiny", "max_tokens": 9,
                    "prompt": list(range(5, 40)),
                    "nvext": {"ignore_eos": True}})
                assert r.status == 200, r.json()
                rid = r.headers["X-Request-Id"]
            return rid, {
                "front": await get(http_port, f"/debug/trace/{rid}"),
                "worker": await get(sys_port, f"/debug/trace/{rid}"),
                "outliers": await get(sys_port, "/debug/outliers"),
                "dossier": await get(
                    sys_port, f"/debug/outliers/{rid}?format=perfetto"),
                "prof": await get(sys_port, "/debug/prof"),
                "flight": await get(sys_port, "/debug/flight"),
            }

        rid, got = asyncio.run(asyncio.wait_for(ask(), 120))
        assert all(st == 200 for st, _ in got.values()), got
        front_spans = [sp["name"] for sp in got["front"][1]["spans"]]
        worker_spans = [sp["name"] for sp in got["worker"][1]["spans"]]
        assert front_spans[:2] == ["tokenize", "route"], front_spans
        assert worker_spans[:2] == ["queue", "prefill"], worker_spans
        assert worker_spans.count("decode_round") == 2, worker_spans
        assert sorted(front_spans) == sorted(["tokenize", "route"]
                                             + worker_spans)
        index = got["outliers"][1]
        assert [d["request_id"] for d in index["outliers"]] == [rid]
        assert index["outliers"][0]["reason"] == "sampled"
        names = {e["name"] for e in got["dossier"][1]["traceEvents"]}
        assert {"queue", "prefill", "host_round", "round"} <= names
        assert 0.98 <= got["prof"][1]["coverage_ratio"] <= 1.02
        assert got["prof"][1]["rounds"] >= 2
        kinds = {e["kind"] for e in got["flight"][1]["events"]}
        assert {"round", "prefill"} <= kinds or \
            {"round", "prefill_batch"} <= kinds, kinds
        for p in (worker, front, procs[0]):
            p.terminate()
            out, _ = p.communicate(timeout=60)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_kv_entry_points_serve_and_record_the_event_plane(tmp_path):
    """The launcher's default --router-mode kv: cli cp, two in=endpoint
    workers and in=http --control-plane --record-kv-events as processes
    (jax, the JAX package and aiohttp unimportable): the chats answer as
    in=text does, and the recording replays into the JAX package's
    indexer with the serving workers' blocks under their instance ids."""
    from dynamo_tpu.kv_router.indexer import KvIndexer as RIndexer
    from dynamo_tpu.recorder import KvRecorder as RKvRecorder

    cp_port, http_port = _free_port(), _free_port()
    record = tmp_path / "kv.jsonl"
    tiny = ["out=torch", "--model-config", "tiny", "--cache-dtype",
            "float32", "--device", "cpu", "--model-name", "tiny"]
    procs = [_spawn("dynamo_tpu_torch.cli", "cp", "--port", str(cp_port))]
    try:
        assert "listening on 127.0.0.1:" in procs[0].stdout.readline()
        cp = ["--control-plane", f"127.0.0.1:{cp_port}"]
        workers = [_spawn("dynamo_tpu_torch.launch.run", "in=endpoint",
                          *tiny, *cp) for _ in range(2)]
        procs += workers
        ids = []
        for w in workers:
            lines = [w.stdout.readline() for _ in range(2)]
            assert "serving dynamo/backend/generate" in lines[1], lines
            ids.append(lines[1].split("instance ")[1].split()[0])
        front = _spawn("dynamo_tpu_torch.launch.run", "in=http",
                       "--http-host", "127.0.0.1", "--http-port",
                       str(http_port), "--record-kv-events", str(record),
                       *cp)
        procs.append(front)
        assert "dynamic frontend on" in front.stdout.readline()

        async def ask():
            async with HttpClient("127.0.0.1", http_port) as c:
                for _ in range(600):
                    r = await c.request("GET", "/v1/models")
                    if r.json()["data"]:
                        break
                    await asyncio.sleep(0.05)
                await asyncio.sleep(0.5)  # both instances discovered
                texts = []
                for i in range(4):
                    r = await c.request("POST", CHAT, json_body={
                        "model": "tiny", "max_tokens": 6, "messages": [
                            {"role": "user", "content": "w1 w2 w3 " * 30}]})
                    assert r.status == 200, r.json()
                    texts.append(r.json()["choices"][0]["message"]["content"])
                return texts

        texts = asyncio.run(asyncio.wait_for(ask(), 120))
        text = _spawn("dynamo_tpu_torch.launch.run", "in=text", *tiny,
                      "--prompt", "w1 w2 w3 " * 30, "--max-tokens", "6")
        out, _ = text.communicate(timeout=120)
        assert text.returncode == 0, out
        assert texts == [out.splitlines()[-1]] * 4, (texts, out)
        for p in workers:
            p.terminate()
        counts = {}
        for i, w in zip(ids, workers):
            out, _ = w.communicate(timeout=60)
            assert w.returncode == 0, out
            counts[i] = [int(line.split()[-2]) for line in out.splitlines()
                         if line.startswith("worker instance")][0]
        assert sum(counts.values()) == 4, counts
        for p in (front, procs[0]):
            p.terminate()
            out, _ = p.communicate(timeout=60)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # the launcher's page of 64 tokens: the 90-word prompt seals a block
    idx = RIndexer(64)
    assert RKvRecorder.replay(str(record), idx) > 0
    assert {w for w, hs in idx._by_worker.items() if hs} == {
        i for i, n in counts.items() if n}
