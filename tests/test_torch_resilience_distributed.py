"""The port's resilience plane through its distributed stack, on the CPU
with tiny f32 weights, held against the JAX package under the same
faults:

- a chaos kill mid-stream through a port frontend over two port workers
  migrates, greedy token-identical to the JAX package's stack under the
  same chaos spec and to an unkilled run;
- POST /drain on a worker's system server deregisters it and finishes
  its in-flight stream; a draining ``--role decode`` wrapper refuses
  before any remote prefill; SIGTERM on an in=endpoint worker drains it
  and exits 0;
- a disagg ``stall_stream`` falls back to a local prefill, counted once;
- ``kill_store`` and ``partition_store``: the sessions resync and
  serving carries on;
- ``flip_kv_bits`` on G2, ``truncate_g3`` on G3 and ``corrupt_prefetch``
  on a G4 landing each end quarantined and recomputed, token-identical to
  TpuEngine under the same fault; ``corrupt_frame`` is nacked and the
  retry lands;
- the port's scrub_kv reports a damaged G3 file (written by the port) as
  the JAX package's tools/scrub_kv.py does.

Every wait is bounded by a timeout of a few seconds; stalls are <= 1 s."""
import asyncio
import json
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu import kv_transfer as jkt
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.kv_integrity import KV_INTEGRITY as J_INTEGRITY
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.resilience.chaos import CHAOS as R_CHAOS
from dynamo_tpu.resilience.metrics import RESILIENCE as R_RES
from dynamo_tpu_torch import disagg as tdisagg
from dynamo_tpu_torch import kv_transfer as tkt
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.offload import DiskOffloadTier
from dynamo_tpu_torch.engines import EchoEngine
from dynamo_tpu_torch.frontend.http import HttpClient
from dynamo_tpu_torch.frontend.model_manager import ModelManager
from dynamo_tpu_torch.frontend.service import HttpService
from dynamo_tpu_torch.frontend.watcher import ModelEntry, ModelWatcher
from dynamo_tpu_torch.frontend.watcher import register_llm
from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY, KvIntegrityError
from dynamo_tpu_torch.kv_transfer_metrics import KV_TRANSFER
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.resilience.chaos import CHAOS
from dynamo_tpu_torch.resilience.drain import (
    DrainController,
    WorkerDrainingError,
)
from dynamo_tpu_torch.resilience.metrics import RESILIENCE
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.store import KvStore, serve_store
from dynamo_tpu_torch.runtime.system_server import SystemServer
from dynamo_tpu_torch.tools import scrub_kv
from tests.test_torch_disagg import P49, Pair, start_store
from tests.test_torch_distributed import (
    COMPL,
    ENGINE_KW,
    Stack,
    _free_port,
    _spawn,
)
from tests.test_torch_kv_integrity import (
    KW as IKW,
    PROMPT_A,
    _collect,
    _evict_to_host,
    _settle,
)
from tests.test_torch_remote_kv import KW as G4KW
from tests.test_torch_remote_kv import PROMPT as G4PROMPT
from tests.test_torch_remote_kv import serve_pool, store_and_client

ROOT = Path(__file__).resolve().parent.parent
PS = 16


@pytest.fixture(autouse=True)
def _reset_globals():
    for reg, hooks in ((RESILIENCE, CHAOS), (R_RES, R_CHAOS)):
        reg.reset()
        hooks.reset()
    yield
    for reg, hooks in ((RESILIENCE, CHAOS), (R_RES, R_CHAOS)):
        reg.reset()
        hooks.reset()


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    return jparams, jax.tree.map(np.asarray, jparams)


def torch_engine(weights, kw, **over):
    return TorchEngine(TConfig.tiny(dtype="float32"),
                       TEngineConfig(**{**kw, **over}),
                       params=params_from_jax(weights[1], device="cpu"),
                       device="cpu")


def tpu_engine(weights, kw, **over):
    return TpuEngine(JConfig.tiny(dtype="float32"),
                     JEngineConfig(**{**kw, **over}), params=weights[0],
                     mesh_config=MeshConfig(tp=1))


async def _until(pred, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.02)


# ---------------------------------------------------------------------------
# a chaos kill through the stack migrates, token-identical


KILL_BODY = {"model": "tiny", "max_tokens": 10, "temperature": 0,
             "prompt": list(range(5, 40))}


async def _stack_answer(pk, engines, spec):
    """A store, two workers on ``engines`` and a KV-routing frontend, all
    of package ``pk``; ``spec`` armed on that package's chaos hooks just
    before the request. Returns (status, text, migrations)."""
    hooks, res = (CHAOS, RESILIENCE) if pk == "port" else (R_CHAOS, R_RES)
    async with Stack(pk, pk) as s:
        for eng in engines:
            await s.add_worker(pk, eng, router_mode="kv")
        await s.wait_instances("tiny", 2)
        push = s.watcher._routers["tiny"]
        await _until(lambda: len(push.workers) == 2, "two workers")
        if spec:
            hooks.configure(spec)
        status, _, body = await s.http.call("POST", COMPL, KILL_BODY)
        injected = hooks.points["kill_worker"].injected_total
        return (status, body["choices"][0]["text"],
                body["usage"]["completion_tokens"],
                res.get("dynamo_migration_total"), injected)


@pytest.mark.asyncio_timeout(180)
async def test_chaos_kill_migrates_token_identical_to_the_jax_stack(weights):
    ports = [torch_engine(weights, ENGINE_KW) for _ in range(2)]
    ref = tpu_engine(weights, ENGINE_KW)
    spec = "kill_worker:after=3:once"
    try:
        clean = await _stack_answer("port", ports, "")
        killed = await _stack_answer("port", ports, spec)
        # the JAX stack: its engine behind two worker instances
        jax_killed = await _stack_answer("ref", [ref, ref], spec)
    finally:
        for e in ports + [ref]:
            await e.stop()
    assert clean[:4] == (200, clean[1], 10, 0) and clean[4] == 0
    assert killed == (200, clean[1], 10, 1, 1)
    assert jax_killed == killed
    assert not CHAOS.any_armed()


# ---------------------------------------------------------------------------
# graceful drain


async def _stream(port, body):
    """A streamed completion: its SSE data lines, as they come."""
    async with HttpClient("127.0.0.1", port) as c:
        r = await c.request("POST", COMPL, json_body=body, stream=True)
        assert r.status == 200
        async for chunk in r.chunks():
            yield chunk


def _stream_text(chunks):
    text, done = "", False
    for line in b"".join(chunks).decode().splitlines():
        if line == "data: [DONE]":
            done = True
        elif line.startswith("data: "):
            text += json.loads(line[6:])["choices"][0]["text"]
    return text, done


@pytest.mark.asyncio_timeout(180)
async def test_drain_over_http_deregisters_and_finishes_in_flight(weights):
    engs = [torch_engine(weights, ENGINE_KW) for _ in range(2)]
    body = {"model": "tiny", "max_tokens": 16, "temperature": 0,
            "stream": True, "prompt": list(range(50, 80))}
    sysrv = None
    try:
        async with Stack() as s:
            served = [await s.add_worker("port", e, router_mode="kv")
                      for e in engs]
            await s.wait_instances("tiny", 2)
            push = s.watcher._routers["tiny"]
            await _until(lambda: len(push.workers) == 2, "two workers")
            # the undrained stream, then both caches dropped, so the
            # drained run prefills the same way
            want = _stream_text([c async for c in _stream(
                s.http.svc.port, body)])
            for e in engs:
                await asyncio.to_thread(e.clear_kv_blocks)
            for x in served:
                x.server.handler.requests = 0
            # each output slowed, so the stream is in flight at /drain
            CHAOS.arm("delay", delay_s=0.02)
            gen = _stream(s.http.svc.port, body)
            chunks = [await asyncio.wait_for(gen.__anext__(), 30)]
            k = next(i for i, x in enumerate(served)
                     if x.server.handler.requests == 1)
            controller = DrainController(
                engs[k], on_deregister=served[k].lease.revoke,
                timeout_s=10.0, poll_s=0.01)
            sysrv = await SystemServer(
                engs[k], host="127.0.0.1", port=0,
                worker_id=str(served[k].lease_id), drain=controller).start()
            async with HttpClient("127.0.0.1", sysrv.port) as c:
                r = await c.request("POST", "/drain")
                assert r.status == 200 and r.json()["state"] == "draining"
                chunks += [c async for c in gen]     # finishes whole
                assert _stream_text(chunks) == want
                assert want[1] and len(want[0].split()) == 16
                await asyncio.wait_for(controller.wait_drained(), 10)
                assert (await c.request("GET", "/drain")).json()[
                    "state"] == "drained"
            CHAOS.disarm_all()
            # deregistered: the frontend routes to the survivor only
            await _until(lambda: list(push.workers) == [
                str(served[1 - k].lease_id)], "the drained worker left")
            for i in range(3):
                status, _, out = await s.http.call("POST", COMPL, {
                    "model": "tiny", "max_tokens": 4,
                    "prompt": list(range(90 + i, 110))})
                assert status == 200, out
            assert served[k].server.handler.requests == 1
            with pytest.raises(WorkerDrainingError):
                await _collect(engs[k], tproto, [1, 2, 3], 2)
            assert engs[k].drained()
            assert RESILIENCE.get("dynamo_resilience_drains_total") == 1
            assert RESILIENCE.get("dynamo_resilience_draining") == 0
    finally:
        if sysrv is not None:
            await sysrv.stop()
        for e in engs:
            await e.stop()


async def test_draining_decode_wrapper_refuses_before_remote_prefill(
        weights):
    """rt=None: any touch of the control plane on the refusal path would
    raise AttributeError instead of WorkerDrainingError."""
    inner = torch_engine(weights, ENGINE_KW)
    eng = tdisagg.DisaggDecodeEngine(inner, rt=None)
    assert not eng.drained() or not inner._started
    eng.begin_drain()
    with pytest.raises(WorkerDrainingError):
        await _collect(eng, tproto, P49, 4)
    assert eng.drained() and inner._draining
    assert eng.remote_prefills == eng.local_prefills == 0
    await inner.stop()


def test_sigterm_drains_an_endpoint_worker_and_exits_zero():
    cp_port = _free_port()
    procs = [_spawn("dynamo_tpu_torch.cli", "cp", "--port", str(cp_port))]
    try:
        assert "listening on 127.0.0.1:" in procs[0].stdout.readline()
        w = _spawn("dynamo_tpu_torch.launch.run", "in=endpoint", "out=torch",
                   "--model-config", "tiny", "--cache-dtype", "float32",
                   "--device", "cpu", "--model-name", "tiny",
                   "--control-plane", f"127.0.0.1:{cp_port}",
                   "--system-port", "0", "--drain-timeout", "5",
                   "--chaos", "delay:t=0.001")
        procs.append(w)
        lines = [w.stdout.readline()]
        while "serving dynamo/backend/generate" not in lines[-1]:
            assert len(lines) < 8 and lines[-1], lines
            lines.append(w.stdout.readline())
        # the --chaos spec is armed (and logged) before anything starts
        assert lines[0].startswith("chaos point armed:"), lines
        assert "TorchEngine on cpu" in lines[1], lines
        sys_line = next(x for x in lines if x.startswith("system server"))
        sys_port = int(sys_line.strip().rsplit(":", 1)[1])

        async def probe():
            async with HttpClient("127.0.0.1", sys_port) as c:
                health = await c.request("GET", "/health")
                chaos = await c.request("GET", "/chaos")
            armed = [p["name"] for p in chaos.json()["points"]
                     if p["armed"]]
            return health.status, armed

        assert asyncio.run(asyncio.wait_for(probe(), 30)) == (200, ["delay"])
        w.send_signal(signal.SIGTERM)
        out, _ = w.communicate(timeout=60)
        assert w.returncode == 0, out
        assert "drained; shutting down" in out, out
        assert "served 0 requests" in out, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


# ---------------------------------------------------------------------------
# disagg: a stalled chunk push falls back to a local prefill


@pytest.mark.asyncio_timeout(120)
async def test_disagg_stall_stream_falls_back_locally_once(weights):
    prompt = list(range(1, 114))             # 7 full blocks
    from tests.test_torch_disagg import port_engine

    ref = await _collect(port_engine(weights, "solo"), tproto, prompt, 10)
    server, port = await start_store()
    pair = await Pair.up(weights, port, timeout_s=0.3, chunk_pages=2,
                         wid="dst", pwid="pst")
    fb0 = KV_TRANSFER.get("dynamo_disagg_fallback_total")
    try:
        # the push stalls 1 s after its first chunk: past the 0.3 s
        # timeout of the decode side
        CHAOS.arm("stall_stream", delay_s=1.0, after_outputs=1, once=True)
        assert await pair.generate(prompt) == ref
        assert (pair.decode.remote_fallbacks, pair.decode.remote_prefills,
                pair.decode.local_prefills) == (1, 0, 1)
        assert KV_TRANSFER.get("dynamo_disagg_fallback_total") == fb0 + 1
        assert CHAOS.points["stall_stream"].injected_total == 1
        # the stalled job's late writes are refused: it fails at commit
        await _until(lambda: pair.pworker.jobs_failed
                     + pair.pworker.jobs_handled >= 1, "the stalled job",
                     timeout=10)
        assert (pair.pworker.jobs_failed, pair.pworker.jobs_handled) == (1, 0)
        # and the pair serves remotely again
        assert len(await pair.generate(list(range(140, 200)))) == 10
        assert pair.decode.remote_prefills == 1
    finally:
        await pair.down()
        server.close()


# ---------------------------------------------------------------------------
# the store as the fault domain


@pytest.mark.asyncio_timeout(120)
async def test_kill_store_and_partition_store_sessions_resync(tmp_path):
    jp = str(tmp_path / "store.wal")
    server, _ = await serve_store("127.0.0.1", 0, sweep_interval_s=0.05,
                                  store=KvStore(journal_path=jp))
    port = server.sockets[0].getsockname()[1]
    wrt = await DistributedRuntime.connect(port=port, resync=True)
    frt = await DistributedRuntime.connect(port=port, resync=True)
    served = await register_llm(wrt, EchoEngine(), ModelEntry(
        name="echo", namespace="res", component="backend", block_size=PS,
        router_mode="round_robin"), lease_ttl_s=10.0)
    manager = ModelManager()
    watcher = await ModelWatcher(frt, manager, namespace="res").start()
    svc = HttpService(manager, host="127.0.0.1", port=0)
    await svc.start()
    server2 = None

    async def ask():
        async with HttpClient("127.0.0.1", svc.port) as c:
            r = await c.request("POST", COMPL, json_body={
                "model": "echo", "prompt": "w1 w2 w3", "max_tokens": 3})
        return r.status

    try:
        await _until(lambda: manager.list_models() == ["echo"], "discovery")
        assert await ask() == 200
        # partition: one reply held 0.5 s, the connection stays up
        CHAOS.arm("partition_store", delay_s=0.5, once=True)
        t0 = time.monotonic()
        assert await wrt.kv.get("nothing") is None
        assert time.monotonic() - t0 >= 0.5 - 0.05
        assert CHAOS.points["partition_store"].injected_total == 1
        assert await ask() == 200
        # kill: the next op crashes the store (every connection RST)
        CHAOS.arm("kill_store", once=True)
        try:
            await wrt.kv.get("nothing")
        except (ConnectionError, OSError):
            pass
        await _until(lambda: wrt.kv.degraded and frt.kv.degraded,
                     "both sessions degraded")
        assert CHAOS.points["kill_store"].injected_total == 1
        # last-known state serves through the outage
        assert await ask() == 200
        server2, _ = await serve_store("127.0.0.1", port,
                                       sweep_interval_s=0.05,
                                       store=KvStore(journal_path=jp))
        await _until(lambda: not wrt.kv.degraded and not frt.kv.degraded
                     and wrt.kv.resyncs >= 1 and frt.kv.resyncs >= 1,
                     "both sessions resynced")
        assert await ask() == 200
        assert manager.list_models() == ["echo"]
        assert not served.lease.lost.is_set()
    finally:
        await svc.stop()
        await watcher.stop()
        await served.shutdown()
        await wrt.close()
        await frt.close()
        server.close()
        if server2 is not None:
            server2.close()


# ---------------------------------------------------------------------------
# data-integrity faults: quarantine and recompute, as TpuEngine does


async def _tier_fault_run(eng, proto, registry, hooks, point, **arm):
    toks, hashes = await _evict_to_host(eng, proto)
    where = [(h in eng.offload._index, eng.offload.spill is not None
              and h in eng.offload.spill) for h in hashes]
    hooks.rng = random.Random(3)
    hooks.arm(point, **arm)
    before = registry.snapshot()
    toks.append(await _collect(eng, proto, PROMPT_A))
    after = registry.snapshot()
    await _settle(eng)
    delta = {k: after[k] - before[k] for k in (
        "dynamo_kv_integrity_failed_total",
        "dynamo_kv_integrity_quarantined_total",
        "dynamo_kv_integrity_recomputed_total")}
    state = ([h in eng.kv_quarantine for h in hashes], where,
             hooks.points[point].injected_total)
    await eng.stop()
    return toks, delta, state


@pytest.mark.parametrize("point,kw,arm", [
    ("flip_kv_bits", {}, dict(once=True)),
    ("truncate_g3", dict(host_offload_pages=2, disk_offload_pages=16),
     dict(once=True)),
])
@pytest.mark.asyncio_timeout(180)
async def test_tier_fault_quarantined_and_recomputed_as_tpu_engine(
        weights, point, kw, arm):
    t = await _tier_fault_run(torch_engine(weights, IKW, **kw), tproto,
                              KV_INTEGRITY, CHAOS, point, **arm)
    j = await _tier_fault_run(tpu_engine(weights, IKW, **kw), jproto,
                              J_INTEGRITY, R_CHAOS, point, **arm)
    assert t == j
    clean = t[0][0]
    assert t[0][-1] == clean                  # recomputed, not served rotten
    assert t[2][2] == 1, t[2]                 # fired once
    assert t[1]["dynamo_kv_integrity_failed_total"] >= 1
    assert t[1]["dynamo_kv_integrity_quarantined_total"] >= 1
    assert t[1]["dynamo_kv_integrity_recomputed_total"] >= 1
    assert any(t[2][0])


async def _g4_fault_run(cold, proto, kt, registry, hooks, warm_kv):
    """A cold worker fetches PROMPT's prefix from the warm pool with
    ``corrupt_prefetch`` armed once: the rotted landed page is caught at
    onboard, quarantined and recomputed."""
    kv, ns = warm_kv
    cold.remote_kv = kt.RemoteKvFetcher(kv, ns, "cold", chunk_pages=0)
    hooks.rng = random.Random(3)
    hooks.arm("corrupt_prefetch", once=True)
    before = registry.snapshot()
    try:
        toks = await _collect(cold, proto, G4PROMPT)
    finally:
        await cold.stop()
    after = registry.snapshot()
    delta = {k: after[k] - before[k] for k in (
        "dynamo_kv_integrity_failed_total",
        "dynamo_kv_integrity_quarantined_total")}
    return (toks, delta, hooks.points["corrupt_prefetch"].injected_total,
            cold.remote_onboard_blocks, len(cold.kv_quarantine))


@pytest.mark.asyncio_timeout(180)
async def test_corrupt_prefetch_on_a_g4_landing_as_tpu_engine(weights):
    server, kv = await store_and_client()
    warm = torch_engine(weights, G4KW)
    srv = None
    try:
        want = await _collect(warm, tproto, G4PROMPT)
        srv = await serve_pool(tkt, warm, kv, "g4c", "warm")
        t = await _g4_fault_run(
            torch_engine(weights, G4KW, host_offload_pages=16), tproto,
            tkt, KV_INTEGRITY, CHAOS, (kv, "g4c"))
        # the JAX package's cold engine fetches from the same port pool
        from dynamo_tpu.runtime.client import KvClient as JKvClient

        jkv = await JKvClient(port=server.sockets[0].getsockname()[1]
                              ).connect()
        try:
            j = await _g4_fault_run(
                tpu_engine(weights, G4KW, host_offload_pages=16), jproto,
                jkt, J_INTEGRITY, R_CHAOS, (jkv, "g4c"))
        finally:
            await jkv.close()
    finally:
        if srv is not None:
            await srv.stop()
        await warm.stop()
        await kv.close()
        server.close()
    assert t == j
    assert t[0] == want
    assert t[1] == {"dynamo_kv_integrity_failed_total": 1,
                    "dynamo_kv_integrity_quarantined_total": 1}
    assert t[2:] == (1, 3, 1)


async def test_corrupt_frame_is_nacked_and_the_retry_lands():
    store = {}

    def write_fn(pages, data, job=None):
        store[tuple(pages)] = data.clone()

    srv = tkt.BlockTransferServer(read_fn=lambda p: store[tuple(p)],
                                  write_fn=write_fn)
    host, port = await srv.start()
    pages = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 2, 2, 2, PS, 8)).astype(np.float32))
    clean = pages.clone()
    try:
        before = KV_INTEGRITY.get("dynamo_kv_integrity_retries_total")
        CHAOS.arm("corrupt_frame", once=True)
        await tkt.write_remote_pages(host, port, [0, 1], pages)
        assert torch.equal(store[(0, 1)], clean)    # the retry landed clean
        assert torch.equal(pages, clean)            # the sender's untouched
        assert KV_INTEGRITY.get("dynamo_kv_integrity_retries_total") == \
            before + 1
        assert CHAOS.points["corrupt_frame"].injected_total == 1
        # persistent corruption: the retry fails too, nothing is scattered
        CHAOS.arm("corrupt_frame")
        with pytest.raises(KvIntegrityError):
            await tkt.write_remote_pages(host, port, [2, 3], pages)
        assert (2, 3) not in store
        CHAOS.disarm_all()
        # a stream: the corrupted chunk is refused, the stream replays
        CHAOS.arm("corrupt_frame", once=True)
        assert await tkt.write_pages_stream(host, port, [
            ([4, 5], pages), ([6, 7], pages)]) == 2
        assert torch.equal(store[(4, 5)], clean)
        assert torch.equal(store[(6, 7)], clean)
    finally:
        await srv.stop()


# ---------------------------------------------------------------------------
# the offline G3 scrub, against the JAX package's tool


def _scrub_corpus(tmp_path, weights):
    """A G3 file and manifest written by the port's engine (f32 pages),
    then damaged: one page's first value changed and a torn manifest
    line."""
    path = str(tmp_path / "g3.mmap")
    eng = torch_engine(weights, IKW, host_offload_pages=2,
                       disk_offload_pages=16, disk_offload_path=path)

    async def fill():
        await _evict_to_host(eng, tproto)
        await eng.stop()

    asyncio.run(fill())
    meta, live, torn = DiskOffloadTier.load_manifest(path + ".manifest")
    assert len(live) >= 3 and torn == 0
    slot = next(iter(live.values()))[0]
    pool_shape = (2, meta["page_shape"][1], meta["page_shape"][2],
                  meta["num_pages"], meta["page_shape"][3],
                  meta["page_shape"][4])
    mm = np.memmap(path, dtype=np.float32, mode="r+", shape=pool_shape)
    mm[0, 0, 0, slot, 0, 0] = -mm[0, 0, 0, slot, 0, 0] - 1.0
    mm.flush()
    del mm
    with open(path + ".manifest", "a") as f:
        f.write('{"put": 77, "sl')
    return path


def test_scrub_kv_reports_as_the_reference_tool(tmp_path, weights):
    path = _scrub_corpus(tmp_path, weights)
    ref = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "scrub_kv.py"), path,
         "--json"], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    port = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.tools.scrub_kv", path,
         "--json"], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert ref.returncode == port.returncode == 1, (ref.stderr, port.stderr)
    want, got = json.loads(ref.stdout), json.loads(port.stdout)
    assert got == want
    assert got["corrupt"] == 1 and got["orphaned"] == 1
    assert got["verified"] == got["entries"] - 1
    # the plain report and the other exit codes, in process
    assert scrub_kv.main([path + ".missing"]) == 2
    os.unlink(path + ".manifest")
    assert scrub_kv.main([path]) == 2
