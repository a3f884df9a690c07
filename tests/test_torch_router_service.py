"""The port's recorder (dynamo_tpu_torch/recorder.py) and standalone
router service (router_service.py, ``cli router``) against the JAX
package's, on the CPU: recordings are byte-equal and replay into either
package's indexer to the same state, and the two packages' RouterService,
fed the same KV events on one store and seeded alike, answer find_best
identically."""
import asyncio
import json
import os
import random
import signal
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from dynamo_tpu.kv_router.indexer import KvIndexer as RIndexer
from dynamo_tpu.kv_router.scheduler import KvRouterConfig as RConfig
from dynamo_tpu.mocker import MockerArgs, MockerEngine
from dynamo_tpu.protocols.common import PreprocessedRequest as RRequest
from dynamo_tpu.protocols.common import StopConditions as RStop
from dynamo_tpu.recorder import KvRecorder as RKvRecorder
from dynamo_tpu.recorder import Recorder as RRecorder
from dynamo_tpu.router_service import RouterService as RRouterService
from dynamo_tpu.runtime.component import DistributedRuntime as RRuntime
from dynamo_tpu_torch.engines import EchoEngine
from dynamo_tpu_torch.kv_router.indexer import KvIndexer as PIndexer
from dynamo_tpu_torch.kv_router.protocols import (
    KvCacheEvent,
    KvEventKind,
    StoredBlock,
)
from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig as PConfig
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.protocols.common import StopConditions
from dynamo_tpu_torch.recorder import KvRecorder as PKvRecorder
from dynamo_tpu_torch.recorder import Recorder as PRecorder
from dynamo_tpu_torch.router_service import RouterService as PRouterService
from dynamo_tpu_torch.runtime.component import DistributedRuntime as PRuntime
from dynamo_tpu_torch.runtime.publisher import KV_EVENTS_TOPIC
from dynamo_tpu_torch.runtime.remote_engine import serve_engine
from dynamo_tpu_torch.runtime.store import serve_store
from dynamo_tpu_torch.tokens import compute_block_hashes

ROOT = Path(__file__).resolve().parent.parent
BS = 4
RECORDER = {"port": PRecorder, "ref": RRecorder}


# ---------------------------------------------------------------------------
# recorder


@pytest.mark.parametrize("pk", ["port", "ref"])
def test_recordings_are_byte_equal_and_rotate_alike(tmp_path, pk):
    """Both packages record the same events into byte-equal files (a
    fixed clock), rotating alike; each reads the other's."""
    files = {}
    for side in ("port", "ref"):
        path = str(tmp_path / side / "ev.jsonl")
        rec = RECORDER[side](path, max_lines=3, max_files=3,
                             clock=lambda: 1234.5)
        for i in range(8):
            rec.record({"i": i, "kind": "stored"})
        rec.close()
        files[side] = [Path(path + sfx).read_bytes()
                       for sfx in ("", ".1", ".2")]
    assert files["port"] == files["ref"]
    other = "ref" if pk == "port" else "port"
    path = str(tmp_path / other / "ev.jsonl")
    reader = RECORDER[pk]
    assert [e["i"] for _, e in reader.iter_events(path)] == [6, 7]
    assert [e["i"] for _, e in reader.iter_events(path + ".1")] == [3, 4, 5]
    assert [e["i"] for _, e in reader.iter_events(path + ".2")] == [0, 1, 2]
    assert {ts for ts, _ in reader.iter_events(path)} == {1234.5}


@pytest.mark.parametrize("pk", ["port", "ref"])
def test_recorder_skips_corrupt_lines_and_continues_a_file(tmp_path, pk):
    path = str(tmp_path / "ev.jsonl")
    rec = RECORDER[pk](path, max_lines=4)
    rec.record({"ok": 1})
    rec.close()
    with open(path, "a") as f:
        f.write("not json at all\n")
    rec2 = RECORDER[pk](path, max_lines=4)
    rec2.record({"ok": 2})
    rec2.record({"ok": 3})  # the continued file's 4th line: rotates
    rec2.close()
    assert [e for _, e in RECORDER[pk].iter_events(path + ".1")] == [
        {"ok": 1}, {"ok": 2}, {"ok": 3}]
    assert not os.path.exists(path)


def _index_state(idx, queries):
    return ({w: sorted(hs) for w, hs in idx._by_worker.items()},
            [idx.find_matches(compute_block_hashes(q, BS)).scores
             for q in queries])


PROMPTS = [list(range(1, 30)), list(range(1, 18)) + [99, 98],
           list(range(50, 75))]
QUERIES = PROMPTS + [list(range(1, 12)), list(range(60, 80))]


async def test_port_recording_of_a_torch_engine_replays_into_both(tmp_path):
    """The KV events of a live TorchEngine run, recorded by the port's
    KvRecorder, rebuild the live indexer's state in both packages'
    indexers."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig

    path = str(tmp_path / "kv.jsonl")
    recorder = PKvRecorder(path)
    live = PIndexer(BS)

    def tee(ev):
        recorder(ev)
        live.apply_event(ev)

    eng = TorchEngine(ModelConfig.tiny(dtype="float32"), EngineConfig(
        num_pages=16, page_size=BS, max_pages_per_seq=16,
        max_decode_slots=2, prefill_buckets=(32, 64),
        cache_dtype="float32"), device="cpu")
    eng.allocator.worker_id = "w0"
    eng.allocator.on_event = tee  # one engine thread: calls in order
    try:
        for p in PROMPTS:
            async for _ in eng.generate(PreprocessedRequest(
                    token_ids=list(p), stop_conditions=StopConditions(
                        max_tokens=6, ignore_eos=True))):
                pass
    finally:
        await eng.stop()
    recorder.close()
    n = recorder.recorder.recorded
    assert n > 0
    want = _index_state(live, QUERIES)
    assert want[0]["w0"] and any(want[1])
    for Indexer, Rec in ((PIndexer, PKvRecorder), (RIndexer, RKvRecorder)):
        idx = Indexer(BS)
        assert Rec.replay(path, idx) == n
        assert _index_state(idx, QUERIES) == want


async def test_reference_recording_replays_into_the_port(tmp_path):
    path = str(tmp_path / "kv.jsonl")
    recorder = RKvRecorder(path)
    live = RIndexer(BS)

    def tee(ev):
        recorder(ev)
        live.apply_event(ev)

    eng = MockerEngine(MockerArgs(speedup_ratio=100.0, page_size=BS,
                                  num_pages=12, worker_id="m0"),
                       on_kv_event=tee)
    for p in PROMPTS:
        async for _ in eng.generate(RRequest(
                token_ids=list(p), stop_conditions=RStop(
                    max_tokens=6, ignore_eos=True))):
            pass
    await eng.stop()
    recorder.close()
    want = _index_state(live, QUERIES)
    port = PIndexer(BS)
    assert PKvRecorder.replay(path, port) == recorder.recorder.recorded
    assert _index_state(port, QUERIES) == want


# ---------------------------------------------------------------------------
# router service


async def _wait(pred, what, timeout=20.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.02)


async def test_router_services_answer_find_best_alike():
    """Three workers on one port store; the port's and the JAX package's
    RouterService watch them, follow the same KV events and, seeded
    alike at temperature 0.5, answer the same find_best requests (sent
    over the endpoint wire to each service's instance) identically."""
    server, _ = await serve_store(port=0, sweep_interval_s=0.05)
    port = server.sockets[0].getsockname()[1]
    rts, served = [], []
    svcs = {}
    client_rt = await PRuntime.connect(port=port)
    try:
        for i in range(3):
            rt = await PRuntime.connect(port=port)
            ep = rt.namespace("rs").component("backend").endpoint(
                "generate")
            served.append(await serve_engine(ep, EchoEngine(delay_s=0.0),
                                             worker_id=f"w{i}"))
            rts.append(rt)
        wids = [str(s.lease_id) for s in served]
        for pk, Rt, Svc, Cfg in (("port", PRuntime, PRouterService, PConfig),
                                 ("ref", RRuntime, RRouterService, RConfig)):
            rt = await Rt.connect(port=port)
            rts.append(rt)
            svc = await Svc(rt, namespace="rs", component="backend",
                            endpoint="generate", block_size=BS,
                            router_config=Cfg(router_temperature=0.5),
                            worker_id=f"router-{pk}").start()
            svc.router.scheduler.selector.rng = random.Random(5)
            svcs[pk] = svc
        for svc in svcs.values():
            await _wait(lambda svc=svc: len(svc.router.sequences._workers)
                        == 3, "fleet")
        # KV events: worker i holds the first i + 1 blocks of a family
        families = [list(range(10 * f + 3, 10 * f + 27)) for f in range(4)]
        total = set()
        for f, fam in enumerate(families):
            hs = compute_block_hashes(fam, BS)
            for i, wid in enumerate(wids):
                keep = hs[:(i + f) % len(hs) + 1]
                total.update(keep)
                ev = KvCacheEvent(kind=KvEventKind.STORED, worker_id=wid,
                                  blocks=[StoredBlock(block_hash=h)
                                          for h in keep])
                await client_rt.kv.publish(f"{KV_EVENTS_TOPIC}.{wid}",
                                           json.dumps(ev.to_dict()))
        for svc in svcs.values():
            await _wait(lambda svc=svc: svc.router.indexer.total_blocks()
                        == len(total), "events")
        client = await client_rt.namespace("rs").component(
            "backend-router").endpoint("find_best").client()
        await client.wait_for_instances(2)
        iids = {pk: svc._served.lease_id for pk, svc in svcs.items()}

        async def ask(pk, payload):
            async for item in client.generate(payload, mode="direct",
                                              instance_id=iids[pk]):
                return item

        rng = random.Random(0)
        answers = {"port": [], "ref": []}
        for r in range(60):
            fam = families[rng.randrange(4)]
            toks = fam[:rng.randrange(4, len(fam))] + [rng.randrange(3, 99)]
            for pk in ("port", "ref"):
                answers[pk].append(await ask(pk, {
                    "token_ids": toks, "request_id": f"q{r}"}))
            if r % 3 == 0:
                for pk in ("port", "ref"):
                    assert await ask(pk, {"op": "free",
                                          "request_id": f"q{r}"}) == {
                        "freed": f"q{r}"}
        assert answers["port"] == answers["ref"]
        got = [a["worker_id"] for a in answers["port"]]
        assert set(got) == set(wids)
        assert any(a["overlap_blocks"] for a in answers["port"])
        assert svcs["port"].requests_routed == 60
        assert (svcs["port"].router.sequences.active_blocks()
                == svcs["ref"].router.sequences.active_blocks())
        # a departed worker's blocks leave both indexers
        await served[0].shutdown()
        for svc in svcs.values():
            await _wait(lambda svc=svc: wids[0]
                        not in svc.router.indexer._by_worker, "departure")
    finally:
        for svc in svcs.values():
            await svc.stop()
        for s in served:
            await s.shutdown()
        for rt in rts + [client_rt]:
            await rt.close()
        server.close()


async def test_router_service_sweeps_unfreed_requests():
    server, _ = await serve_store(port=0, sweep_interval_s=0.05)
    port = server.sockets[0].getsockname()[1]
    rt = await PRuntime.connect(port=port)
    w_rt = await PRuntime.connect(port=port)
    served = await serve_engine(
        w_rt.namespace("rs2").component("backend").endpoint("generate"),
        EchoEngine(delay_s=0.0), worker_id="w")
    svc = await PRouterService(rt, namespace="rs2", block_size=BS,
                               request_ttl_s=0.2).start()
    try:
        await _wait(lambda: len(svc.router.sequences._workers) == 1,
                    "fleet")
        out = [x async for x in svc._handle({"token_ids": list(range(1, 11)),
                                             "request_id": "a"})]
        assert out == [{"worker_id": str(served.lease_id),
                        "overlap_blocks": 0, "request_id": "a"}]
        assert svc.router.sequences.active_blocks() == {
            str(served.lease_id): 3}
        await _wait(lambda: not svc._routed, "sweep", timeout=5.0)
        assert svc.router.sequences.active_blocks() == {
            str(served.lease_id): 0}
    finally:
        await svc.stop()
        await served.shutdown()
        await rt.close()
        await w_rt.close()
        server.close()


# ---------------------------------------------------------------------------
# cli router


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DYNTPU_")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_cli_router_help():
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.cli", "router", "--help"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    for flag in ("--control-plane", "--namespace", "--component",
                 "--endpoint-name", "--block-size", "--router-temperature"):
        assert flag in out.stdout


def test_cli_router_serves_find_best_and_stops_on_sigterm():
    """``cli cp`` and ``cli router`` as processes, a worker in this one:
    the router answers find_best with the worker's instance and exits 0
    on SIGTERM."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        cp_port = s.getsockname()[1]
    procs = []
    try:
        cp = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli", "cp", "--port",
             str(cp_port)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            text=True)
        procs.append(cp)
        assert "listening" in cp.stdout.readline()
        router = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli", "router",
             "--control-plane", f"127.0.0.1:{cp_port}", "--namespace",
             "cr", "--block-size", str(BS)], cwd=ROOT, env=_env(),
            stdout=subprocess.PIPE, text=True)
        procs.append(router)
        assert "router serving cr/backend-router/find_best" in \
            router.stdout.readline()

        async def drive():
            rt = await PRuntime.connect(port=cp_port)
            served = await serve_engine(
                rt.namespace("cr").component("backend").endpoint(
                    "generate"), EchoEngine(delay_s=0.0), worker_id="w")
            try:
                client = await rt.namespace("cr").component(
                    "backend-router").endpoint("find_best").client()
                await client.wait_for_instances(1)
                for _ in range(200):
                    try:
                        async for item in client.generate(
                                {"token_ids": list(range(1, 9)),
                                 "request_id": "x"}):
                            return item
                    except RuntimeError:
                        # NoEndpoints until the router sees the worker
                        await asyncio.sleep(0.05)
                raise AssertionError("the router never saw the worker")
            finally:
                await served.shutdown()
                await rt.close()

        got = asyncio.run(asyncio.wait_for(drive(), 60))
        assert got["overlap_blocks"] == 0 and got["request_id"] == "x"
        assert got["worker_id"].isdigit()
        router.send_signal(signal.SIGTERM)
        assert router.wait(timeout=30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                p.wait(timeout=30)
