"""The port's resilience plane (dynamo_tpu_torch/resilience/ and
runtime/system_server.py) held against the JAX package's, on the CPU.

For the same inputs and the same ``random.Random`` seed, the port's chaos
hooks fire on the same calls and corrupt the same bytes as the JAX
package's (torch tensors against numpy arrays, f32, bf16 and int8); the
configure grammar, the stream wrapper's kill/drop/stall/delay/storm, the
drain controller and the health tracker's TTL and remote-open state give
the same observables in both packages; breaker trips cross frontends
through a store, across the packages too; and the system server answers
/chaos, /drain, /health and /metrics over the port's HTTP client with the
JAX package's bodies and codes."""
import asyncio
import json
import random
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.resilience import chaos as rchaos
from dynamo_tpu.resilience import drain as rdrain
from dynamo_tpu.resilience import health as rhealth
from dynamo_tpu.resilience import shared as rshared
from dynamo_tpu.resilience.metrics import RESILIENCE as R_RES
from dynamo_tpu.runtime.client import KvClient as RKvClient
from dynamo_tpu.runtime.store import serve_store as r_serve_store
from dynamo_tpu_torch.frontend.http import HttpClient
from dynamo_tpu_torch.frontend.model_manager import ModelManager
from dynamo_tpu_torch.frontend.watcher import ModelWatcher
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics, KvStats
from dynamo_tpu_torch.resilience import chaos as pchaos
from dynamo_tpu_torch.resilience import drain as pdrain
from dynamo_tpu_torch.resilience import health as phealth
from dynamo_tpu_torch.resilience import shared as pshared
from dynamo_tpu_torch.resilience.metrics import RESILIENCE as P_RES
from dynamo_tpu_torch.runtime.client import KvClient as PKvClient
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.store import serve_store as p_serve_store
from dynamo_tpu_torch.runtime.system_server import SystemServer
from dynamo_tpu_torch.tools import chaos as chaos_tool

PK = {
    "port": dict(chaos=pchaos, drain=pdrain, health=phealth, shared=pshared,
                 RESILIENCE=P_RES, serve_store=p_serve_store,
                 KvClient=PKvClient),
    "ref": dict(chaos=rchaos, drain=rdrain, health=rhealth, shared=rshared,
                RESILIENCE=R_RES, serve_store=r_serve_store,
                KvClient=RKvClient),
}
BOTH = pytest.mark.parametrize("pk", ["port", "ref"])


@pytest.fixture(autouse=True)
def _reset_globals():
    for m in PK.values():
        m["RESILIENCE"].reset()
        m["chaos"].CHAOS.reset()
    yield
    for m in PK.values():
        m["RESILIENCE"].reset()
        m["chaos"].CHAOS.reset()


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def test_point_names_are_the_references():
    assert pchaos.POINT_NAMES == rchaos.POINT_NAMES
    assert len(pchaos.POINT_NAMES) == 11
    assert "corrupt_prefetch" in pchaos.POINT_NAMES
    assert [p["name"] for p in pchaos.CHAOS.list_points()] == \
        list(rchaos.POINT_NAMES)


def test_resilience_families_are_the_references():
    assert P_RES._families == R_RES._families
    text = P_RES.render()
    for name in ("dynamo_resilience_chaos_injections_total",
                 "dynamo_resilience_draining",
                 "dynamo_resilience_drains_total"):
        assert f"# TYPE {name} " in text


SPECS = [
    "kill_worker:p=0.5:after=3,delay:t=0.05,stall_stream:t=2:once",
    "flip_kv_bits:p=0.5,corrupt_frame:once,truncate_g3",
    " , corrupt_prefetch:once=false , storm:t=2:once=yes,",
    "kill_store,partition_store:t=0.5:once=1",
    "explode",
    "delay:t=0.1,kill_worker:speed=3",
    "kill_worker:p=abc",
    "",
]


@pytest.mark.parametrize("spec", SPECS)
def test_configure_grammar_matches_reference(spec):
    def run(mod):
        hooks = mod.ChaosHooks()
        try:
            hooks.configure(spec)
            err = None
        except ValueError as e:
            err = str(e)
        return err, hooks.list_points(), hooks.any_armed()

    assert run(pchaos) == run(rchaos)


# ---------------------------------------------------------------------------
# byte-level corruption: the same draws, the same bytes


NP_DTYPES = {"float32": (np.float32, torch.float32),
             "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
             "int8": (np.int8, torch.int8)}
BATCH = (2, 2, 2, 5, 4, 8)   # [2, L, kvh, n, ps, hd]


def _batch(dt, seed):
    rng = np.random.default_rng(seed)
    if dt == "int8":
        return rng.integers(-128, 128, BATCH).astype(np.int8)
    return rng.standard_normal(BATCH).astype(NP_DTYPES[dt][0])


def _as_torch(a: np.ndarray, layout: str) -> torch.Tensor:
    """The same logical tensor in one of three memory layouts: dense;
    page-major ([n, 2, L, kvh, ps, hd] permuted to page axis 3, as the
    tiers' gather returns it); and with the last two axes swapped in
    memory (a last-axis stride other than 1)."""
    raw = torch.from_numpy(a.view(np.int16) if a.dtype == ml_dtypes.bfloat16
                           else a.copy())
    t = raw.view(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16 else raw
    if layout == "page_major":
        return t.permute(3, 0, 1, 2, 4, 5).contiguous().permute(
            1, 2, 3, 0, 4, 5)
    if layout == "transposed":
        return t.transpose(-1, -2).contiguous().transpose(-1, -2)
    return t.clone()


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("dt", sorted(NP_DTYPES))
@pytest.mark.parametrize("layout", ["dense", "page_major", "transposed"])
@pytest.mark.parametrize("p", [1.0, 0.5])
def test_flip_bits_flips_the_references_bytes(dt, layout, p):
    a = _batch(dt, seed=3)
    t = _as_torch(a, layout)
    assert _bytes(t) == a.tobytes()
    got = {}
    for pk, arr in (("port", t), ("ref", a)):
        hooks = PK[pk]["chaos"].ChaosHooks(rng=random.Random(11))
        hooks.arm("flip_kv_bits", probability=p)
        n = hooks.maybe_flip_bits(arr)
        got[pk] = (n, hooks.points["flip_kv_bits"].injected_total,
                   hooks.rng.random())
    assert got["port"] == got["ref"]
    assert got["port"][0] == (5 if p == 1.0 else got["port"][0]) >= 1
    assert _bytes(t) == a.tobytes()
    flipped = np.frombuffer(_bytes(t), np.uint8) != np.frombuffer(
        _as_torch(_batch(dt, seed=3), "dense").contiguous().view(
            torch.uint8).numpy().tobytes(), np.uint8)
    assert int(flipped.sum()) == got["port"][0]


def test_flip_bits_unarmed_or_once_touches_nothing_more():
    a = _batch("float32", seed=4)
    t = _as_torch(a, "dense")
    for mod, arr in ((pchaos, t), (rchaos, a)):
        hooks = mod.ChaosHooks(rng=random.Random(2))
        assert hooks.maybe_flip_bits(arr) == 0
        hooks.arm("flip_kv_bits", once=True)
        assert hooks.maybe_flip_bits(arr) == 1
        assert not hooks.points["flip_kv_bits"].armed
        assert hooks.maybe_flip_bits(arr) == 0
    assert _bytes(t) == a.tobytes()


@pytest.mark.parametrize("dt", sorted(NP_DTYPES))
def test_corrupt_frame_corrupts_a_copy_as_the_reference(dt):
    a = _batch(dt, seed=5)
    t = _as_torch(a, "dense")
    clean = _bytes(t)
    out = {}
    for pk, arr in (("port", t), ("ref", a)):
        hooks = PK[pk]["chaos"].ChaosHooks(rng=random.Random(7))
        hooks.arm("corrupt_frame", once=True)
        dirty = hooks.maybe_corrupt_frame(arr)
        assert dirty is not arr
        # the once-fuse is spent: the next frame passes through as is
        assert hooks.maybe_corrupt_frame(arr) is arr
        out[pk] = dirty
    assert _bytes(t) == clean == a.tobytes()   # the inputs are untouched
    assert _bytes(out["port"]) == np.ascontiguousarray(out["ref"]).tobytes()
    assert _bytes(out["port"]) != clean


# ---------------------------------------------------------------------------
# the stream wrapper


async def _numbers(n):
    for i in range(n):
        yield i


async def _consume(gen):
    got = []
    try:
        async for item in gen:
            got.append(item)
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return got, type(e).__name__, getattr(e, "retry_after_s", None)
    return got, None, None


STREAMS = {
    "kill": ("kill_worker", dict(after_outputs=2, once=True), 1),
    "drop": ("drop_response", dict(once=True), 1),
    "stall": ("stall_stream", dict(after_outputs=2, delay_s=0.05), 1),
    "delay": ("delay", dict(delay_s=0.001), 1),
    "storm": ("storm", dict(delay_s=2.0), 1),
    "kill p=0.5 over 8 streams": ("kill_worker",
                                  dict(probability=0.5, after_outputs=1), 8),
    "drop p=0.3": ("drop_response", dict(probability=0.3), 3),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
async def test_wrap_stream_matches_reference(case):
    point, kw, n_streams = STREAMS[case]
    seen = {}
    for pk in ("port", "ref"):
        hooks = PK[pk]["chaos"].ChaosHooks(rng=random.Random(5))
        hooks.arm(point, **kw)
        t0 = time.monotonic()
        outs = [await _consume(hooks.wrap_stream(_numbers(6)))
                for _ in range(n_streams)]
        dt = time.monotonic() - t0
        outs = [(g, e.replace("ChaosInjectedError", "reset")
                 if e else e, r) for g, e, r in outs]
        seen[pk] = (outs, hooks.points[point].injected_total,
                    hooks.points[point].armed,
                    PK[pk]["RESILIENCE"].get(
                        "dynamo_resilience_chaos_injections_total"))
        if case == "stall":
            assert dt >= 0.05
    assert seen["port"] == seen["ref"]
    outs = seen["port"][0]
    if case == "kill":
        assert outs == [([0, 1], "reset", None)]
        assert seen["port"][1:3] == (1, False)
    elif case == "drop":
        assert outs == [([1, 2, 3, 4, 5], None, None)]
    elif case == "stall":
        assert outs == [(list(range(6)), None, None)]
        assert seen["port"][1] == 1
    elif case == "delay":
        assert seen["port"][1] == 6
    elif case == "storm":
        assert outs == [([], "EngineOverloadedError", 2.0)]
    elif case.startswith("kill p"):
        assert 0 < sum(e is not None for _, e, _ in outs) < 8


async def test_wrap_stream_kill_is_a_connection_reset():
    pchaos.CHAOS.arm("kill_worker", after_outputs=1, once=True)
    with pytest.raises(ConnectionResetError):
        async for _ in pchaos.CHAOS.wrap_stream(_numbers(3)):
            pass
    assert issubclass(pchaos.ChaosInjectedError, ConnectionResetError)
    assert P_RES.get("dynamo_resilience_chaos_injections_total") == 1
    # disarmed by its fuse: streams flow clean again
    assert [i async for i in pchaos.CHAOS.wrap_stream(_numbers(3))] == \
        [0, 1, 2]


@BOTH
async def test_once_kill_fires_once_across_two_concurrent_streams(pk):
    """A once-fused kill latched by two concurrent streams fires on one:
    the other re-checks the fuse at injection time."""
    chaos = PK[pk]["chaos"].CHAOS
    chaos.arm("kill_worker", after_outputs=1, once=True)
    g1 = chaos.wrap_stream(_numbers(4))
    g2 = chaos.wrap_stream(_numbers(4))
    assert await g1.__anext__() == 0   # both streams latch their trigger
    assert await g2.__anext__() == 0
    with pytest.raises(ConnectionResetError):
        await g1.__anext__()
    assert [0] + [i async for i in g2] == [0, 1, 2, 3]
    assert chaos.points["kill_worker"].injected_total == 1


@BOTH
async def test_maybe_stall_threshold_and_fire(pk):
    hooks = PK[pk]["chaos"].ChaosHooks(rng=random.Random(1))
    assert not await hooks.maybe_stall("stall_stream", 5)
    hooks.arm("stall_stream", after_outputs=2, delay_s=0.01, once=True)
    assert not await hooks.maybe_stall("stall_stream", 1)
    assert await hooks.maybe_stall("stall_stream", 2)
    assert not await hooks.maybe_stall("stall_stream", 3)   # fuse spent
    assert hooks.fire("nope") is False


# ---------------------------------------------------------------------------
# graceful drain


class _Engine:
    """The drain contract with a scripted in-flight count."""

    def __init__(self, events, inflight=0):
        self.events, self.inflight = events, inflight

    def begin_drain(self):
        self.events.append("begin")

    def drained(self):
        return self.inflight == 0


async def _drain_script(pk):
    mod, R = PK[pk]["drain"], PK[pk]["RESILIENCE"]
    events = []

    async def dereg():
        events.append("dereg")

    eng = _Engine(events, inflight=1)
    c = mod.DrainController(eng, on_deregister=dereg,
                            on_drained=lambda: events.append("done"),
                            timeout_s=10.0, poll_s=0.01)
    seen = [c.status()["state"]]
    ev = c.request_drain(reason="test")
    # admissions stop synchronously; the gauge is up
    seen += [list(events), c.state, R.get("dynamo_resilience_draining")]
    assert c.request_drain() is ev      # idempotent
    await asyncio.sleep(0.05)
    seen += [list(events), c.state]      # still waiting on in-flight
    eng.inflight = 0
    await asyncio.wait_for(ev.wait(), 5.0)
    seen += [list(events), c.state, R.get("dynamo_resilience_draining"),
             R.get("dynamo_resilience_drains_total"),
             sorted(c.status())]
    # the timeout: an engine that never drains is left behind
    stuck = mod.DrainController(_Engine([], inflight=1), timeout_s=0.1,
                                poll_s=0.01)
    t0 = time.monotonic()
    await asyncio.wait_for(stuck.request_drain().wait(), 5.0)
    seen += [stuck.state, time.monotonic() - t0 >= 0.1,
             R.get("dynamo_resilience_drains_total")]
    # a failing deregister hook does not stop the drain
    bad = mod.DrainController(_Engine([]), on_deregister=lambda: 1 / 0)
    await asyncio.wait_for(bad.request_drain().wait(), 5.0)
    seen.append(bad.state)
    return seen


async def test_drain_controller_matches_reference():
    port, ref = await _drain_script("port"), await _drain_script("ref")
    assert port == ref
    assert port[1] == ["begin"] and port[2] == "draining"
    assert port[6] == ["begin", "dereg", "done"] and port[7] == "drained"
    assert port[8:10] == [0, 1]
    assert port[11:] == ["drained", True, 2, "drained"]
    assert issubclass(pdrain.WorkerDrainingError, ConnectionError)


# ---------------------------------------------------------------------------
# health tracker: TTL staleness, frozen, never heartbeated, remote blocks


def _ttl_script(pk):
    m = PK[pk]
    clock = FakeClock()
    changes = []
    h = m["health"].WorkerHealthTracker(
        failure_threshold=2, reset_timeout_s=5.0, heartbeat_ttl_s=2.0,
        clock=clock)
    h.on_state_change = lambda *a: changes.append(a)
    seen = []
    seen.append(h.blocked(["a", "b"]))      # nobody heartbeated: routable
    h.heartbeat("a")
    clock.advance(1.5)
    seen.append((h.stale("a"), h.blocked(["a", "b"])))
    clock.advance(1.0)                      # a silent 2.5 s > TTL
    seen.append((h.stale("a"), h.stale("b"), h.blocked(["a", "b"])))
    h.freeze()                              # store outage: never stale
    clock.advance(10.0)
    seen.append((h.stale("a"), h.blocked(["a"])))
    h.thaw()                                # one full TTL of grace
    seen.append((h.stale("a"), h.blocked(["a"])))
    clock.advance(2.5)
    seen.append(h.blocked(["a"]))
    h.heartbeat("a")
    # a sibling's trip blocks b for its window, then b probes freely
    h.note_remote_open("b", 3.0)
    h.note_remote_open("c", 0.0)            # an expired window: ignored
    seen.append((h.blocked(["a", "b", "c"]), dict(h._remote_open)))
    clock.advance(3.5)
    h.heartbeat("a")
    seen.append((h.blocked(["a", "b"]), dict(h._remote_open)))
    h.note_remote_open("b", 3.0)
    h.clear_remote_open("b")
    seen.append(h.blocked(["b"]))
    # local trip and recovery fire the board's hook; remote state never
    # feeds the local breaker
    h.note_remote_open("d", 5.0)
    h.record_failure("d")
    h.record_failure("d")
    seen.append((h.states(), list(changes),
                 m["RESILIENCE"].get("dynamo_resilience_breaker_open")))
    clock.advance(6.0)
    seen.append(h.blocked(["d"]))
    h.on_routed("d")
    h.record_success("d")
    seen.append((h.states(), list(changes), dict(h._remote_open)))
    h.forget("d")
    seen.append((h.states(), h.stale("d")))
    return seen


def test_health_ttl_and_remote_blocks_match_reference():
    port = _ttl_script("port")
    assert port == _ttl_script("ref")
    assert port[0] == set() and port[1] == (False, set())
    assert port[2] == (True, False, {"a"})
    assert port[3] == (False, set()) and port[4] == (False, set())
    assert port[5] == {"a"}
    assert port[6][0] == {"b"}
    assert port[9][1] == [("d", "open", 5.0)]
    assert port[11][1] == [("d", "open", 5.0), ("d", "closed", 0.0)]


# ---------------------------------------------------------------------------
# shared breakers over a store


async def _board(pk, port, health):
    kv = await PK[pk]["KvClient"](port=port).connect()
    board = await PK[pk]["shared"].SharedBreakerBoard(
        kv, health, namespace="res").start()
    return kv, board


async def _until(pred, what, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.01)


@pytest.mark.parametrize("store,a,b", [
    ("port", "port", "port"), ("port", "ref", "port"),
    ("ref", "port", "ref")])
async def test_shared_breaker_trip_crosses_frontends(store, a, b):
    """A trip on frontend A blocks the worker on frontend B through the
    store; A's recovery probe lifts B's block; the packages' boards
    exchange trips (one topic, one JSON)."""
    assert pshared.breaker_topic("res") == rshared.breaker_topic("res")
    server, _ = await PK[store]["serve_store"](port=0, sweep_interval_s=0.05)
    port = server.sockets[0].getsockname()[1]
    ha = PK[a]["health"].WorkerHealthTracker(failure_threshold=2,
                                             reset_timeout_s=0.5)
    hb = PK[b]["health"].WorkerHealthTracker(failure_threshold=2,
                                             reset_timeout_s=30.0)
    (kva, ba), (kvb, bb) = await _board(a, port, ha), \
        await _board(b, port, hb)
    try:
        ha.record_failure("w1")
        await asyncio.sleep(0.1)
        assert hb.blocked(["w1", "w2"]) == set()   # one failure: no trip
        ha.record_failure("w1")
        await _until(lambda: hb.blocked(["w1", "w2"]) == {"w1"},
                     "the trip reached frontend B")
        await _until(lambda: ba.published == 1, "the publish's reply")
        assert bb.applied == 1
        assert hb.states() == {}            # advisory: no local breaker
        await asyncio.sleep(0.6)            # A's reset window passes
        assert ha.blocked(["w1"]) == set()
        ha.on_routed("w1")
        ha.record_success("w1")             # the probe succeeded
        await _until(lambda: hb.blocked(["w1"]) == set(),
                     "the recovery reached frontend B")
        await _until(lambda: ba.published == 2, "the publish's reply")
        await ba.stop()
        assert ha.on_state_change is None
    finally:
        await bb.stop()
        await kva.close()
        await kvb.close()
        server.close()


async def test_watcher_feeds_ttl_and_runs_a_breaker_board():
    server, _ = await p_serve_store(port=0, sweep_interval_s=0.05)
    port = server.sockets[0].getsockname()[1]
    rt = await DistributedRuntime.connect(port=port)
    try:
        w = await ModelWatcher(rt, ModelManager(), namespace="res",
                               heartbeat_ttl_s=2.0).start()
        assert w.health.heartbeat_ttl_s == 2.0
        board = w._breaker_board
        assert board is not None and board.namespace == "res"
        assert w.health.on_state_change == board._on_local_change
        await w.stop()
        assert w._breaker_board is None and w.health.on_state_change is None
        assert ModelWatcher(rt, ModelManager()).health.heartbeat_ttl_s is None
    finally:
        await rt.close()
        server.close()


# ---------------------------------------------------------------------------
# the system server over the port's HTTP client


class _MetricsEngine:
    def metrics(self):
        return ForwardPassMetrics(worker_id="w9", kv_stats=KvStats(
            kv_active_blocks=3, kv_total_blocks=64, host_blocks=5))


async def _call(port, method, path, body=None, raw=None, headers=None):
    async with HttpClient("127.0.0.1", port) as c:
        r = await c.request(method, path, json_body=body, body=raw,
                            headers=headers)
    return r.status, r.headers, r.body


async def test_system_server_chaos_drain_health_and_metrics():
    events = []
    eng = _Engine(events)
    controller = pdrain.DrainController(eng, timeout_s=5.0, poll_s=0.01)
    srv = await SystemServer(eng, host="127.0.0.1", port=0,
                             worker_id="w0", drain=controller).start()
    bare = await SystemServer(_MetricsEngine(), host="127.0.0.1",
                              port=0).start()
    p = srv.port
    try:
        s, _, b = await _call(p, "GET", "/health")
        assert s == 200 and json.loads(b)["worker_id"] == "w0"
        s, _, b = await _call(p, "GET", "/live")
        assert s == 200 and json.loads(b)["status"] == "ok"
        # /chaos: list, arm, disarm, with the JAX package's point set
        s, _, b = await _call(p, "GET", "/chaos")
        body = json.loads(b)
        assert s == 200 and body["worker_id"] == "w0"
        assert {q["name"] for q in body["points"]} == \
            set(rchaos.POINT_NAMES)
        s, _, b = await _call(p, "POST", "/chaos", {
            "point": "kill_worker", "probability": 0.5,
            "after_outputs": 3, "once": True})
        assert s == 200 and json.loads(b)["armed"]
        k = pchaos.CHAOS.points["kill_worker"]
        assert (k.armed, k.probability, k.after_outputs, k.once) == \
            (True, 0.5, 3, True)
        for bad in ({"point": "nope"}, {"point": "delay",
                                        "probability": "x"}):
            s, _, b = await _call(p, "POST", "/chaos", bad)
            assert s == 400 and "error" in json.loads(b)
        s, _, b = await _call(p, "POST", "/chaos", raw=b"{not json")
        assert s == 400 and json.loads(b) == {"error": "invalid JSON"}
        s, _, b = await _call(p, "DELETE", "/chaos?point=nope")
        assert s == 400
        pchaos.CHAOS.arm("delay", delay_s=0.01)
        s, _, b = await _call(p, "DELETE", "/chaos?point=kill_worker")
        assert s == 200 and not k.armed
        assert pchaos.CHAOS.points["delay"].armed
        s, _, b = await _call(p, "DELETE", "/chaos")
        assert s == 200 and not pchaos.CHAOS.any_armed()
        assert len(json.loads(b)["points"]) == 11
        # /drain: status, trigger, drained
        s, _, b = await _call(p, "GET", "/drain")
        assert s == 200 and json.loads(b)["state"] == "serving"
        s, _, b = await _call(p, "POST", "/drain")
        assert s == 200 and json.loads(b)["state"] in ("draining", "drained")
        await asyncio.wait_for(controller.wait_drained(), 5.0)
        s, _, b = await _call(p, "GET", "/drain")
        assert json.loads(b)["state"] == "drained" and events == ["begin"]
        assert (await _call(bare.port, "GET", "/drain"))[0] == 404
        assert (await _call(bare.port, "POST", "/drain"))[0] == 404
        # /metrics: uptime, the engine's gauges, the process's families
        s, h, b = await _call(bare.port, "GET", "/metrics")
        text = b.decode()
        assert s == 200 and h["content-type"].startswith("text/plain")
        for line in ("# TYPE dynamo_system_uptime_seconds gauge",
                     'dynamo_kv_active_blocks{worker="w9"} 3',
                     'dynamo_kv_host_blocks{worker="w9"} 5',
                     "# TYPE dynamo_migration_total counter",
                     "dynamo_resilience_draining 0",
                     "dynamo_resilience_drains_total 1",
                     "# TYPE dynamo_kv_integrity_failed_total counter"):
            assert line in text, line
        assert "# EOF" not in text
        s, h, b = await _call(bare.port, "GET", "/metrics", headers={
            "Accept": "application/openmetrics-text"})
        assert h["content-type"] == "application/openmetrics-text"
        assert b.decode().endswith("# EOF\n")
        # the debug plane names the ROADMAP item that brings it
        s, _, b = await _call(p, "GET", "/debug/flight")
        assert s == 404 and "item 10" in json.loads(b)["error"]
        s, _, b = await _call(p, "GET", "/debug/kv_fleet")
        assert s == 404 and "item 6" in json.loads(b)["error"]
    finally:
        await srv.stop()
        await bare.stop()


async def test_chaos_tool_lists_arms_and_disarms(capsys):
    srv = await SystemServer(None, host="127.0.0.1", port=0,
                             worker_id="w7").start()
    target = f"127.0.0.1:{srv.port}"
    try:
        rc = await asyncio.to_thread(chaos_tool.main, [
            "--target", target, "arm", "kill_worker", "--probability",
            "0.2", "--after", "3", "--once"])
        assert rc == 0
        k = pchaos.CHAOS.points["kill_worker"]
        assert (k.armed, k.probability, k.after_outputs, k.once) == \
            (True, 0.2, 3, True)
        assert await asyncio.to_thread(
            chaos_tool.main, ["--target", target, "list"]) == 0
        out = capsys.readouterr().out
        assert "armed:" in out and "(worker w7)" in out
        assert "kill_worker    [ARMED] injected=0  p=0.2 after=3 once" in out
        assert await asyncio.to_thread(
            chaos_tool.main, ["--target", target, "disarm"]) == 0
        assert not pchaos.CHAOS.any_armed()
    finally:
        await srv.stop()
    with pytest.raises(SystemExit):
        await asyncio.to_thread(chaos_tool.main, ["--target", target, "list"])
