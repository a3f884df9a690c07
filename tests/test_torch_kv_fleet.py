"""The port's fleet prefix economy (dynamo_tpu_torch/kv_router/fleet.py,
kv_router/prefetch.py, kv_fleet_metrics.py, the dedup admission and
prefetch path of TorchEngine, replication-aware G2/G3 eviction, the
watcher's hint loop and controller, /debug/kv_fleet and the kv_fleet
tool) against the JAX package's, on the CPU with tiny f32 weights:

- the same events and touches on one fake clock give both packages'
  FleetKvView equal ``to_dict``, ``digest``, ``hot_chains``,
  ``under_replicated`` and ``chain_of``, through churn (worker removal,
  TTL sweeps, late and duplicate REMOVEDs, a CLEARED, parentless
  snapshots); FleetHints read a digest alike;
- KvPrefetchController makes the same pushes, in the same order, with the
  same hashes, parents and payloads, returns the same counts and moves
  the same counters (warm start, replication, cooldown, the budget cut,
  hookless publish, an empty or undeliverable fleet, a failing worker);
- the tiers evict the same victims with the same counters, and a G2 that
  spills into G3 under hints leaves a G3 file and manifest byte-equal to
  the JAX package's;
- the dedup arms (hinted, stale hint, unknown, off), the prefetch arm and
  a ``corrupt_prefetch`` on a prefetched page are greedy token-identical
  to TpuEngine's arms with equal counter deltas and fetch counts;
- across packages over one store, each package's frontend controller
  warm-starts the other package's cold worker, whose stream then equals
  a warm replay;
- the kv_fleet tool's exit codes against the port's frontend, the
  frontend's and the worker's /debug/kv_fleet bodies JSON-equal to the
  JAX package's, and the dynamo_kv_fleet_* families on both /metrics
  surfaces."""
import asyncio
import json
import sys
import time
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dynamo_tpu import kv_transfer as jkt
from dynamo_tpu.frontend import HttpService as RService
from dynamo_tpu.frontend import ModelManager as RManager
from dynamo_tpu.frontend.watcher import ModelEntry as RModelEntry
from dynamo_tpu.frontend.watcher import ModelWatcher as RModelWatcher
from dynamo_tpu.frontend.watcher import register_llm as r_register_llm
from dynamo_tpu.kv_fleet_metrics import KV_FLEET as J_FLEET
from dynamo_tpu.kv_integrity import KV_INTEGRITY as J_INTEGRITY
from dynamo_tpu.kv_router import fleet as jfleet
from dynamo_tpu.kv_router import prefetch as jprefetch
from dynamo_tpu.kv_router.indexer import KvIndexer as JIndexer
from dynamo_tpu.kv_router.protocols import KvCacheEvent as JEvent
from dynamo_tpu.kv_router.scheduler import KvRouterConfig as RRouterConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.resilience.chaos import CHAOS as J_CHAOS
from dynamo_tpu.runtime.client import KvClient as JKvClient
from dynamo_tpu.runtime.component import DistributedRuntime as RRuntime
from dynamo_tpu.runtime.system_server import SystemServer as RSystemServer
from dynamo_tpu_torch import kv_transfer as tkt
from dynamo_tpu_torch.frontend.http import HttpClient
from dynamo_tpu_torch.frontend.model_manager import ModelManager as PManager
from dynamo_tpu_torch.frontend.service import HttpService as PService
from dynamo_tpu_torch.frontend.watcher import ModelEntry as PModelEntry
from dynamo_tpu_torch.frontend.watcher import ModelWatcher as PModelWatcher
from dynamo_tpu_torch.frontend.watcher import register_llm as p_register_llm
from dynamo_tpu_torch.kv_fleet_metrics import FAMILIES, KV_FLEET
from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY
from dynamo_tpu_torch.kv_router import fleet as tfleet
from dynamo_tpu_torch.kv_router import prefetch as tprefetch
from dynamo_tpu_torch.kv_router.indexer import KvIndexer as TIndexer
from dynamo_tpu_torch.kv_router.protocols import KvCacheEvent as TEvent
from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig as PRouterConfig
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.resilience.chaos import CHAOS
from dynamo_tpu_torch.runtime.client import KvClient as TKvClient
from dynamo_tpu_torch.runtime.component import DistributedRuntime as PRuntime
from dynamo_tpu_torch.runtime.store import serve_store
from dynamo_tpu_torch.runtime.system_server import SystemServer
from dynamo_tpu_torch.tokens import compute_block_hashes
from tests.test_torch_offload import KINDS, Pair
from tests.test_torch_remote_kv import (
    PROMPT,
    PS,
    collect,
    port_engine,
    ref_engine,
    serve_pool,
    weights,  # noqa: F401 — the module's tiny f32 weights fixture
)

ROOT = Path(__file__).resolve().parent.parent
BS = 4   # the router's block size in the view tests


@pytest.fixture(autouse=True)
def _reset_globals():
    for reg, hooks in ((KV_FLEET, CHAOS), (J_FLEET, J_CHAOS)):
        reg.reset()
        hooks.reset()
    yield
    for reg, hooks in ((KV_FLEET, CHAOS), (J_FLEET, J_CHAOS)):
        reg.reset()
        hooks.reset()


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _js(x):
    """JSON form of a result (tuples and sets compared as lists)."""
    return json.loads(json.dumps(x, sort_keys=True, default=sorted))


# ---------------------------------------------------------------------------
# the fleet view and the hints, twin indexers on one clock


class Twin:
    """The JAX package's indexer and view beside the port's, fed the same
    events and touches on one fake clock."""

    def __init__(self, halflife=600.0, ttl=None):
        self.clock = FakeClock()
        kw = dict(freq_halflife_s=halflife, clock=self.clock)
        self.j = jfleet.FleetKvView(JIndexer(BS, ttl, **kw))
        self.t = tfleet.FleetKvView(TIndexer(BS, ttl, **kw))
        self.known: set[int] = set()

    def event(self, **ev):
        for view, cls in ((self.j, JEvent), (self.t, TEvent)):
            view.indexer.apply_event(cls.from_dict(dict(ev)))
        for b in ev.get("blocks", ()):
            self.known.add(b["block_hash"])

    def store(self, w, hashes, parent=0):
        self.event(kind="stored", worker_id=w, parent_hash=parent,
                   blocks=[{"block_hash": h, "tokens_hash": 0}
                           for h in hashes])

    def remove(self, w, hashes):
        self.event(kind="removed", worker_id=w, removed_hashes=list(hashes))

    def touch(self, hashes):
        a = self.j.indexer.find_matches(hashes)
        b = self.t.indexer.find_matches(hashes)
        assert _js(b.scores) == _js(a.scores)

    def remove_worker(self, w):
        self.j.indexer.remove_worker(w)
        self.t.indexer.remove_worker(w)

    def check(self):
        for call in (lambda v: v.to_dict(),
                     lambda v: v.to_dict(top=2),
                     lambda v: v.digest(),
                     lambda v: v.digest(max_blocks=3, max_holders=1),
                     *[lambda v, k=k: v.hot_chains(k) for k in (1, 2, 4, 9)],
                     *[lambda v, t=t: v.under_replicated(t, 16)
                       for t in (2, 3)],
                     lambda v: [v.chain_of(h) for h in sorted(self.known)],
                     lambda v: [v.chain_of(h, max_len=2)
                                for h in sorted(self.known)],
                     lambda v: [[v.replicas(h), sorted(v.holders(h)),
                                 v.heat(h)] for h in sorted(self.known)]):
            assert _js(call(self.t)) == _js(call(self.j))


def _runs():
    # two prompts sharing their first two blocks, and a third apart
    a = compute_block_hashes(list(range(1, 17)), BS)            # 4 blocks
    b = compute_block_hashes(list(range(1, 9)) + [90] * 8, BS)  # 2 shared
    c = compute_block_hashes(list(range(40, 52)), BS)           # 3 blocks
    return a, b, c


def _scenario_warm(tw):
    a, _, _ = _runs()
    tw.store("warm", a)
    for _ in range(2):
        tw.touch(a)


def _scenario_shared(tw):
    a, b, c = _runs()
    tw.store("w1", a)
    tw.store("w2", b[:2])
    tw.store("w2", b[2:], parent=b[1])
    tw.store("w3", c)
    for hs, n in ((a, 3), (b, 2), (c, 1)):
        for _ in range(n):
            tw.touch(hs)
            tw.clock.t += 7.5
    tw.check()
    tw.clock.t += 900.0   # heat halves 1.5 times
    tw.touch(c)


def _scenario_churn(tw):
    a, b, c = _runs()
    tw.store("w1", a)
    tw.store("w2", a[:2])
    tw.store("w2", b[2:], parent=b[1])
    tw.store("w3", c)
    tw.touch(a)
    tw.touch(b)
    tw.check()
    tw.remove("w1", [a[3], a[3], 999])     # a duplicate and an unknown
    tw.remove_worker("w2")
    tw.remove("w2", [a[0]])                 # late: w2 is gone already
    tw.check()
    tw.clock.t += 50.0                      # past the 30 s TTL
    tw.touch(c)                             # the sweep drops c
    tw.store("w3", c)                       # a new life: cold again
    tw.touch(a[:2])
    tw.check()
    tw.event(kind="cleared", worker_id="w1")
    tw.clock.t += 5.0
    tw.touch(c)


def _scenario_raw(tw):
    a, b, _ = _runs()
    tw.store("w1", a)
    tw.store("w2", b)
    for _ in range(3):
        tw.touch(b)
        tw.clock.t += 1000.0
    tw.touch(a)


def _scenario_parentless(tw):
    # batched snapshot events carry no parent links: chains start
    # mid-prefix where the parent is unknown
    a, b, _ = _runs()
    tw.event(kind="stored", worker_id="w1", parent_hash=None,
             blocks=[{"block_hash": h, "tokens_hash": 0} for h in a[2:]])
    tw.store("w1", a[:2])
    tw.store("w2", b)
    tw.touch(a)
    tw.touch(b)
    tw.touch(a)


@pytest.mark.parametrize("name,halflife,ttl", [
    ("warm", 600.0, None), ("shared", 600.0, None), ("churn", 600.0, 30.0),
    ("raw", None, None), ("parentless", 600.0, None),
])
def test_view_equals_the_jax_packages_view(name, halflife, ttl):
    tw = Twin(halflife, ttl)
    globals()[f"_scenario_{name}"](tw)
    tw.check()
    assert tw.t.indexer.total_blocks() == tw.j.indexer.total_blocks()


def test_hints_read_a_digest_as_the_jax_packages_do():
    tw = Twin()
    _scenario_shared(tw)
    wire = json.loads(json.dumps(tw.t.digest()))  # through the wire
    assert wire == _js(tw.j.digest())
    th, jh = tfleet.FleetHints(wire), jfleet.FleetHints(wire)
    probe = sorted(tw.known) + [123456789]
    for h in probe:
        assert th.replicas(h) == jh.replicas(h)
        assert th.holders(h) == jh.holders(h)
    assert th.replicas(123456789) is None   # unknown, not 0
    assert th.to_dict() == jh.to_dict() and th.applied == 1
    # a later digest swaps the maps whole
    for h in (th, jh):
        h.apply({"replicas": {"5": 2}, "holders": {"5": ["w9"]},
                 "hot": [5]})
    assert th.to_dict() == jh.to_dict() == {"applied": 2, "known_blocks": 1,
                                            "hot": [5]}
    assert th.replicas(probe[0]) is None and th.holders(5) == ["w9"]


def test_package_exports_the_fleet_view():
    from dynamo_tpu_torch import kv_router

    assert kv_router.FleetKvView is tfleet.FleetKvView
    assert kv_router.FleetHints is tfleet.FleetHints
    assert [f[0] for f in FAMILIES] == [
        f[0] for f in __import__(
            "dynamo_tpu.kv_fleet_metrics", fromlist=["FAMILIES"]).FAMILIES]
    assert tprefetch.KV_FLEET_TOPIC == jprefetch.KV_FLEET_TOPIC
    assert tprefetch.PrefetchConfig().__dict__ == \
        jprefetch.PrefetchConfig().__dict__


# ---------------------------------------------------------------------------
# the replication controller on stub workers


class StubWorker:
    """A duck-typed worker recording every delivery into ``log``."""

    def __init__(self, wid, log, fail=False):
        self.wid, self.log, self.fail = wid, log, fail

    def apply_fleet_hints(self, digest):
        self.log.append(["hints", self.wid, digest])

    async def prefetch_hashes(self, hashes, parents=None):
        if self.fail:
            raise ConnectionError("worker gone")
        self.log.append(["prefetch", self.wid, list(hashes),
                         list(parents or [])])
        return len(hashes)


class Wrapped:
    """A worker whose hooks sit on ``.engine`` (the disagg wrapper's
    shape)."""

    def __init__(self, inner):
        self.engine = inner


def _controller_run(mod, fleet_mod, tw_view, scenario, clock):
    """Drive one package's controller through ``scenario``; returns the
    delivery log, each tick's count and the counter deltas."""
    log: list = []
    cfg = dict(replication_target=2, hot_k=4, cooldown_s=30.0)
    publish = None

    async def pub(wid, msg):
        log.append(["publish", wid, msg])

    if scenario == "warm_start_replicate_cooldown":
        workers = {"warm": StubWorker("warm", log),
                   "cold": StubWorker("cold", log)}
    elif scenario == "hookless_publish":
        workers = {"remote": object()}
        publish = pub
    elif scenario == "budget_cut":
        workers = {"warm": StubWorker("warm", log),
                   "cold": Wrapped(StubWorker("cold", log))}
        cfg["max_blocks_per_tick"] = 3
    elif scenario == "empty_fleet":
        workers = {}
    elif scenario == "undeliverable":
        workers = {"w": object()}
    elif scenario == "failing_worker":
        workers = {"dead": StubWorker("dead", log, fail=True),
                   "cold": StubWorker("cold", log)}
    elif scenario == "born_warm":
        workers = {"w1": StubWorker("w1", log), "w2": StubWorker("w2", log),
                   "w3": StubWorker("w3", log)}
        cfg["replication_target"] = 3
    ctrl = mod.KvPrefetchController(
        tw_view, lambda: workers, mod.PrefetchConfig(**cfg),
        publish=publish, clock=clock)
    reg = KV_FLEET if mod is tprefetch else J_FLEET
    before = reg.snapshot()
    counts = []
    for dt in (0.0, 1.0, 31.0, 0.5):
        clock.t += dt
        counts.append(asyncio.run(ctrl.tick()))
    after = reg.snapshot()
    deltas = {k[len("dynamo_kv_fleet_"):]: after[k] - before[k]
              for k in after}
    return log, counts, deltas, ctrl.ticks


@pytest.mark.parametrize("scenario", [
    "warm_start_replicate_cooldown", "hookless_publish", "budget_cut",
    "empty_fleet", "undeliverable", "failing_worker", "born_warm",
])
def test_controller_pushes_equal_the_jax_packages(scenario):
    tw = Twin()
    a, b, c = _runs()
    if scenario == "born_warm":
        tw.store("w1", a)
        tw.store("w2", b)
        tw.store("w2", c)
        tw.store("w3", c[:1])
        for hs in (a, b, c):
            tw.touch(hs)
    else:
        tw.store("warm", a)
        tw.store("warm", c)
        for _ in range(2):
            tw.touch(a)
        tw.touch(c)
    got = _controller_run(tprefetch, tfleet, tw.t, scenario, tw.clock)
    tw.clock.t -= 32.5   # the same clock again for the JAX package's run
    want = _controller_run(jprefetch, jfleet, tw.j, scenario, tw.clock)
    assert _js(got) == _js(want)
    log, counts, deltas, _ = got
    if scenario == "warm_start_replicate_cooldown":
        # cold: warm-started with the hot runs root first, parents
        # aligned; inside the cooldown no re-push; after it, the
        # under-replicated chains go to the least-loaded non-holder
        pre = [e for e in log if e[0] == "prefetch"]
        assert pre[0][1] == "cold" and pre[0][2] == a[:len(pre[0][2])]
        assert pre[0][3][1:] == pre[0][2][:-1]
        assert counts[0] > 0 and counts[1] == 0 and counts[2] > 0
        assert deltas["warm_starts_total"] == 1
        assert deltas["hint_pushes_total"] == 8
    elif scenario == "budget_cut":
        assert counts[0] == 3 and deltas["warm_starts_total"] == 1
    elif scenario == "hookless_publish":
        assert {next(iter(e[2])) for e in log} == {"hints", "prefetch"}
    elif scenario in ("empty_fleet", "undeliverable"):
        assert counts == [0, 0, 0, 0] and not log
        assert deltas["prefetch_rounds_total"] == 4
    elif scenario == "failing_worker":
        assert all(e[1] != "dead" for e in log if e[0] == "prefetch")
    elif scenario == "born_warm":
        assert deltas["warm_starts_total"] == 0 and counts[0] > 0


# ---------------------------------------------------------------------------
# replication-aware eviction: victims, counters and the G3 file


def _fleet_counters(reg):
    snap = reg.snapshot()
    return {k: snap[k] for k in (
        "dynamo_kv_fleet_replicated_evictions_total",
        "dynamo_kv_fleet_last_copy_evictions_total")}


@pytest.mark.parametrize("scenario", ["lru", "hints", "raising"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_eviction_victims_and_g3_files_equal_the_jax_packages(
        tmp_path, kind, scenario):
    p = Pair(kind, 3, disk_pages=4, tmp=tmp_path)
    reps = {1: 1, 2: 3, 3: 1, 5: 2, 6: None, 8: 4}

    def raising(h):
        if h == 3:
            raise KeyError(h)
        return reps.get(h)

    fn = {"lru": None, "hints": reps.get, "raising": raising}[scenario]
    for tier in (p.j, p.jdisk, p.t, p.disk):
        tier.fleet_replicas = fn
    j0, t0 = _fleet_counters(J_FLEET), _fleet_counters(KV_FLEET)
    p.put([1, 2, 3], [0, 1, 2])
    p.put([4], [3])
    p.check()
    if scenario == "lru":
        assert 1 in p.disk and 2 in p.t
    else:
        # the well-replicated block went down first; the last copies stay
        assert 2 in p.disk and 1 in p.t and 3 in p.t
    p.lookup([3, 4])
    p.put([5, 6], [4, 5])
    p.put([7, 8, 9], [6, 7, 8])   # G3 full: its own victims too
    p.put([10], [9])
    held = p.check()
    assert held
    j1, t1 = _fleet_counters(J_FLEET), _fleet_counters(KV_FLEET)
    assert {k: t1[k] - t0[k] for k in t1} == {k: j1[k] - j0[k] for k in j1}
    if scenario == "lru":
        assert all(t1[k] == t0[k] for k in t1)
    else:
        assert any(t1[k] > t0[k] for k in t1)
    p.close()
    for name in ("3.mmap", "3.mmap.manifest"):
        assert (tmp_path / f"t{name}").read_bytes() == \
            (tmp_path / f"j{name}").read_bytes(), name


def test_engine_wires_hint_replicas_into_both_tiers(weights, tmp_path):
    eng = port_engine(weights, host_offload_pages=4, disk_offload_pages=4,
                      disk_offload_path=str(tmp_path / "g3.mmap"))
    try:
        assert eng.fleet_hints is None and eng.offload.fleet_replicas is None
        eng.apply_fleet_hints({"replicas": {"7": 3}, "holders": {},
                               "hot": [7]})
        for tier in (eng.offload, eng.offload.spill):
            assert tier.fleet_replicas(7) == 3
            assert tier.fleet_replicas(8) is None
        hints = eng.fleet_hints
        eng.apply_fleet_hints({"replicas": {"8": 1}})
        assert eng.fleet_hints is hints and hints.applied == 2
        assert eng.offload.fleet_replicas(7) is None
        assert eng.offload.spill.fleet_replicas(8) == 1
    finally:
        asyncio.run(eng.stop())


# ---------------------------------------------------------------------------
# the engine: dedup admission, prefetch and corrupt_prefetch beside
# TpuEngine


async def _fleet_store():
    server, _ = await serve_store("127.0.0.1", 0, sweep_interval_s=0.1)
    return server, server.sockets[0].getsockname()[1]


async def _warm_peer(weights, kv, ns):
    """A warm port engine serving its pool as ``warm``: (engine, server,
    its tokens for PROMPT, PROMPT's block hashes)."""
    warm = port_engine(weights)
    warm_toks = await collect(warm, tproto, PROMPT)
    srv = await serve_pool(tkt, warm, kv, ns, "warm")
    return warm, srv, warm_toks, compute_block_hashes(PROMPT, PS)[:3]


def _holder_digest(hashes, holder="warm"):
    return {"replicas": {str(h): 1 for h in hashes},
            "holders": {str(h): [holder] for h in hashes},
            "hot": list(hashes)}


async def _cold_pair(weights, port, ns, **kw):
    """A cold TorchEngine and a cold TpuEngine, each with a G2 tier and
    its package's G4 fetcher on its own client of the store."""
    tkv = await TKvClient(port=port).connect()
    jkv = await JKvClient(port=port).connect()
    t = port_engine(weights, host_offload_pages=16, **kw)
    j = ref_engine(weights, host_offload_pages=16, **kw)
    t.remote_kv = tkt.RemoteKvFetcher(tkv, ns, "cold-port")
    j.remote_kv = jkt.RemoteKvFetcher(jkv, ns, "cold-jax")
    return (t, tkv), (j, jkv)


def _g4(eng):
    return (eng.remote_kv.fetches, eng.remote_kv.hits,
            eng.remote_onboard_blocks)


ARMS = {
    # the digest names the peer: fetched, counted as recompute avoided
    "hinted": (_holder_digest, {}),
    # the digest names a holder no descriptor has (as a launched fleet's
    # lease ids): the hinted probe finds no peer and the fleet is probed
    "stale": (lambda hs: _holder_digest(hs, "gone"), {}),
    # the digest knows none of the blocks: the probe round is skipped
    "unknown": (lambda hs: _holder_digest([123456789]), {}),
    # dedup admission off: the same digest is ignored, the probe runs
    "off": (lambda hs: _holder_digest([123456789]),
            {"kv_dedup_admission": False}),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.asyncio_timeout(240)
async def test_dedup_admission_arms_equal_tpu_engine(arm, weights):
    server, port = await _fleet_store()
    kv = await TKvClient(port=port).connect()
    warm, srv, warm_toks, hashes = await _warm_peer(weights, kv, "g4f")
    digest, kw = ARMS[arm]
    (t, tkv), (j, jkv) = await _cold_pair(weights, port, "g4f", **kw)
    try:
        results = []
        for eng, proto, reg in ((t, tproto, KV_FLEET), (j, jproto, J_FLEET)):
            eng.apply_fleet_hints(digest(hashes))
            before = reg.snapshot()
            toks = await collect(eng, proto, PROMPT)
            after = reg.snapshot()
            results.append((toks, _g4(eng), {
                k: after[k] - before[k] for k in after}))
        assert results[0] == results[1]
        toks, (fetches, hits, landed), deltas = results[0]
        assert toks == warm_toks
        if arm == "unknown":
            assert (fetches, hits, landed) == (0, 0, 0)
            assert deltas["dynamo_kv_fleet_dedup_skipped_probes_total"] == 1
        else:
            assert (fetches, hits, landed) == (1, 1, 3)
            assert deltas[
                "dynamo_kv_fleet_recompute_avoided_blocks_total"] == 3
    finally:
        await srv.stop()
        for e in (warm, t, j):
            await e.stop()
        for c in (kv, tkv, jkv):
            await c.close()
        server.close()


async def _landed(eng, hashes, jax_engine, timeout=10.0):
    """Waits for the queued prefetch pages to reach G2: the port's loop
    lands them itself; a TpuEngine that has served nothing yet runs no
    loop, so its queue is drained here, as the JAX package's test does."""
    deadline = time.monotonic() + timeout
    while True:
        if jax_engine:
            eng._drain_host_ingest()
        if all(h in eng.offload for h in hashes):
            return
        assert time.monotonic() < deadline, "prefetched pages never landed"
        await asyncio.sleep(0.02)


@pytest.mark.asyncio_timeout(240)
async def test_prefetch_lands_ahead_of_demand_as_tpu_engine(weights):
    server, port = await _fleet_store()
    kv = await TKvClient(port=port).connect()
    warm, srv, warm_toks, hashes = await _warm_peer(weights, kv, "g4p")
    (t, tkv), (j, jkv) = await _cold_pair(weights, port, "g4p")
    try:
        results = []
        for eng, proto, reg in ((t, tproto, KV_FLEET), (j, jproto, J_FLEET)):
            n = await eng.prefetch_hashes(list(hashes))
            await _landed(eng, hashes, eng is j)
            again = await eng.prefetch_hashes(list(hashes))  # all held
            fetches = eng.remote_kv.fetches
            toks = await collect(eng, proto, PROMPT)
            results.append((n, again, fetches, eng.remote_kv.fetches, toks,
                            eng.offload.onboard_hits >= 3, reg.get(
                                "dynamo_kv_fleet_prefetched_blocks_total")))
        assert results[0] == results[1]
        assert results[0] == (3, 0, 1, 1, warm_toks, True, 3)
    finally:
        await srv.stop()
        for e in (warm, t, j):
            await e.stop()
        for c in (kv, tkv, jkv):
            await c.close()
        server.close()


@pytest.mark.asyncio_timeout(240)
async def test_corrupt_prefetched_page_is_quarantined_as_tpu_engine(weights):
    server, port = await _fleet_store()
    kv = await TKvClient(port=port).connect()
    warm, srv, warm_toks, hashes = await _warm_peer(weights, kv, "g4c")
    (t, tkv), (j, jkv) = await _cold_pair(weights, port, "g4c")
    names = ("dynamo_kv_integrity_quarantined_total",
             "dynamo_kv_integrity_recomputed_total")
    try:
        results = []
        for eng, proto, chaos, reg in ((t, tproto, CHAOS, KV_INTEGRITY),
                                       (j, jproto, J_CHAOS, J_INTEGRITY)):
            chaos.arm("corrupt_prefetch", probability=1.0, once=True)
            before = [reg.get(n) for n in names]
            assert await eng.prefetch_hashes(list(hashes)) == 3
            await _landed(eng, hashes, eng is j)
            assert chaos.points["corrupt_prefetch"].injected_total == 1
            toks = await collect(eng, proto, PROMPT)
            results.append((toks, eng.remote_kv.fetches,
                            [reg.get(n) - b for n, b in zip(names, before)]))
        assert results[0] == results[1]
        toks, fetches, (quarantined, recomputed) = results[0]
        assert toks == warm_toks and fetches == 1
        assert quarantined >= 1 and recomputed >= 1
    finally:
        await srv.stop()
        for e in (warm, t, j):
            await e.stop()
        for c in (kv, tkv, jkv):
            await c.close()
        server.close()


# ---------------------------------------------------------------------------
# across packages over one store: a frontend controller warm-starts the
# other package's cold worker


SIDE = {
    "port": dict(Runtime=PRuntime, Watcher=PModelWatcher, Manager=PManager,
                 RouterConfig=PRouterConfig, prefetch=tprefetch,
                 Entry=PModelEntry,
                 register=p_register_llm, kt=tkt, engine=port_engine,
                 proto=tproto, fleet=KV_FLEET),
    "ref": dict(Runtime=RRuntime, Watcher=RModelWatcher, Manager=RManager,
                RouterConfig=RRouterConfig, prefetch=jprefetch,
                Entry=RModelEntry,
                register=r_register_llm, kt=jkt, engine=ref_engine,
                proto=jproto, fleet=J_FLEET),
}
NS = "fleet"


async def _until(pred, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.02)


async def _route(push, proto, prompt):
    """One greedy request through a frontend's KvPushRouter."""
    req = proto.PreprocessedRequest(
        token_ids=list(prompt), model="tiny",
        stop_conditions=proto.StopConditions(max_tokens=6, ignore_eos=True))
    toks = []
    async for out in push.generate(req):
        toks.extend(out.token_ids)
    return toks


async def _direct(eng, proto, prompt):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt), model="tiny",
        stop_conditions=proto.StopConditions(max_tokens=6, ignore_eos=True))
    toks = []
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
    return toks


@pytest.mark.parametrize("front,worker", [("port", "ref"), ("ref", "port")])
@pytest.mark.asyncio_timeout(240)
async def test_a_frontend_warm_starts_the_other_packages_worker(
        front, worker, weights):
    F, W = SIDE[front], SIDE[worker]
    server, port = await _fleet_store()
    frt = await F["Runtime"].connect(port=port)
    watcher = await F["Watcher"](
        frt, F["Manager"](), namespace=NS,
        router_config=F["RouterConfig"](router_temperature=0.0),
        prefetch_config=F["prefetch"].PrefetchConfig(
            interval_s=0.05, hot_k=8)).start()
    workers, done = [], []

    async def add(wid):
        eng = W["engine"](weights, host_offload_pages=16)
        prefetch = eng.prefetch_hashes

        async def counted(hashes, parents=None):
            n = await prefetch(hashes, parents)
            done.append((wid, n))
            return n

        # the fleet loop looks the hook up per payload: count its calls
        eng.prefetch_hashes = counted
        rt = await W["Runtime"].connect(port=port)
        eng.remote_kv = W["kt"].RemoteKvFetcher(rt.kv, NS, wid)
        srv = await serve_pool(W["kt"], eng, rt.kv, NS, wid)
        served = await W["register"](rt, eng, W["Entry"](
            name="tiny", namespace=NS, component="backend", block_size=PS,
            router_mode="kv"), lease_ttl_s=10.0)
        workers.append((eng, rt, srv, served))
        return eng, str(served.lease_id)

    try:
        w1, id1 = await add("w1")
        await _until(lambda: "tiny" in watcher._routers and id1 in
                     watcher._routers["tiny"].workers, "w1 discovered")
        push, view = watcher._routers["tiny"], watcher.fleet_views["tiny"]
        hashes = compute_block_hashes(PROMPT, PS, salt="tiny")[:3]
        cold = await _route(push, F["proto"], PROMPT)
        await _until(lambda: all(view.replicas(h) for h in hashes),
                     "w1's blocks indexed")
        await _route(push, F["proto"], PROMPT)   # heat: a routed hit
        # a chain may come with a partial one beside it (equal heats rank
        # by hash), and each is pushed
        chains = view.hot_chains(8)
        assert hashes in chains and {h for c in chains for h in c} == \
            set(hashes)
        warm0 = F["fleet"].get("dynamo_kv_fleet_warm_starts_total")
        w2, id2 = await add("w2")
        await _until(lambda: F["fleet"].get(
            "dynamo_kv_fleet_warm_starts_total") == warm0 + 1,
            "w2 warm-started")
        await _until(lambda: len(done) == len(chains), "the pushes served")
        assert {w for w, _ in done} == {"w2"}
        await _landed(w2, hashes, worker == "ref")
        assert W["fleet"].get("dynamo_kv_fleet_prefetched_blocks_total") \
            >= 3
        assert w2.fleet_hints is not None and w2.fleet_hints.applied >= 1
        fetches = w2.remote_kv.fetches
        assert 1 <= fetches <= len(chains)
        replay = await _direct(w1, W["proto"], PROMPT)   # w1's prefix hit
        got = await _direct(w2, W["proto"], PROMPT)
        assert got == replay == cold
        assert w2.remote_kv.fetches == fetches   # the demand stayed local
        assert w2.offload.onboard_hits >= 3
    finally:
        await watcher.stop()
        for eng, rt, srv, served in workers:
            task = getattr(served, "kv_fleet_task", None)
            if task is not None:
                task.cancel()
            await served.shutdown()
            await srv.stop()
            await eng.stop()
            await rt.close()
        await frt.close()
        server.close()


@pytest.mark.asyncio_timeout(120)
async def test_fleet_loop_survives_bad_payloads_and_stops_with_the_worker(
        weights):
    server, port = await _fleet_store()
    rt = await PRuntime.connect(port=port)
    eng = port_engine(weights, host_offload_pages=8)
    served = await p_register_llm(rt, eng, PModelEntry(
        name="tiny", namespace=NS, component="backend", block_size=PS,
        router_mode="kv"), lease_ttl_s=10.0)
    topic = f"{tprefetch.KV_FLEET_TOPIC}.{served.lease_id}"
    try:
        for bad in ("not json", json.dumps({"hints": [1, 2]}),
                    json.dumps({"prefetch": {"hashes": ["x"]}})):
            await rt.kv.publish(topic, bad)
        await rt.kv.publish(topic, json.dumps({"hints": _holder_digest(
            [11, 12])}))
        await _until(lambda: eng.fleet_hints is not None, "hints applied")
        assert eng.fleet_hints.to_dict() == {
            "applied": 1, "known_blocks": 2, "hot": [11, 12]}
        assert eng.offload.fleet_replicas(11) == 1
    finally:
        task = served.kv_fleet_task
        await served.shutdown()
        await asyncio.sleep(0)
        assert task.cancelled() or task.done()
        await eng.stop()
        await rt.close()
        server.close()


@pytest.mark.parametrize("prefetch", [None, 2])
@pytest.mark.asyncio_timeout(120)
async def test_watcher_builds_a_view_and_a_controller_only_when_asked(
        prefetch, weights):
    server, port = await _fleet_store()
    frt = await PRuntime.connect(port=port)
    cfg = None if prefetch is None else tprefetch.PrefetchConfig(
        replication_target=prefetch, interval_s=0.05)
    watcher = await PModelWatcher(frt, PManager(), namespace=NS,
                                  prefetch_config=cfg).start()
    rt = await PRuntime.connect(port=port)
    eng = port_engine(weights)
    served = await p_register_llm(rt, eng, PModelEntry(
        name="tiny", namespace=NS, component="backend", block_size=PS,
        router_mode="kv"), lease_ttl_s=10.0)
    try:
        await _until(lambda: "tiny" in watcher.fleet_views, "kv model")
        view = watcher.fleet_views["tiny"]
        assert view.indexer is watcher._routers["tiny"].router.indexer
        assert ("tiny" in watcher._prefetchers) == (prefetch is not None)
        if prefetch is not None:
            ctrl = watcher._prefetchers["tiny"]
            # the controller's hint pushes reach the worker over the store
            await _until(lambda: eng.fleet_hints is not None, "hints")
            assert ctrl.ticks >= 1
        await watcher._remove_model("tiny")
        assert not watcher.fleet_views and not watcher._prefetchers
    finally:
        await watcher.stop()
        await served.shutdown()
        await eng.stop()
        await rt.close()
        await frt.close()
        server.close()


# ---------------------------------------------------------------------------
# the query plane: /debug/kv_fleet on both surfaces, /metrics, the tool


def _views():
    tw = Twin()
    _scenario_shared(tw)
    return tw


@pytest.mark.parametrize("query", [
    "", "?top=2", "?model=tiny&top=1", "?model=nope", "?top=x",
])
async def test_frontend_debug_kv_fleet_body_equals_the_jax_services(query):
    tw = _views()
    svc = PService(PManager(), host="127.0.0.1", port=0)
    svc.fleet_views = {"tiny": tw.t, "other": tfleet.FleetKvView(
        TIndexer(BS))}
    rsvc = RService(RManager())
    rsvc.fleet_views = {"tiny": tw.j, "other": jfleet.FleetKvView(
        JIndexer(BS))}
    ref = TestClient(TestServer(rsvc.app))
    await svc.start()
    await ref.start_server()
    try:
        async with HttpClient("127.0.0.1", svc.port) as c:
            r = await c.request("GET", "/debug/kv_fleet" + query)
        want = await ref.get("/debug/kv_fleet" + query)
        assert r.status == want.status
        assert r.json() == await want.json()
    finally:
        await svc.stop()
        await ref.close()


class _HintedEngine:
    def __init__(self, digest):
        self.fleet_hints = None if digest is None else tfleet.FleetHints(
            digest)


@pytest.mark.parametrize("digest", [None, _holder_digest([3, 4, 5])])
async def test_worker_debug_kv_fleet_serves_the_hints(digest):
    srv = await SystemServer(_HintedEngine(digest), host="127.0.0.1",
                             port=0, worker_id="w3").start()
    reng = _HintedEngine(None)
    if digest is not None:
        reng.fleet_hints = jfleet.FleetHints(digest)
    ref = await RSystemServer(reng, host="127.0.0.1", port=0,
                              worker_id="w3").start()
    try:
        bodies = []
        for p in (srv.port, ref.port):
            async with HttpClient("127.0.0.1", p) as c:
                r = await c.request("GET", "/debug/kv_fleet")
            assert r.status == 200
            bodies.append(r.json())
        assert bodies[0] == bodies[1]
        assert (bodies[0]["hints"] is None) == (digest is None)
        async with HttpClient("127.0.0.1", srv.port) as c:
            text = (await c.request("GET", "/metrics")).body.decode()
        for name, kind, _ in FAMILIES:
            assert f"# TYPE {name} {kind}" in text, name
    finally:
        await srv.stop()
        await ref.stop()


async def test_frontend_metrics_carry_the_fleet_families():
    svc = PService(PManager(), host="127.0.0.1", port=0)
    await svc.start()
    KV_FLEET.inc("dynamo_kv_fleet_warm_starts_total")
    try:
        async with HttpClient("127.0.0.1", svc.port) as c:
            text = (await c.request("GET", "/metrics")).body.decode()
        for name, kind, _ in FAMILIES:
            assert f"# TYPE {name} {kind}" in text, name
        assert "dynamo_kv_fleet_warm_starts_total 1" in text
    finally:
        await svc.stop()


TOOL_CASES = {
    "populated": (["--top", "2"], 0),
    "one model": (["--model", "tiny"], 0),
    "empty": (["--model", "other"], 1),
    "unknown model": (["--model", "nope"], 2),
    "unreachable": (None, 2),
    "bad top": (["--top", "0"], 2),
    "no frontend": ([], 2),
}


@pytest.mark.parametrize("case", sorted(TOOL_CASES))
async def test_kv_fleet_tool_exit_contract(case):
    argv, want = TOOL_CASES[case]
    tw = _views()
    svc = PService(PManager(), host="127.0.0.1", port=0)
    svc.fleet_views = {"tiny": tw.t, "other": tfleet.FleetKvView(
        TIndexer(BS))}
    await svc.start()
    addr = f"127.0.0.1:{svc.port}"
    if argv is None:
        args = ["--frontend", "127.0.0.1:1"]
    elif case == "no frontend":
        args = []
    else:
        args = ["--frontend", addr] + argv
    try:
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.tools.kv_fleet", *args,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE,
            cwd=str(ROOT))
        out, err = await proc.communicate()
        assert proc.returncode == want, err.decode()
        if want == 0:
            body = json.loads(out)
            assert body["models"]["tiny"] == _js(tw.j.to_dict(
                top=2 if case == "populated" else 32))
            hottest = body["models"]["tiny"]["hot"][0]
            assert hottest["holders"]
        if case == "unknown model":
            assert "HTTP 404" in err.decode()
        if case == "unreachable":
            assert "cannot reach" in err.decode()
    finally:
        await svc.stop()


def test_kv_fleet_tool_matches_the_jax_packages_tool_against_one_frontend():
    """The port's tool and the JAX package's tools/kv_fleet.py print the
    same JSON and exit the same against the port's frontend."""
    async def run():
        tw = _views()
        svc = PService(PManager(), host="127.0.0.1", port=0)
        svc.fleet_views = {"tiny": tw.t}
        await svc.start()
        try:
            outs = []
            for cmd in (["-m", "dynamo_tpu_torch.tools.kv_fleet"],
                        [str(ROOT / "tools" / "kv_fleet.py")]):
                proc = await asyncio.create_subprocess_exec(
                    sys.executable, *cmd, "--frontend",
                    f"127.0.0.1:{svc.port}", "--top", "3",
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE, cwd=str(ROOT))
                out, _ = await proc.communicate()
                outs.append((proc.returncode, out))
            return outs
        finally:
            await svc.stop()

    (rc_p, out_p), (rc_j, out_j) = asyncio.run(run())
    assert rc_p == rc_j == 0 and out_p == out_j
