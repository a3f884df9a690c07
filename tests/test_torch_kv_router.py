"""The port's KV router (dynamo_tpu_torch/kv_router/, resilience/,
overload/load.py) against the JAX package's, on the CPU.

- Decisions: one seeded stream of KV events (stores, removals, a CLEARED +
  STORED resync, worker removals) goes into both packages' indexers, and
  the same seeded requests into both packages' KvRouter at temperatures
  0, 0.5 and 1.0, each selector drawing from its own ``random.Random``
  seeded alike: every (worker, overlap), every find_matches, the
  predicted blocks and the active blocks after push and free, and the
  heat on the same clock must be identical.
- The parts: the indexer's cases, softmax sampling, the active-sequence
  tracker, the breaker, the health tracker, the load view, the replay
  request and the metrics aggregator, each driven alike in both packages.
- KvPushRouter: re-route, migration, the overload spill and the breaker
  over deterministic fake engines in both packages (same streams, same
  counters), then over tiny f32 TorchEngines on the CPU: prefix traffic
  converges on the warm worker, a dead worker is evicted, a worker dying
  mid-stream migrates with greedy output token-identical to an
  uninterrupted run, and an overload bounce spills without a breaker
  strike.
"""
import asyncio
import random

import numpy as np
import pytest

from dynamo_tpu.kv_router import indexer as r_indexer
from dynamo_tpu.kv_router import metrics_aggregator as r_agg
from dynamo_tpu.kv_router import protocols as r_proto
from dynamo_tpu.kv_router import router as r_router
from dynamo_tpu.kv_router import scheduler as r_sched
from dynamo_tpu.kv_router import sequence as r_seq
from dynamo_tpu.overload import load as r_load
from dynamo_tpu.overload.errors import EngineOverloadedError as REOverload
from dynamo_tpu.overload.metrics import OVERLOAD as R_OVERLOAD
from dynamo_tpu.protocols import common as r_common
from dynamo_tpu.resilience import health as r_health
from dynamo_tpu.resilience import migration as r_migration
from dynamo_tpu.resilience import policy as r_policy
from dynamo_tpu.resilience.metrics import RESILIENCE as R_RESILIENCE
from dynamo_tpu.tokens import TokenBlockSequence as RSeq
from dynamo_tpu_torch.kv_router import indexer as p_indexer
from dynamo_tpu_torch.kv_router import metrics_aggregator as p_agg
from dynamo_tpu_torch.kv_router import protocols as p_proto
from dynamo_tpu_torch.kv_router import router as p_router
from dynamo_tpu_torch.kv_router import scheduler as p_sched
from dynamo_tpu_torch.kv_router import sequence as p_seq
from dynamo_tpu_torch.overload import load as p_load
from dynamo_tpu_torch.overload.errors import EngineOverloadedError as PEOverload
from dynamo_tpu_torch.overload.metrics import OVERLOAD as P_OVERLOAD
from dynamo_tpu_torch.protocols import common as p_common
from dynamo_tpu_torch.resilience import health as p_health
from dynamo_tpu_torch.resilience import migration as p_migration
from dynamo_tpu_torch.resilience import policy as p_policy
from dynamo_tpu_torch.resilience.metrics import RESILIENCE as P_RESILIENCE
from dynamo_tpu_torch.tokens import TokenBlockSequence as PSeq
from dynamo_tpu_torch.tokens import compute_block_hashes

BS = 4
PK = {
    "port": dict(idx=p_indexer, agg=p_agg, proto=p_proto, router=p_router,
                 sched=p_sched, seq=p_seq, load=p_load, common=p_common,
                 health=p_health, migration=p_migration, policy=p_policy,
                 Overload=PEOverload, OVERLOAD=P_OVERLOAD,
                 RESILIENCE=P_RESILIENCE, Seq=PSeq),
    "ref": dict(idx=r_indexer, agg=r_agg, proto=r_proto, router=r_router,
                sched=r_sched, seq=r_seq, load=r_load, common=r_common,
                health=r_health, migration=r_migration, policy=r_policy,
                Overload=REOverload, OVERLOAD=R_OVERLOAD,
                RESILIENCE=R_RESILIENCE, Seq=RSeq),
}
BOTH = pytest.mark.parametrize("pk", ["port", "ref"])


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def stored(pk, worker, hashes, parent=0):
    proto = PK[pk]["proto"]
    return proto.KvCacheEvent(
        kind=proto.KvEventKind.STORED, worker_id=worker, parent_hash=parent,
        blocks=[proto.StoredBlock(block_hash=h) for h in hashes])


def removed(pk, worker, hashes):
    proto = PK[pk]["proto"]
    return proto.KvCacheEvent(kind=proto.KvEventKind.REMOVED,
                              worker_id=worker, removed_hashes=list(hashes))


def cleared(pk, worker):
    proto = PK[pk]["proto"]
    return proto.KvCacheEvent(kind=proto.KvEventKind.CLEARED,
                              worker_id=worker)


# ---------------------------------------------------------------------------
# decisions over one seeded event stream


def _scenario(seed, n_requests=240):
    """A seeded script of operations both packages replay: ("event",
    kind, worker, hashes), ("route", rid, tokens), ("push", rid, token),
    ("free", rid), ("tick", seconds), ("remove_worker", w),
    ("workers", [w...])."""
    rng = np.random.RandomState(seed)
    salt = "tiny"
    families = [rng.randint(3, 500, size=rng.randint(8, 40)).tolist()
                for _ in range(6)]
    workers = ["w0", "w1", "w2"]
    ops = [("workers", list(workers))]
    held = {w: [] for w in workers}
    live = []
    for i in range(n_requests):
        fam = families[rng.randint(len(families))]
        cut = rng.randint(BS, len(fam) + 1)
        tail = rng.randint(3, 500, size=rng.randint(0, 9)).tolist()
        tokens = fam[:cut] + tail
        r = rng.rand()
        if r < 0.35:
            # a worker stores a prefix of this family (a served request)
            w = workers[rng.randint(3)]
            hs = compute_block_hashes(tokens, BS, salt=salt)
            keep = hs[:rng.randint(0, len(hs) + 1)]
            if keep:
                ops.append(("event", "stored", w, keep))
                held[w].extend(keep)
        elif r < 0.45 and any(held.values()):
            w = workers[rng.randint(3)]
            if held[w]:
                k = rng.randint(1, min(4, len(held[w])) + 1)
                gone = [held[w][rng.randint(len(held[w]))]
                        for _ in range(k)]
                ops.append(("event", "removed", w, gone))
        if i == n_requests // 3:
            # the periodic resync: CLEARED, then the whole set re-STORED
            w = "w1"
            ops.append(("event", "cleared", w, []))
            if held[w]:
                ops.append(("event", "stored", w, list(held[w])))
        if i == n_requests // 2:
            # a worker leaves (its lease died) and a new one joins
            ops.append(("remove_worker", "w2"))
            workers = ["w0", "w1", "w3"]
            held["w3"] = []
            ops.append(("workers", list(workers)))
        rid = f"r{i}"
        ops.append(("route", rid, tokens))
        live.append(rid)
        for rid2 in list(live):
            if rng.rand() < 0.3:
                for _ in range(rng.randint(1, 6)):
                    ops.append(("push", rid2, int(rng.randint(3, 500))))
            if rng.rand() < 0.25:
                ops.append(("free", rid2))
                live.remove(rid2)
        ops.append(("tick", float(rng.rand() * 90.0)))
    return ops, salt


def _replay(pk, ops, salt, temperature, seed):
    """Replays the script into one package's KvRouter; returns every
    observable after every operation."""
    m = PK[pk]
    clock = FakeClock()
    router = m["router"].KvRouter(BS, m["sched"].KvRouterConfig(
        router_temperature=temperature))
    router.indexer._clock = clock
    router.scheduler.selector.rng = random.Random(seed)
    seq = m["Seq"]
    out = []
    for op in ops:
        kind = op[0]
        if kind == "workers":
            router.update_workers(op[1])
        elif kind == "remove_worker":
            router.indexer.remove_worker(op[1])
        elif kind == "event":
            _, ek, w, hs = op
            ev = {"stored": lambda: stored(pk, w, hs),
                  "removed": lambda: removed(pk, w, hs),
                  "cleared": lambda: cleared(pk, w)}[ek]()
            router.indexer.apply_event(ev)
        elif kind == "route":
            _, rid, tokens = op
            hs = seq.from_tokens(tokens, BS, salt=salt).block_hashes()
            s = seq.from_tokens(tokens, BS, salt=salt)
            out.append(("potential", router.sequences.potential_blocks(s)))
            out.append(("route", router.find_best_match(rid, tokens,
                                                        salt=salt)))
            m_ = router.indexer.find_matches(hs)
            out.append(("matches", m_.scores, m_.frequencies))
            out.append(("active", router.sequences.active_blocks()))
        elif kind == "push":
            router.push(op[1], op[2])
            out.append(("active", router.sequences.active_blocks()))
        elif kind == "free":
            router.free(op[1])
            out.append(("active", router.sequences.active_blocks()))
        elif kind == "tick":
            clock.advance(op[1])
    idx = router.indexer
    out.append(("heat", sorted((h, round(idx.heat(h), 12))
                               for h in idx._workers)))
    out.append(("hot", idx.hot_blocks(16)))
    out.append(("by_worker", {w: sorted(hs)
                              for w, hs in idx._by_worker.items()}))
    out.append(("total", idx.total_blocks(), idx.events_applied))
    return out


@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.0])
def test_routing_decisions_match_reference(temperature):
    ops, salt = _scenario(seed=7)
    routes = sum(1 for op in ops if op[0] == "route")
    assert routes >= 200
    port = _replay("port", ops, salt, temperature, seed=11)
    ref = _replay("ref", ops, salt, temperature, seed=11)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, (i, a, b)
    # the stream exercises what it claims: overlaps, ties and spread
    decisions = [o[1] for o in port if o[0] == "route"]
    assert sum(1 for _, ov in decisions if ov > 0) > 20
    assert len({w for w, _ in decisions}) >= 3


# ---------------------------------------------------------------------------
# the indexer's cases (reference tests/test_kv_router.py), both packages


@BOTH
def test_indexer_overlap_walk_gap_and_removal(pk):
    idx = PK[pk]["idx"].KvIndexer(BS)
    hashes = compute_block_hashes(list(range(1, 17)), BS)
    idx.apply_event(stored(pk, "w0", hashes[:3]))
    idx.apply_event(stored(pk, "w1", hashes[:1]))
    assert idx.find_matches(hashes).scores == {"w0": 3, "w1": 1}
    idx.apply_event(removed(pk, "w0", [hashes[2]]))
    assert idx.find_matches(hashes).scores == {"w0": 2, "w1": 1}
    # a block some worker holds keeps the walk going for every worker
    idx.apply_event(stored(pk, "w2", [hashes[0], hashes[2]]))
    assert idx.find_matches(hashes).scores["w2"] == 2
    assert idx.find_matches(hashes, early_exit=True).scores == {
        "w0": 1, "w1": 1, "w2": 1}
    idx.remove_worker("w0")
    # the walk stops at the first block no worker holds
    assert idx.find_matches(hashes).scores == {"w1": 1, "w2": 1}
    idx.apply_event(cleared(pk, "w1"))
    assert idx.find_matches(hashes).scores == {"w2": 1}
    assert idx.worker_block_count("w2") == 2
    assert idx.holders(hashes[0]) == {"w2"} and idx.replicas(hashes[1]) == 0


@BOTH
def test_indexer_heat_decays_and_prunes(pk):
    clock = FakeClock()
    idx = PK[pk]["idx"].KvIndexer(BS, freq_halflife_s=10.0, clock=clock)
    hashes = compute_block_hashes(list(range(1, 13)), BS)
    idx.apply_event(stored(pk, "w0", hashes))
    for _ in range(3):
        idx.find_matches(hashes[:2])
    assert idx.heat(hashes[0]) == pytest.approx(3.0)
    clock.advance(10.0)
    assert idx.heat(hashes[0]) == pytest.approx(1.5)
    assert idx.find_matches(hashes).frequencies == [1, 1]
    assert [h for h, _ in idx.hot_blocks(2)] == sorted(
        hashes[:2], key=lambda h: (-idx.heat(h), h))
    clock.advance(200.0)
    # _PRUNE_EVERY events later, the decayed entries are dropped
    for i in range(PK[pk]["idx"]._PRUNE_EVERY):
        idx.apply_event(stored(pk, "w1", [10_000 + i]))
    assert idx._freq == {}
    assert idx.parent_of(hashes[1]) == hashes[0]


@BOTH
def test_indexer_ttl_and_approx_indexer(pk):
    clock = FakeClock()
    idx = PK[pk]["idx"].KvIndexer(BS, expiration_s=5.0, clock=clock)
    hashes = compute_block_hashes(list(range(1, 9)), BS)
    idx.apply_event(stored(pk, "w0", hashes))
    clock.advance(6.0)
    assert idx.find_matches(hashes).scores == {}
    assert idx.total_blocks() == 1  # the walk stopped at the first expiry
    approx = PK[pk]["idx"].ApproxKvIndexer(BS, ttl_s=120.0)
    approx.process_routing_decision("w1", hashes)
    assert approx.find_matches(hashes).scores == {"w1": 2}
    assert idx.find_matches_for_tokens(list(range(1, 9))).scores == {}


def test_softmax_sample_matches_reference():
    rng = np.random.RandomState(3)
    for case in range(300):
        n = rng.randint(1, 6)
        logits = {f"w{i}": float(rng.randint(0, 6)) for i in range(n)}
        t = [0.0, 0.3, 0.5, 1.0, 2.0][case % 5]
        a = [p_sched.softmax_sample(logits, t, random.Random(case))
             for _ in range(3)]
        b = [r_sched.softmax_sample(logits, t, random.Random(case))
             for _ in range(3)]
        assert a == b
    for mod in (p_sched, r_sched):
        with pytest.raises(mod.NoEndpoints):
            mod.softmax_sample({}, 0.5)
        assert mod.softmax_sample({"a": 3.0, "b": 1.0}, 0.0) == "b"


@BOTH
def test_selector_prefers_overlap_and_low_load(pk):
    sched, idx = PK[pk]["sched"], PK[pk]["idx"]
    sel = sched.DefaultWorkerSelector(
        sched.KvRouterConfig(router_temperature=0.0))
    ov = idx.OverlapScores(scores={"w0": 3})
    req = sched.SchedulingRequest(isl_tokens=16, overlap=ov,
                                  potential_blocks={"w0": 4, "w1": 4})
    assert sel.select_worker(["w0", "w1"], req, BS) == ("w0", 3)
    req.potential_blocks = {"w0": 12, "w1": 0}
    assert sel.select_worker(["w0", "w1"], req, BS) == ("w1", 0)
    events = []
    ks = sched.KvScheduler(BS, sel, on_hit_rate=events.append)
    ks.schedule(["w0", "w1"], req)
    assert (events[0].isl_blocks, events[0].overlap_blocks) == (4, 0)
    with pytest.raises(sched.NoEndpoints):
        sel.select_worker([], req, BS)
    assert sched.KvRouterConfig() == sched.KvRouterConfig(1.0, 0.5, 600.0)


@BOTH
def test_active_sequences_shared_blocks_partial_and_push(pk):
    seq_mod, Seq = PK[pk]["seq"], PK[pk]["Seq"]
    a = seq_mod.ActiveSequences(BS)
    s1 = Seq.from_tokens(list(range(1, 11)), BS)   # 2 full + partial
    s2 = Seq.from_tokens(list(range(1, 9)), BS)    # the same 2 full
    assert a.add_request("r1", s1) == 3
    assert a.potential_blocks(s2) == 3
    assert a.add_request("r2", s2) == 3
    for t in (50, 51):
        a.push("r1", t)
    assert a.active_blocks == 3                   # the partial sealed
    a.push("r2", 7)
    assert a.active_blocks == 4
    assert a.free("r1") == 3 and a.free("r2") == 0
    multi = seq_mod.ActiveSequencesMultiWorker(BS, ["w0", "w1"])
    multi.add_request("r", "w0", Seq.from_tokens(list(range(1, 6)), BS))
    assert multi.active_blocks() == {"w0": 2, "w1": 0}
    multi.update_workers(["w1"])
    multi.push("r", 9)
    multi.free("r")
    assert multi.active_blocks() == {"w1": 0}


@BOTH
def test_metrics_aggregator(pk):
    agg_mod, proto = PK[pk]["agg"], PK[pk]["proto"]
    clock = FakeClock()
    agg = agg_mod.MetricsAggregator(stale_after_s=5.0, clock=clock)
    for wid, use in (("a", 0.2), ("b", 0.6)):
        agg.update(proto.ForwardPassMetrics(
            worker_id=wid, kv_stats=proto.KvStats(gpu_cache_usage_perc=use)))
    snap = agg.snapshot()
    assert snap.worker_ids == ["a", "b"]
    assert snap.load_avg() == pytest.approx(0.4)
    assert snap.load_std() == pytest.approx(0.2)
    clock.advance(6.0)
    agg.update(proto.ForwardPassMetrics(worker_id="c"))
    assert agg.snapshot().worker_ids == ["c"]
    agg.remove_worker("c")
    assert agg.snapshot().load_avg() == 0.0


# ---------------------------------------------------------------------------
# breaker, health tracker, load view, replay request: the same script of
# calls through both packages, every observable compared


def _breaker_script(pk):
    pol = PK[pk]["policy"]
    clock = FakeClock()
    b = pol.CircuitBreaker(failure_threshold=2, reset_timeout_s=5.0,
                           clock=clock)
    seen = []
    for op in ("fail", "ok", "fail", "fail", "allow", "tick", "peek",
               "allow", "allow", "ok_stray", "fail", "tick", "allow", "ok",
               "allow"):
        if op == "fail":
            b.record_failure()
        elif op in ("ok", "ok_stray"):
            b.record_success()
        elif op == "allow":
            seen.append(b.allow())
        elif op == "peek":
            seen.append(b.peek_allow())
        elif op == "tick":
            clock.advance(6.0)
        seen.append((b.state.value, b.consecutive_failures, b.trips))
    with pytest.raises(ValueError):
        pol.CircuitBreaker(failure_threshold=0)
    return seen


def test_circuit_breaker_matches_reference():
    seen = _breaker_script("port")
    assert seen == _breaker_script("ref")
    assert ("open", 2, 1) in seen and ("half_open", 2, 1) in seen
    assert seen[-1] == ("closed", 0, 1)


def _health_script(pk):
    m = PK[pk]
    clock = FakeClock()
    h = m["health"].WorkerHealthTracker(failure_threshold=2,
                                        reset_timeout_s=5.0, clock=clock)
    R = m["RESILIENCE"]
    seen = []
    h.observe_metrics(m["proto"].ForwardPassMetrics(worker_id="a"))
    h.record_failure("a")
    seen.append(h.blocked(["a", "b"]))
    h.record_failure("a")
    seen.append((h.blocked(["a", "b"]), R.get(
        "dynamo_resilience_breaker_open"), h.states()))
    clock.advance(6.0)
    seen.append(h.blocked(["a"]))       # probe grant not consumed
    h.on_routed("a")                    # the dispatch is the probe
    seen.append((h.blocked(["a"]), h.states()))
    h.freeze()
    clock.advance(1.0)
    h.thaw()
    seen.append(h._last_seen == {"a": clock.now})
    h.record_success("a")
    seen.append((h.blocked(["a"]), h.states(),
                 R.get("dynamo_resilience_breaker_open")))
    h.record_failure("b")
    h.forget("b")
    seen.append((h.states(), h.breaker("c").state.value))
    return seen


def test_health_tracker_matches_reference():
    assert _health_script("port") == _health_script("ref")


def _load_script(pk):
    m = PK[pk]
    proto = m["proto"]
    clock = FakeClock()
    view = m["load"].WorkerLoadView(stale_after_s=5.0, clock=clock)
    seen = []

    def pub(wid, waiting, max_waiting=0, qsnap=None):
        ws = proto.WorkerStats(num_requests_waiting=waiting,
                               max_waiting_requests=max_waiting)
        hist = {"dynamo_request_queue_seconds": qsnap} if qsnap else {}
        view.observe(proto.ForwardPassMetrics(worker_id=wid,
                                              worker_stats=ws,
                                              histograms=hist))

    snap = {"buckets": [0.1, 0.5, 1.0], "counts": [2, 6, 8, 8],
            "sum": 3.0, "count": 8}
    pub("a", 4, max_waiting=4)
    pub("b", 30, qsnap=snap)
    pub("c", 1)
    seen.append(view.blocked(["a", "b", "c"]))
    seen.append(view.est_wait_s("b"))
    import time as _t
    seen.append(view.blocked(["a", "b", "c"], deadline=_t.time() + 3.0))
    view.note_overloaded("c", 2.0)
    seen.append(view.blocked(["c"]))
    clock.advance(2.5)
    seen.append(view.blocked(["a", "b", "c"]))
    view.freeze()
    clock.advance(10.0)
    seen.append(view.blocked(["a", "b", "c"]))   # frozen: still fresh
    view.thaw()
    seen.append(view.saturated("a"))
    clock.advance(6.0)
    seen.append(view.blocked(["a", "b", "c"]))   # stale: never blocks
    view.forget("a")
    seen.append(view.saturated("a"))
    return seen


def test_load_view_matches_reference():
    seen = _load_script("port")
    assert seen == _load_script("ref")
    assert seen[0] == {"a"} and "b" in seen[2]


@BOTH
def test_build_replay_request(pk):
    c, mig = PK[pk]["common"], PK[pk]["migration"]
    req = c.PreprocessedRequest(
        token_ids=[1, 2, 3], estimated_prefix_hit_num_blocks=2,
        stop_conditions=c.StopConditions(max_tokens=10, min_tokens=5))
    r = mig.build_replay_request(req, [7, 8])
    assert r.token_ids == [1, 2, 3, 7, 8]
    assert (r.stop_conditions.max_tokens, r.stop_conditions.min_tokens) \
        == (8, 3)
    assert r.estimated_prefix_hit_num_blocks is None
    assert req.token_ids == [1, 2, 3] and req.stop_conditions.max_tokens == 10
    assert mig.build_replay_request(req, list(range(10))) is None
    assert mig.MigrationPolicy().budget(3) == 2
    assert mig.MigrationPolicy(max_migrations=1).budget(5) == 1


def test_resilience_and_overload_families_are_the_references():
    for name, typ, help_ in P_RESILIENCE._families:
        assert (name, typ, help_) in R_RESILIENCE._families
    # the whole overload family set since the overload plane's port
    assert P_OVERLOAD._families == R_OVERLOAD._families
    text = P_RESILIENCE.render()
    for name in ("dynamo_migration_total", "dynamo_migration_failed_total",
                 "dynamo_migration_replayed_tokens_total",
                 "dynamo_resilience_reroute_total",
                 "dynamo_resilience_breaker_open"):
        assert f"# TYPE {name} " in text


# ---------------------------------------------------------------------------
# KvPushRouter over deterministic fake engines, both packages


def _lcg_next(toks):
    return (toks[-1] * 1103515245 + len(toks) * 12345 + 7) % 997


def lcg_sequence(prompt, n):
    toks, out = list(prompt), []
    for _ in range(n):
        t = _lcg_next(toks)
        toks.append(t)
        out.append(t)
    return out


class LcgEngine:
    """A greedy 'model' whose next token is a pure function of the
    sequence so far: replaying prompt + emitted continues identically."""

    def __init__(self, common):
        self.c, self.served = common, 0

    async def generate(self, req):
        self.served += 1
        toks = list(req.token_ids)
        mt = req.stop_conditions.max_tokens or 8
        for i in range(mt):
            await asyncio.sleep(0)
            t = _lcg_next(toks)
            toks.append(t)
            fin = self.c.FinishReason.LENGTH if i == mt - 1 else None
            yield self.c.LLMEngineOutput(token_ids=[t], finish_reason=fin)


class Assassin:
    """Wraps an engine: after ``kill_after`` tokens of a request not in
    ``killed`` yet, it dies (ConnectionError); ``killed`` is shared, so
    the replay survives anywhere."""

    def __init__(self, inner, kill_after, killed):
        self.inner, self.kill_after, self.killed = inner, kill_after, killed

    async def generate(self, req):
        arm = req.request_id not in self.killed
        n = 0
        src = self.inner.generate(req)
        try:
            async for out in src:
                yield out
                n += len(out.token_ids)
                if arm and n >= self.kill_after:
                    self.killed.add(req.request_id)
                    raise ConnectionError("worker died mid-stream")
        finally:
            await src.aclose()


class Dead:
    def __init__(self):
        self.attempts = 0

    async def generate(self, req):
        self.attempts += 1
        raise ConnectionError("connection refused")
        yield  # pragma: no cover


class Bouncer:
    """Refuses admission (EngineOverloadedError) the first ``n`` times."""

    def __init__(self, err_cls, inner=None, n=1, retry_after_s=30.0):
        self.err, self.inner, self.n = err_cls, inner, n
        self.retry_after_s, self.bounced = retry_after_s, 0

    async def generate(self, req):
        if self.bounced < self.n:
            self.bounced += 1
            raise self.err("queue full", retry_after_s=self.retry_after_s)
        async for out in self.inner.generate(req):
            yield out


def make_push(pk, engines, bs=BS, rng=None, **kw):
    """A KvPushRouter over ``engines`` at temperature 0; with ``rng`` (a
    random.Random) the selector breaks ties by its draws, else by the
    process's unseeded ``random``."""
    m = PK[pk]
    router = m["router"].KvRouter(bs, m["sched"].KvRouterConfig(
        router_temperature=0.0))
    if rng is not None:
        router.scheduler.selector.rng = rng
    push = m["router"].KvPushRouter(router, dict(engines), **kw)
    push.retry.base_delay_s = 0.001
    return push


def _req(pk, prompt, max_tokens=12):
    c = PK[pk]["common"]
    return c.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=c.StopConditions(max_tokens=max_tokens,
                                         ignore_eos=True))


async def _drive(push, req):
    toks, fins = [], []
    async for out in push.generate(req):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            fins.append(out.finish_reason)
    return toks, fins


class Counts:
    """Deltas of the process-wide counters over a block."""

    def __init__(self, pk):
        self.R, self.O = PK[pk]["RESILIENCE"], PK[pk]["OVERLOAD"]
        self.r0, self.o0 = self.R.snapshot(), self.O.snapshot()

    def __call__(self, name):
        reg, base = ((self.O, self.o0) if name.startswith("dynamo_overload")
                     else (self.R, self.r0))
        return reg.get(name) - base[name]


@BOTH
async def test_reroute_before_first_token_evicts_and_recovers(pk):
    c = PK[pk]["common"]
    dead, ok = Dead(), LcgEngine(c)
    push = make_push(pk, {"dead": dead, "ok": ok})
    prompt = list(range(1, 17))
    hashes = compute_block_hashes(prompt, BS)
    push.router.indexer.apply_event(stored(pk, "dead", hashes))
    n = Counts(pk)
    toks, fins = await _drive(push, _req(pk, prompt, 6))
    assert toks == lcg_sequence(prompt, 6) and fins == ["length"]
    assert dead.attempts == 1 and ok.served == 1
    assert "dead" not in push.workers
    assert push.router.indexer.find_matches(hashes).scores == {}
    assert push.reroutes == 1
    assert n("dynamo_resilience_reroute_total") == 1
    assert n("dynamo_migration_total") == 0
    # all workers dead: ConnectionError, and the table empties
    push = make_push(pk, {"d1": Dead(), "d2": Dead()})
    with pytest.raises(ConnectionError):
        await _drive(push, _req(pk, range(1, 9)))
    assert not push.workers


@BOTH
async def test_migration_is_exactly_once(pk):
    c = PK[pk]["common"]
    prompt = list(range(10, 26))
    killed: set = set()
    push = make_push(pk, {"w0": Assassin(LcgEngine(c), 4, killed),
                          "w1": Assassin(LcgEngine(c), 4, killed)})
    n = Counts(pk)
    toks, fins = await _drive(push, _req(pk, prompt, 12))
    assert toks == lcg_sequence(prompt, 12) and fins == ["length"]
    assert push.migrations == 1 and len(killed) == 1
    assert n("dynamo_migration_total") == 1
    assert n("dynamo_migration_replayed_tokens_total") == 4
    assert n("dynamo_migration_failed_total") == 0
    # the breaker took one strike for the dead stream
    assert sorted(b.consecutive_failures
                  for b in push.health._breakers.values()) == [1]


@BOTH
async def test_migration_edges(pk):
    c = PK[pk]["common"]

    class DiesAtBudget:
        async def generate(self, req):
            toks = list(req.token_ids)
            for _ in range(req.stop_conditions.max_tokens):
                t = _lcg_next(toks)
                toks.append(t)
                yield c.LLMEngineOutput(token_ids=[t])
            raise ConnectionError("died holding the last token")

    class DiesAfterFinish:
        async def generate(self, req):
            toks, mt = list(req.token_ids), req.stop_conditions.max_tokens
            for i in range(mt):
                t = _lcg_next(toks)
                toks.append(t)
                yield c.LLMEngineOutput(
                    token_ids=[t],
                    finish_reason=c.FinishReason.LENGTH if i == mt - 1
                    else None)
            raise ConnectionError("died after the finish frame")

    class AlwaysDies:
        async def generate(self, req):
            yield c.LLMEngineOutput(token_ids=[_lcg_next(
                list(req.token_ids))])
            raise ConnectionError("always dies")

    n = Counts(pk)
    for Eng, prompt in ((DiesAtBudget, range(50, 66)),
                        (DiesAfterFinish, range(70, 86))):
        push = make_push(pk, {"w0": Eng(), "w1": LcgEngine(c)})
        toks, fins = await _drive(push, _req(pk, prompt, 5))
        assert toks == lcg_sequence(list(prompt), 5)
        assert fins == ["length"] and push.migrations == 0
    assert n("dynamo_migration_total") == 0
    mig = PK[pk]["migration"]
    push = make_push(pk, {"w0": AlwaysDies(), "w1": AlwaysDies()},
                     migration=mig.MigrationPolicy(max_migrations=3))
    with pytest.raises(ConnectionError):
        await _drive(push, _req(pk, range(1, 9), 6))
    assert n("dynamo_migration_failed_total") >= 1
    killed: set = set()
    push = make_push(pk, {"w0": Assassin(LcgEngine(c), 2, killed),
                          "w1": Assassin(LcgEngine(c), 2, killed)},
                     migration=mig.MigrationPolicy(enabled=False))
    with pytest.raises(ConnectionError):
        await _drive(push, _req(pk, range(1, 9), 8))


@BOTH
async def test_breaker_excludes_failing_worker(pk):
    c, health = PK[pk]["common"], PK[pk]["health"]
    clock = FakeClock()
    h = health.WorkerHealthTracker(failure_threshold=2, reset_timeout_s=30.0,
                                   clock=clock)

    class DiesEveryTime:
        def __init__(self):
            self.calls = 0

        async def generate(self, req):
            self.calls += 1
            yield c.LLMEngineOutput(token_ids=[_lcg_next(
                list(req.token_ids))])
            raise ConnectionError("mid-stream death")

    bad, ok = DiesEveryTime(), LcgEngine(c)
    # seeded ties: the breaker opens only if ``bad`` is chosen twice (under
    # seed 1 it is, in both packages; seed 0 sends it one request)
    push = make_push(pk, {"bad": bad, "ok": ok}, health=h,
                     rng=random.Random(1))
    for i in range(8):
        prompt = list(range(i * 7 + 1, i * 7 + 9))
        toks, _ = await _drive(push, _req(pk, prompt, 4))
        assert toks == lcg_sequence(prompt, 4)
    assert bad.calls >= 2, bad.calls
    assert h.breaker("bad").state.value == "open"
    calls = bad.calls
    for i in range(3):
        await _drive(push, _req(pk, range(100 + i * 7, 108 + i * 7), 4))
    assert bad.calls == calls and "bad" in push.workers


@BOTH
async def test_overload_bounce_spills_without_a_breaker_strike(pk):
    c, m = PK[pk]["common"], PK[pk]
    bouncer = Bouncer(m["Overload"], LcgEngine(c), n=1, retry_after_s=30.0)
    ok = LcgEngine(c)
    push = make_push(pk, {"busy": bouncer, "ok": ok})
    prompt = list(range(1, 17))
    push.router.indexer.apply_event(
        stored(pk, "busy", compute_block_hashes(prompt, BS)))
    n = Counts(pk)
    toks, _ = await _drive(push, _req(pk, prompt, 4))
    assert toks == lcg_sequence(prompt, 4)
    assert (bouncer.bounced, ok.served) == (1, 1)
    assert n("dynamo_overload_router_spills_total") == 1
    assert "busy" in push.workers and not push.health._breakers
    assert push.load.blocked(["busy", "ok"]) == {"busy"}
    # cooling down: the warm worker is skipped while a peer is free
    await _drive(push, _req(pk, prompt, 4))
    assert ok.served == 2
    # every worker bouncing: the fleet's overload, typed and retriable
    push = make_push(pk, {
        "a": Bouncer(m["Overload"], n=9, retry_after_s=2.5),
        "b": Bouncer(m["Overload"], n=9, retry_after_s=2.5)})
    with pytest.raises(m["Overload"]) as ei:
        await _drive(push, _req(pk, prompt, 4))
    assert ei.value.retry_after_s == 2.5


@BOTH
async def test_clear_kv_blocks_fans_out_and_empties_the_indexer(pk):
    class Clearable(LcgEngine):
        def __init__(self, common, held):
            super().__init__(common)
            self.held = held

        async def clear_kv_blocks(self):
            n, self.held = self.held, 0
            return n

    c = PK[pk]["common"]
    push = make_push(pk, {"a": Clearable(c, 3), "b": Clearable(c, 4),
                          "plain": LcgEngine(c)})
    for w in ("a", "b", "plain"):
        push.router.indexer.apply_event(stored(pk, w, [hash(w) & 0xFFFF]))
    decisions = []
    push.on_decision = decisions.append
    await _drive(push, _req(pk, range(1, 9), 2))
    assert len(decisions) == 1 and decisions[0] >= 0
    assert await push.clear_kv_blocks() == 7
    assert set(push.router.indexer._by_worker) == {"plain"}


# ---------------------------------------------------------------------------
# KvPushRouter over tiny f32 TorchEngines on the CPU

KW = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
          max_decode_slots=4, prefill_buckets=(32, 64),
          cache_dtype="float32")


@pytest.fixture(scope="module")
def torch_engines():
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.tiny(dtype="float32")
    params = llama.init_params(cfg, 0, device="cpu")
    engines = [TorchEngine(cfg, EngineConfig(**KW), params=params,
                           device="cpu") for _ in range(3)]
    yield engines
    for e in engines:
        asyncio.run(e.stop())


class Counted:
    def __init__(self, inner):
        self.inner, self.served, self.prompts = inner, 0, []

    async def generate(self, req):
        self.served += 1
        self.prompts.append(list(req.token_ids))
        async for out in self.inner.generate(req):
            yield out


def _attach(push, engines):
    """Workers w0.. over the engines, each allocator's events fed to the
    router's indexer on the test's loop (the engine fires them on its own
    thread, before the outputs of the round that stored them)."""
    loop = asyncio.get_running_loop()
    wrapped = {}
    for i, e in enumerate(engines):
        wid = f"w{i}"
        e.clear_kv_blocks()
        e.allocator.worker_id = wid
        e.allocator.on_event = (
            lambda ev, idx=push.router.indexer:
            loop.call_soon_threadsafe(idx.apply_event, ev))
        wrapped[wid] = Counted(e)
        push.add_worker(wid, wrapped[wid])
    return wrapped


def _detach(engines):
    for e in engines:
        e.allocator.on_event = None


def _preq(prompt, max_tokens, model="tiny"):
    return p_common.PreprocessedRequest(
        token_ids=list(prompt), model=model,
        stop_conditions=p_common.StopConditions(max_tokens=max_tokens,
                                                ignore_eos=True))


async def _direct(engine, prompt, max_tokens):
    toks = []
    async for out in engine.generate(_preq(prompt, max_tokens)):
        toks.extend(out.token_ids)
    return toks


async def test_prefix_traffic_converges_on_the_warm_torch_engine(
        torch_engines):
    push = make_push("port", {}, bs=KW["page_size"])
    wrapped = _attach(push, torch_engines)
    try:
        prefix = list(range(5, 69))  # 4 blocks of 16

        async def one(i):
            toks, _ = await _drive(push, _preq(prefix + [100 + i], 4))
            assert len(toks) == 4
            await asyncio.sleep(0.05)  # the STORED events land

        await one(0)
        warm = [w for w, e in wrapped.items() if e.served][0]
        hits = []
        for i in range(1, 8):
            push.router.scheduler.on_hit_rate = hits.append
            await one(i)
        assert wrapped[warm].served == 8
        assert sorted(e.served for e in wrapped.values()) == [0, 0, 8]
        assert all(h.worker_id == warm and h.overlap_blocks == 4
                   for h in hits), hits
        assert push.router.sequences.active_blocks() == {
            w: 0 for w in wrapped}
    finally:
        _detach(torch_engines)


async def test_dead_torch_worker_is_evicted_and_rerouted(torch_engines):
    eng = torch_engines[0]
    prompt = list(range(7, 47))
    want = await _direct(eng, prompt, 6)
    push = make_push("port", {}, bs=KW["page_size"])
    _attach(push, [eng])
    try:
        dead = Dead()
        push.add_worker("dead", dead)
        hs = compute_block_hashes(prompt, 16, salt="tiny")
        push.router.indexer.apply_event(stored("port", "dead", hs))
        n = Counts("port")
        toks, fins = await _drive(push, _preq(prompt, 6))
        assert toks == want and fins == ["length"]
        assert dead.attempts == 1 and "dead" not in push.workers
        assert n("dynamo_resilience_reroute_total") == 1
        push.remove_worker("w0")
        with pytest.raises(ConnectionError):
            await _drive(push, _preq(prompt, 6))
    finally:
        _detach([eng])


async def test_torch_worker_dying_mid_stream_migrates_token_identically(
        torch_engines):
    prompt = list(range(3, 40))
    want = await _direct(torch_engines[2], prompt, 16)
    killed: set = set()
    push = make_push("port", {}, bs=KW["page_size"])
    wrapped = _attach(push, torch_engines[:2])
    try:
        for w in list(push.workers):
            push.workers[w] = Assassin(wrapped[w], 6, killed)
        n = Counts("port")
        toks, fins = await _drive(push, _preq(prompt, 16))
        assert toks == want and fins == ["length"]
        assert push.migrations == 1 and len(killed) == 1
        assert n("dynamo_migration_total") == 1
        replayed = n("dynamo_migration_replayed_tokens_total")
        assert 6 <= replayed < 16
        # the survivor's prefill was the prompt plus what was delivered
        served = [e for e in wrapped.values() if len(e.prompts) == 1]
        assert any(e.prompts[0] == prompt + want[:int(replayed)]
                   for e in served)
    finally:
        _detach(torch_engines[:2])


async def test_overload_bounce_spills_to_a_torch_peer(torch_engines):
    prompt = list(range(11, 60))
    want = await _direct(torch_engines[1], prompt, 5)
    push = make_push("port", {}, bs=KW["page_size"])
    wrapped = _attach(push, torch_engines[:2])
    try:
        push.workers["w0"] = Bouncer(PEOverload, wrapped["w0"], n=1)
        push.router.indexer.apply_event(stored(
            "port", "w0", compute_block_hashes(prompt, 16, salt="tiny")))
        n = Counts("port")
        toks, _ = await _drive(push, _preq(prompt, 5))
        assert toks == want
        assert wrapped["w1"].served == 1 and wrapped["w0"].served == 0
        assert n("dynamo_overload_router_spills_total") == 1
        assert not push.health._breakers and "w0" in push.workers
    finally:
        _detach(torch_engines[:2])
