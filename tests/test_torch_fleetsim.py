"""The port's fleet simulator (dynamo_tpu_torch/fleetsim/) against the
JAX package's:

- clocks: the real clock passes through, a virtual clock compresses time
  and never runs backwards, a non-positive rate is refused with the
  reference's message;
- ``diurnal_trace``, ``mmpp_trace`` and ``PromptPopulation`` give the
  same requests as the reference's for the same seed, and either package
  reads the other's JSONL;
- ``SimConnector`` scales a ``SimFleet`` of the port's mockers up and
  down (newest first, by drain) over the port's store, and the port's
  ModelWatcher follows it;
- 32 in-process workers register against a batch-fsync store, the
  watcher discovers every one and an MMPP burst routes through the
  port's KvPushRouter with no failure;
- the port's mocker on a 50x virtual clock gives the real clock's tokens
  in a fraction of the wall time."""
import asyncio
import time

import pytest

from dynamo_tpu.fleetsim import clock as rclock
from dynamo_tpu.fleetsim import traces as rtr
from dynamo_tpu_torch.fleetsim import REAL_CLOCK, Clock, VirtualClock
from dynamo_tpu_torch.fleetsim import traces as ptr
from dynamo_tpu_torch.fleetsim.sim import SimConnector, SimFleet
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.store import serve_store

# ---------------------------------------------------------------- clock


def test_real_clock_is_default_and_passthrough():
    assert REAL_CLOCK.rate == rclock.REAL_CLOCK.rate == 1.0
    before = time.monotonic()
    mid = REAL_CLOCK.monotonic()
    after = time.monotonic()
    assert before <= mid <= after
    assert abs(REAL_CLOCK.time() - time.time()) < 1.0
    assert REAL_CLOCK.to_wall(7.5) == 7.5


@pytest.mark.parametrize("rate", [0, -3, -0.5])
def test_virtual_clock_refuses_a_nonpositive_rate(rate):
    with pytest.raises(ValueError) as want:
        rclock.VirtualClock(rate=rate)
    with pytest.raises(ValueError) as got:
        VirtualClock(rate=rate)
    assert str(got.value) == str(want.value)


async def test_virtual_clock_compresses_and_never_regresses():
    clk = VirtualClock(rate=20.0)
    assert clk.to_wall(2.0) == 0.1
    seen = [clk.monotonic() for _ in range(1000)]
    assert seen == sorted(seen)
    v0, w0 = clk.monotonic(), time.monotonic()
    await clk.sleep(1.0)   # one virtual second: ~50 ms of wall time
    dv, dw = clk.monotonic() - v0, time.monotonic() - w0
    assert dv >= 1.0
    assert dw < 0.5
    await clk.sleep(-1.0)   # a negative sleep returns at once


def test_clock_subclass_contract():
    class Fixed(Clock):
        def monotonic(self):
            return 42.0

    assert Fixed().monotonic() == 42.0
    assert Fixed().to_wall(3.0) == 3.0
    assert isinstance(VirtualClock(), Clock)


# --------------------------------------------------------------- traces

TRACES = [
    ("diurnal", dict(duration_s=30.0, base_rps=1.0, peak_rps=6.0,
                     period_s=20.0, seed=3)),
    ("diurnal", dict(duration_s=12.5, base_rps=0.0, peak_rps=3.0,
                     period_s=10.0, seed=0, max_tokens=4)),
    ("mmpp", dict(duration_s=40.0, calm_rps=1.0, burst_rps=9.0, seed=7)),
    ("mmpp", dict(duration_s=20.0, calm_rps=0.5, burst_rps=5.0,
                  p_calm_to_burst=0.3, p_burst_to_calm=0.5, seed=11)),
]


def _trace(mod, kind, kw, pop_kw=None):
    kw = dict(kw)
    if pop_kw is not None:
        kw["population"] = mod.PromptPopulation(**pop_kw)
    fn = mod.diurnal_trace if kind == "diurnal" else mod.mmpp_trace
    return fn(**kw)


@pytest.mark.parametrize("pop", [None, dict(n_prefixes=4, prefix_len=8,
                                            suffix_len=3, vocab=50,
                                            zipf_a=1.5, seed=5)],
                         ids=["default", "small"])
@pytest.mark.parametrize("i", range(len(TRACES)))
def test_traces_equal_the_reference(i, pop):
    kind, kw = TRACES[i]
    ref = _trace(rtr, kind, kw, pop)
    port = _trace(ptr, kind, kw, pop)
    assert ref, "an empty trace compares nothing"
    assert [r.to_json() for r in port] == [r.to_json() for r in ref]
    arrivals = [r.arrival_s for r in port]
    assert arrivals == sorted(arrivals)
    assert all(0 <= a < kw["duration_s"] for a in arrivals)


def test_prompt_population_equals_the_reference():
    import random

    kw = dict(n_prefixes=3, prefix_len=10, suffix_len=4, seed=9)
    rp, pp = rtr.PromptPopulation(**kw), ptr.PromptPopulation(**kw)
    assert pp.prefixes == rp.prefixes and pp._cdf == rp._cdf
    r1, r2 = random.Random(1), random.Random(1)
    samples = [pp.sample(r1) for _ in range(50)]
    assert samples == [rp.sample(r2) for _ in range(50)]
    # shared prefixes: every sample starts with one of the 3
    assert {tuple(s[:10]) for s in samples} <= {tuple(p) for p in pp.prefixes}


def test_jsonl_reads_across_packages(tmp_path):
    trace = _trace(rtr, *TRACES[2])
    ref_file, port_file = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    rtr.save_jsonl(str(ref_file), trace)
    ptr.save_jsonl(str(port_file), _trace(ptr, *TRACES[2]))
    assert port_file.read_bytes() == ref_file.read_bytes()
    back = ptr.load_jsonl(str(ref_file))
    assert [r.to_json() for r in back] == [r.to_json() for r in trace]
    assert isinstance(back[0], ptr.TraceRequest)
    again = rtr.load_jsonl(str(port_file))
    assert [r.to_json() for r in again] == [r.to_json() for r in trace]


# ------------------------------------------ sim fleet against a live store


async def _discover(watcher, name, n, tries=400):
    push = None
    for _ in range(tries):
        push = watcher._routers.get(name)
        if push is not None and len(push.workers) >= n:
            return push
        await asyncio.sleep(0.02)
    raise AssertionError(
        f"fleet never discovered ({0 if push is None else len(push.workers)}"
        f"/{n})")


def _sim_stack(namespace):
    from dynamo_tpu_torch.frontend.watcher import ModelEntry
    from dynamo_tpu_torch.mocker import MockerArgs

    entry = ModelEntry(name="sim-model", namespace=namespace,
                       component="backend", block_size=16,
                       router_mode="kv")

    def make_args(idx):
        return MockerArgs(num_pages=64, page_size=16, max_decode_slots=4,
                          prefill_time_per_token_s=1e-5,
                          decode_time_per_step_s=1e-4)

    return entry, make_args


async def _watcher(port, namespace, fleet):
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig

    rt = await DistributedRuntime.connect(port=port)
    watcher = await ModelWatcher(
        rt, ModelManager(), namespace=namespace,
        router_config=KvRouterConfig(router_temperature=0.0),
        engine_factory=fleet.engine_factory).start()
    return rt, watcher


async def test_sim_connector_scales_and_drains_live_store():
    server, store = await serve_store(port=0, sweep_interval_s=0.1)
    port = server.sockets[0].getsockname()[1]
    rt = await DistributedRuntime.connect(port=port)
    entry, make_args = _sim_stack("fleetsim_test")
    fleet = SimFleet(rt, entry, make_args, lease_ttl_s=30.0,
                     metrics_interval_s=5.0)
    frontend_rt, watcher = await _watcher(port, "fleetsim_test", fleet)
    conn = SimConnector(fleet)
    try:
        await conn.set_replicas(4)
        assert conn.current_replicas() == 4
        # registrations are real: leased instance keys live in the store
        prefix = "dynamo://fleetsim_test/_components/backend/generate/"
        assert len(store.get_prefix(prefix)) == 4
        push = await _discover(watcher, "sim-model", 4)
        first = sorted(fleet.engines)
        # newest-first drain revokes leases: their keys vanish
        await conn.set_replicas(1)
        assert conn.current_replicas() == 1
        assert len(store.get_prefix(prefix)) == 1
        assert sorted(fleet.engines) == first[:1]
        for _ in range(200):
            if len(push.workers) == 1:
                break
            await asyncio.sleep(0.02)
        assert list(push.workers) == first[:1]
        assert conn.calls == [4, 1]
    finally:
        await watcher.stop()
        await fleet.stop()
        await frontend_rt.close()
        await rt.close()
        server.close()


async def test_fleet_sim_smoke_32_workers(tmp_path):
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )

    n = 32
    server, store = await serve_store(
        port=0, sweep_interval_s=0.5,
        journal_path=str(tmp_path / "wal.jsonl"), fsync_mode="batch")
    port = server.sockets[0].getsockname()[1]
    rt = await DistributedRuntime.connect(port=port)
    entry, make_args = _sim_stack("fleetsim_smoke")
    fleet = SimFleet(rt, entry, make_args, lease_ttl_s=30.0,
                     metrics_interval_s=5.0)
    frontend_rt, watcher = await _watcher(port, "fleetsim_smoke", fleet)
    try:
        rev0 = store.revision
        await fleet.scale_to(n)
        assert store.revision > rev0
        push = await _discover(watcher, "sim-model", n)
        decisions = []
        push.on_decision = decisions.append
        trace = ptr.mmpp_trace(
            5.0, 4.0, 16.0, seed=2, max_tokens=4,
            population=ptr.PromptPopulation(n_prefixes=4, prefix_len=32,
                                            suffix_len=8, seed=2))
        failed = 0

        async def one(tr):
            nonlocal failed
            req = PreprocessedRequest(
                token_ids=list(tr.token_ids),
                stop_conditions=StopConditions(max_tokens=tr.max_tokens,
                                               ignore_eos=True))
            try:
                toks = [t async for o in push.generate(req)
                        for t in o.token_ids]
                assert len(toks) == tr.max_tokens
            except Exception:  # noqa: BLE001 - counted, asserted zero
                failed += 1

        await asyncio.gather(*[one(tr) for tr in trace])
        assert trace and failed == 0
        assert len(push.workers) == n
        assert len(decisions) == len(trace)
        assert all(d >= 0 for d in decisions)
    finally:
        await watcher.stop()
        await fleet.stop()
        await frontend_rt.close()
        await rt.close()
        server.close()
        store.close_journal()


async def test_mocker_on_virtual_clock_compresses_decode():
    """A stream whose simulated decode takes ~1.6 virtual seconds ends in
    well under that on a 50x clock, with the real clock's tokens."""
    from dynamo_tpu_torch.mocker import MockerArgs, MockerEngine
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )

    def make(clock=None):
        return MockerEngine(MockerArgs(
            num_pages=64, page_size=16, max_decode_slots=4,
            prefill_time_per_token_s=0.001,
            decode_time_per_step_s=0.1,
        ), clock=clock)

    async def run(eng):
        req = PreprocessedRequest(
            token_ids=list(range(1, 33)),
            stop_conditions=StopConditions(max_tokens=16, ignore_eos=True))
        toks = [t async for o in eng.generate(req) for t in o.token_ids]
        await eng.stop()
        return toks

    t0 = time.monotonic()
    fast = await run(make(clock=VirtualClock(rate=50.0)))
    assert time.monotonic() - t0 < 1.0
    slow = await run(make())
    assert fast == slow == [list(range(1, 33))[i % 32] for i in range(16)]
