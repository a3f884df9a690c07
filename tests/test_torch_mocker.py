"""The port's mocker (dynamo_tpu_torch/mocker.py) against the JAX
package's, on the same requests:

- token streams, finish reasons and finishing annotation keys;
- the KV events, stored and removed, hash for hash and in order;
- the ForwardPassMetrics each step publishes (histograms by count: their
  sums are wall times);
- preemptions under page pressure, prefix hits, deadline sheds, overload
  and tenant refusals (the error, its message, the counters they move)
  and drain;
- decode steps due a step apart: where each sleep overshoots, the port
  keeps the configured cadence and the reference's steps lengthen (the
  port's deliberate difference);
- ``in=text out=mocker`` prints what the reference launcher prints.

The requests of a scenario reach the engine before its loop first runs
and prefill costs no simulated time, so both packages schedule them
alike: the scenario's outcome does not depend on the wall clock. Every
comparison is exact."""
import asyncio
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dynamo_tpu import mocker as rm
from dynamo_tpu.overload import OVERLOAD as R_OVERLOAD
from dynamo_tpu.protocols import common as rc
from dynamo_tpu.tenancy import TENANT as R_TENANT
from dynamo_tpu_torch import mocker as pm
from dynamo_tpu_torch.overload.metrics import OVERLOAD as P_OVERLOAD
from dynamo_tpu_torch.protocols import common as pc
from dynamo_tpu_torch.tenancy import TENANT as P_TENANT

ROOT = Path(__file__).resolve().parent.parent
PKG = {"ref": (rm, rc, R_OVERLOAD, R_TENANT),
       "port": (pm, pc, P_OVERLOAD, P_TENANT)}


def _request(common, prompt, max_tokens, *, stop=None, logprobs=None,
             tenant=None, deadline=None, rid=""):
    r = common.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=common.StopConditions(
            max_tokens=max_tokens, ignore_eos=stop is None,
            stop_token_ids=stop),
        output_options=common.OutputOptions(logprobs=logprobs),
        request_id=rid)
    if tenant is not None:
        r.tenant = tenant
    if deadline is not None:
        r.deadline = deadline
    return r


def _metrics_row(m):
    d = m.to_dict()
    d["histograms"] = {k: v["count"] for k, v in d["histograms"].items()}
    return d


async def _collect(eng, req):
    toks, outs = [], []
    try:
        async for out in eng.generate(req):
            toks.extend(out.token_ids)
            outs.append((out.finish_reason and out.finish_reason.value,
                         out.log_probs, out.top_logprobs,
                         sorted((out.annotations or {}).get("timing", {})),
                         [s["name"] for s in (out.annotations or {}).get(
                             "trace", {}).get("spans", [])]))
    except Exception as e:  # noqa: BLE001 - the refusal is the outcome
        return ("error", type(e).__name__, str(e))
    return ("ok", toks, outs)


async def _scenario(which, name):
    mocker, common, overload, tenant = PKG[which]
    events, metrics = [], []
    base = dict(speedup_ratio=1.0, prefill_time_per_token_s=0.0,
                decode_time_per_step_s=0.001)
    batches = []   # lists of requests sent together, in turn
    if name == "single":
        args = mocker.MockerArgs(**base)
        batches = [[_request(common, range(1, 20), 10)]]
    elif name == "eos":
        args = mocker.MockerArgs(**base)
        batches = [[_request(common, range(1, 10), 10, stop=[4])]]
    elif name == "logprobs":
        args = mocker.MockerArgs(**base)
        batches = [[_request(common, range(5, 30), 6, logprobs=3)]]
    elif name == "prefix":
        args = mocker.MockerArgs(page_size=4, **base)
        p = list(range(1, 14))
        batches = [[_request(common, p, 4)], [_request(common, p, 4)],
                   [_request(common, p[:9] + [99, 98], 5)]]
    elif name == "pressure":
        args = mocker.MockerArgs(num_pages=12, page_size=4,
                                 max_decode_slots=4, **base)
        batches = [[_request(common, range(1 + 5 * i, 12 + 5 * i), 30)
                    for i in range(4)],
                   [_request(common, range(1, 12), 30)]]
    elif name == "eviction":
        # a small pool: later prompts evict the earlier ones' cached pages
        args = mocker.MockerArgs(num_pages=10, page_size=4,
                                 max_decode_slots=2, **base)
        batches = [[_request(common, range(10 * i + 1, 10 * i + 17), 6)]
                   for i in range(4)]
    elif name == "deadline":
        args = mocker.MockerArgs(**base)
        batches = [[_request(common, range(1, 9), 4,
                             deadline=time.time() - 5.0, tenant="late"),
                    _request(common, range(1, 9), 4)]]
    elif name == "overload":
        args = mocker.MockerArgs(max_decode_slots=1, max_waiting_requests=2,
                                 **base)
        batches = [[_request(common, range(1 + i, 9 + i), 3,
                             tenant=f"t{i}") for i in range(5)]]
    elif name == "tenant":
        args = mocker.MockerArgs(max_decode_slots=1,
                                 tenant_max_waiting_requests=1,
                                 tenant_weights={"gold": 2.0}, **base)
        batches = [[_request(common, range(1 + i, 9 + i), 3,
                             tenant=("storm" if i < 3 else "gold"))
                    for i in range(5)]]
    else:
        raise AssertionError(name)
    eng = mocker.MockerEngine(args, on_kv_event=events.append,
                              on_metrics=metrics.append)
    o0, t0 = overload.snapshot(), tenant.snapshot()
    results = []
    for batch in batches:
        results.append(await asyncio.gather(
            *[_collect(eng, r) for r in batch]))
    await eng.stop()
    o1, t1 = overload.snapshot(), tenant.snapshot()
    counters = {k: o1[k] - o0.get(k, 0) for k in o1}
    # the registries are the process's: only what this scenario moved
    tenants = {}
    for t, fam in t1.items():
        moved = {k: v - t0.get(t, {}).get(k, 0) for k, v in fam.items()
                 if not isinstance(v, dict)
                 and v != t0.get(t, {}).get(k, 0)}
        if moved:
            tenants[t] = moved
    debug = eng.tenant_debug()["tenants"]
    return dict(
        results=results,
        events=[e.to_dict() for e in events],
        metrics=[_metrics_row(m) for m in metrics],
        preemptions=eng.preemptions, sheds=eng.sheds,
        steps=eng.step_count, generated=eng.tokens_generated,
        hits=(eng.allocator.hit_blocks, eng.allocator.hit_rate()),
        counters=counters, tenants=tenants,
        # the quota view but its wall times and the process's metrics
        tenant_debug={t: {k: v for k, v in debug[t].items()
                          if k != "metrics" and not k.endswith("_s")}
                      for t in tenants})


SCENARIOS = ["single", "eos", "logprobs", "prefix", "pressure", "eviction",
             "deadline", "overload", "tenant"]


@pytest.mark.parametrize("name", SCENARIOS)
async def test_mocker_equals_the_reference(name):
    ref = await _scenario("ref", name)
    port = await _scenario("port", name)
    for key in ref:
        assert port[key] == ref[key], key
    # each scenario shows what it is there for
    if name == "pressure":
        assert ref["preemptions"] > 0
        assert ref["results"][0][0] == ref["results"][1][0]  # solo == loaded
    if name in ("prefix", "eviction"):
        assert ref["hits"][0] > 0 or name == "eviction"
        kinds = {e["kind"] for e in ref["events"]}
        assert kinds == ({"stored", "removed"} if name == "eviction"
                         else {"stored"})
    if name == "deadline":
        assert ref["results"][0][0][2][-1][0] == "deadline"
        assert ref["counters"]["dynamo_overload_shed_total"] == 1
    if name in ("overload", "tenant"):
        refused = [r for r in ref["results"][0] if r[0] == "error"]
        assert refused and all(r[1] == "EngineOverloadedError"
                               for r in refused)


async def test_drain_equals_the_reference():
    """begin_drain: the in-flight stream finishes whole, a new request is
    refused with the same error, and drained() turns true once idle."""
    out = {}
    for which in ("ref", "port"):
        mocker, common, _, _ = PKG[which]
        eng = mocker.MockerEngine(mocker.MockerArgs(
            prefill_time_per_token_s=0.0, decode_time_per_step_s=0.001))
        gen = eng.generate(_request(common, range(1, 12), 12))
        first = await gen.__anext__()
        eng.begin_drain()
        states = [eng.drained()]
        refused = await _collect(eng, _request(common, range(3, 9), 2))
        rest = [t async for o in gen for t in o.token_ids]
        await asyncio.sleep(0.01)
        states.append(eng.drained())
        out[which] = (first.token_ids + rest, refused, states)
        await eng.stop()
    assert out["port"] == out["ref"]
    toks, refused, states = out["ref"]
    assert len(toks) == 12 and refused[1] == "WorkerDrainingError"
    assert states == [False, True]


async def test_cancellation_frees_pages_as_the_reference():
    pages = {}
    for which in ("ref", "port"):
        mocker, common, _, _ = PKG[which]
        seen = []
        eng = mocker.MockerEngine(mocker.MockerArgs(speedup_ratio=10.0),
                                  on_metrics=seen.append)
        gen = eng.generate(_request(common, range(1, 30), 1000))
        first = await gen.__anext__()
        held = eng.allocator.active_pages
        await gen.aclose()
        for _ in range(100):
            await asyncio.sleep(0.01)
            if eng.allocator.active_pages == 0:
                break
        pages[which] = (first.token_ids, held, eng.allocator.active_pages,
                        seen[-1].kv_stats.kv_total_blocks)
        await eng.stop()
    assert pages["port"] == pages["ref"]
    assert pages["ref"][2] == 0 and pages["ref"][1] > 0


class _OverheadClock:
    """A clock whose every sleep overshoots by 1 ms (a busy host's
    wake-up), on its own timeline: the test reads simulated time only."""

    rate = 1.0

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t

    def to_wall(self, seconds):
        return seconds

    async def sleep(self, seconds):
        await asyncio.sleep(0)   # what was woken reads the time first
        self.t += max(0.0, seconds) + 0.001


@pytest.mark.parametrize("which", ["ref", "port"])
async def test_decode_cadence_absorbs_the_loops_overhead(which):
    """The port's mocker schedules a decode step one step after the last
    one was due, so a 1 ms wake-up overshoot leaves its 10 ms steps at
    10 ms; the reference's relative sleep makes them 11 ms (the same
    tokens either way)."""
    mocker, common, _, _ = PKG[which]
    clock = _OverheadClock()
    eng = mocker.MockerEngine(mocker.MockerArgs(
        prefill_time_per_token_s=0.0, decode_time_per_step_s=0.01),
        clock=clock)
    stamps, toks = [], []
    async for out in eng.generate(_request(common, range(1, 17), 12)):
        toks.extend(out.token_ids)
        stamps.append(clock.monotonic())
    await eng.stop()
    gaps = [b - a for a, b in zip(stamps[1:], stamps[2:])]
    assert toks == [list(range(1, 17))[i] for i in range(12)]
    want = 0.01 if which == "port" else 0.011
    assert gaps == pytest.approx([want] * 10, abs=1e-9)


def test_in_text_out_mocker_prints_what_the_reference_prints():
    args = ["run", "in=text", "out=mocker", "--prompt", "w1 w2 w3",
            "--max-tokens", "8"]
    env = {"PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    outs = [subprocess.run([sys.executable, "-m", mod, *args], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=120)
            for mod in ("dynamo_tpu.cli", "dynamo_tpu_torch.cli")]
    assert [o.returncode for o in outs] == [0, 0], [o.stderr for o in outs]
    assert outs[1].stdout == outs[0].stdout
    assert outs[0].stdout.split() == ["w1", "w2", "w3", "w1", "w2"]
