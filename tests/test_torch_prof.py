"""The port's round attribution (telemetry/prof.py) held against the JAX
package's: ``RoundProf`` and ``ProfRegistry`` driven with the same calls
on one injected clock give equal totals, rings, summaries, coverage,
renders and burn rates. Then TorchEngine on tiny f32 on the CPU: every
recorded round's segments sum to its wall time (coverage 1 +- 0.02) on
the pipelined, strict and speculative paths, the busy segments are the
ones charged, the fold reaches PROF at the publish cadence, a disabled
profiler records nothing, and ``python -m dynamo_tpu_torch.tools.
profile_round --dispatch-budget`` reports the host breakdown by segment.
No wall-clock ratio is asserted: the overhead is a card figure."""
import asyncio
import json

import numpy as np
import pytest

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.telemetry.prof import PROF, SEGMENTS
from tests.test_torch_telemetry import both  # noqa: F401 — a fixture


def _rounds(t, clock, prof, n, pattern=((0, 0.001), (2, 0.003),
                                          (9, 0.0005))):
    """``n`` rounds, each entering ``pattern``'s segments for its times,
    one pushed annotate slice inside the fetch segment, every third
    round an idle one."""
    ann = t.prof.SEGMENTS.index("annotate")
    for i in range(n):
        prof.begin_round()
        for seg, dt in pattern:
            prof.enter(seg)
            clock.tick(dt * (1 + i % 3))
            if seg == 2:
                prev = prof.push(ann)
                clock.tick(0.0002)
                prof.enter(prev)
                clock.tick(0.0001)
        prof.end_round(record=i % 3 != 2)


def sc_roundprof(t, clock):
    prof = t.prof.RoundProf()
    _rounds(t, clock, prof, 7)
    out = {"totals": prof.totals(), "coverage": prof.coverage(),
           "recent": prof.recent(4), "summary": prof.summary(),
           "top2": prof.summary(top=2), "drain": prof.drain(),
           "drain_again": prof.drain()}
    # a ring wrap: more rounds than RING, the drain is bounded by it
    _rounds(t, clock, prof, prof.RING + 40, pattern=((3, 0.0001),))
    arr = prof.drain_arrays()
    out["wrapped"] = {"rows": len(arr), "sum": float(arr.sum()),
                      "totals": prof.totals(),
                      "summary": prof.summary(top=3),
                      "empty": prof.drain_arrays() is None}
    off = t.prof.RoundProf(enabled=False)
    _rounds(t, clock, off, 3)
    out["disabled"] = (off.totals(), off.summary(), off.recent())
    return out


def sc_registry(t, clock):
    reg = t.prof.ProfRegistry()
    prof = t.prof.RoundProf()
    _rounds(t, clock, prof, 9)
    reg.fold(prof)
    reg.fold(prof)   # nothing new: the drain mark advanced
    ttft = t.metrics.Histogram("ttft", "t")
    itl = t.metrics.Histogram("itl", "i")
    for v in (0.1, 0.2, 0.7, 1.5):
        ttft.observe(v)
    for v in (0.01, 0.02, 0.06, 0.2):
        itl.observe(v, n=3)
    out = {"burn_default": reg.fold_burn_rates(ttft.snapshot(),
                                               itl.snapshot())}
    reg.configure(0.25, 0.03, 0.9)
    out["burn_configured"] = reg.fold_burn_rates(ttft.snapshot(),
                                                 itl.snapshot())
    out["burn_explicit"] = reg.fold_burn_rates(None, itl.snapshot(), 1.0,
                                               0.01, 0.999)
    out.update(rates=reg.burn_rates(), coverage=reg.coverage_ratio(),
               snap=reg.snapshot(), render=reg.render())
    out["frac"] = [t.prof.frac_over_target(s, x) for s, x in (
        (None, 0.1), ({}, 0.1), (ttft.snapshot(), 0.0),
        (ttft.snapshot(), 0.15), (ttft.snapshot(), 1000.0),
        ({"count": 2, "buckets": [1.0], "counts": [1]}, 0.5))]
    reg.reset()
    out["reset"] = reg.render()
    return out


SCENARIOS = {"roundprof": sc_roundprof, "registry": sc_registry}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_prof_module_matches_reference(both, name):
    (ref, rc), (port, pc) = both
    want = SCENARIOS[name](ref, rc)
    got = SCENARIOS[name](port, pc)
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# TorchEngine on the CPU

def _engine(**kw) -> TorchEngine:
    return TorchEngine(ModelConfig.tiny(dtype="float32"), EngineConfig(
        num_pages=128, page_size=16, max_pages_per_seq=16,
        max_decode_slots=4, prefill_buckets=(64,), cache_dtype="float32",
        **kw), device="cpu")


async def _wave(eng, prompts, n_new):
    """The finishing outputs' annotations, a prompt each."""
    async def one(p):
        async for out in eng.generate(PreprocessedRequest(
                token_ids=list(p), stop_conditions=StopConditions(
                    max_tokens=n_new, ignore_eos=True))):
            if out.finish_reason is not None:
                return out.annotations

    return await asyncio.gather(*[one(p) for p in prompts])


ARMS = {
    "pipelined": {},
    "strict": {"round_pipeline": False},
    "ngram": {"speculative": "ngram", "num_speculative_tokens": 3},
    "tree": {"speculative": "ngram", "num_speculative_tokens": 3,
             "spec_tree": True},
}


@pytest.mark.parametrize("arm", sorted(ARMS))
async def test_engine_round_coverage_and_segments(arm):
    PROF.reset()
    eng = _engine(**ARMS[arm])
    eng.start()
    rng = np.random.RandomState(0)
    # repetitive prompts give the n-gram proposer something to match
    prompts = [(rng.randint(1, 64, 8).tolist() * 6) for _ in range(4)]
    try:
        anns = await _wave(eng, prompts, 24)
    finally:
        await eng.stop()
    if "speculative" in ARMS[arm]:
        # verify rounds carry their draft and verify host walls
        spec = [sp for a in anns for sp in a["trace"]["spans"]
                if sp["name"] == "spec_verify_round"]
        assert spec
        for sp in spec:
            assert [c["name"] for c in sp["children"]] == [
                "spec_draft", "spec_verify"]
    rows = eng.prof.recent(256)
    assert len(rows) >= 5
    for _, wall, acc in rows:
        assert abs(sum(acc) - wall) <= 0.02 * wall + 1e-9
    assert 0.98 <= eng.prof.coverage() <= 1.02
    seg = eng.prof.totals()["segments"]
    for s in ("intake", "slot_scan", "fetch", "admit"):
        assert seg[s] > 0.0, (s, seg)
    busy = "spec_dispatch" if "speculative" in ARMS[arm] else "dispatch"
    assert seg[busy] > 0.0, seg
    # the fold ran at the publish cadence: the process registry saw it
    assert sum(h["count"] for h in PROF.snapshot().values()) > 0
    summary = eng.prof.summary(top=3)
    assert len(summary["segments"]) == 3 and summary["enabled"]
    PROF.reset()


def test_disabled_engine_records_nothing():
    eng = _engine(prof_attribution=False)
    eng.start()
    try:
        asyncio.run(_wave(eng, [list(range(5, 40))], 8))
    finally:
        asyncio.run(eng.stop())
    assert eng.prof.enabled is False
    assert eng.prof.totals()["rounds"] == 0
    assert eng.prof.recent() == [] and eng.prof.coverage() == 1.0
    assert eng.prof.summary()["enabled"] is False


def test_profile_round_dispatch_budget_host_breakdown(tmp_path, capsys):
    """The tool's JSON line: a host_breakdown keyed by the whole segment
    enum, a coverage of 1 +- 0.02, one round program and one fetch a
    steady round; and --baseline deltas against a prior run."""
    from dynamo_tpu_torch.tools import profile_round

    argv = ["--dispatch-budget", "--device", "cpu", "--requests", "2",
            "--osl", "16"]
    assert profile_round.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "dispatch-budget" and out["device"] == "cpu"
    assert set(out["host_breakdown"]) == set(SEGMENTS)
    assert all(v >= 0.0 for v in out["host_breakdown"].values())
    assert out["host_prof_rounds"] >= 1
    assert 0.98 <= out["host_prof_coverage"] <= 1.02
    assert out["rounds"] >= 1 and out["standalone_seal_dispatches"] == 0
    base = tmp_path / "base.json"
    base.write_text(json.dumps(out))
    assert profile_round.main(argv + ["--baseline", str(base)]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(again["baseline_deltas"]["host_breakdown"]) == set(SEGMENTS)
