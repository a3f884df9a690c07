"""The port's SLA profiler (dynamo_tpu_torch/profiler.py) and mocker
calibration (dynamo_tpu_torch/tools/calibrate_mocker.py) against the JAX
package's:

- ``profile_engine`` over each package's mocker gives a table of the
  same shape: the same keys, configs, concurrencies and point keys (the
  latencies are wall times, compared by their order only);
- ``SlaCapacity.interpolate``, ``max_concurrency`` and ``replicas_for``
  equal the reference's on the same tables, the reference tests' tables
  included (exact: the same float operations);
- ``measure_point`` spreads a multi-token output's wait over its tokens
  (the reference reads an ITL of 0 off each token after an output's
  first);
- ``profile --engine torch --device cpu --model-config tiny
  --cache-dtype float32`` writes a table of the reference's keys, and
  without a card and without ``--device cpu`` it fails;
- ``calibrate_mocker`` gives the reference tool's output and errors."""
import asyncio
import importlib.util
import json
from pathlib import Path

import pytest

from dynamo_tpu import mocker as rm
from dynamo_tpu import profiler as rprof
from dynamo_tpu_torch import mocker as pm
from dynamo_tpu_torch import profiler as pprof
from dynamo_tpu_torch.protocols.common import LLMEngineOutput
from dynamo_tpu_torch.tools import calibrate_mocker as pcal

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "ref_calibrate_mocker", ROOT / "tools" / "calibrate_mocker.py")
rcal = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rcal)

POINT_KEYS = ["concurrency", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
              "itl_p99_s", "tok_s"]


def _mocker_factory(mod):
    def make(cfg):
        return mod.MockerEngine(mod.MockerArgs(
            speedup_ratio=cfg.get("speedup_ratio", 50.0),
            max_decode_slots=cfg.get("max_decode_slots", 4),
            page_size=8, num_pages=256))
    return make


async def test_profile_engine_table_matches_the_reference():
    configs = [{"name": "slots2", "max_decode_slots": 2,
                "speedup_ratio": 5.0},
               {"name": "slots4", "max_decode_slots": 4,
                "speedup_ratio": 5.0}]
    tables = [await prof.profile_engine(
        _mocker_factory(mod), [dict(c) for c in configs],
        concurrencies=(1, 8), isl=16, osl=12, rounds=1)
        for prof, mod in ((rprof, rm), (pprof, pm))]
    ref, port = tables
    assert list(port) == list(ref) == ["isl", "osl", "configs"]
    assert (port["isl"], port["osl"]) == (ref["isl"], ref["osl"])
    for pc, rc in zip(port["configs"], ref["configs"], strict=True):
        assert list(pc) == list(rc) == ["name", "config", "points"]
        assert (pc["name"], pc["config"]) == (rc["name"], rc["config"])
        for pp, rp in zip(pc["points"], rc["points"], strict=True):
            assert list(pp) == list(rp) == POINT_KEYS
            assert pp["concurrency"] == rp["concurrency"]
            assert pp["tok_s"] > 0
            assert pp["ttft_p50_s"] <= pp["ttft_p99_s"]
            assert pp["itl_p50_s"] <= pp["itl_p99_s"]
    # 8 streams on 2 slots queue: TTFT grows, in both packages
    for t in tables:
        pts = t["configs"][0]["points"]
        assert pts[1]["ttft_p50_s"] > pts[0]["ttft_p50_s"]


class _BurstEngine:
    """Emits the first token after 20 ms, then bursts of 4 tokens 40 ms
    apart (the shape of TorchEngine's rounds)."""

    async def generate(self, req):
        await asyncio.sleep(0.02)
        yield LLMEngineOutput(token_ids=[1])
        for _ in range(2):
            await asyncio.sleep(0.04)
            yield LLMEngineOutput(token_ids=[2, 3, 4, 5])


async def test_measure_point_spreads_a_burst_over_its_tokens():
    pt = await pprof.measure_point(_BurstEngine(), concurrency=1, isl=4,
                                   osl=9, rounds=1)
    assert pt.ttft_p50_s == pytest.approx(0.02, abs=0.015)
    # each of the 8 tokens after the first waited ~40 ms / 4
    assert pt.itl_p50_s == pytest.approx(0.01, abs=0.006)
    assert pt.itl_p99_s == pytest.approx(0.01, abs=0.006)
    ref = await rprof.measure_point(_BurstEngine(), concurrency=1, isl=4,
                                    osl=9, rounds=1)
    assert ref.itl_p50_s == 0.0   # what the port's measure avoids


SLA_TABLES = [
    # tests/test_profiler.py
    {"configs": [{"name": "slots8", "points": [
        {"concurrency": 1, "ttft_p50_s": 0.01, "itl_p50_s": 0.005},
        {"concurrency": 4, "ttft_p50_s": 0.05, "itl_p50_s": 0.01},
        {"concurrency": 8, "ttft_p50_s": 0.50, "itl_p50_s": 0.05}]}]},
    {"configs": [{"name": "c", "points": [
        {"concurrency": 4, "ttft_p50_s": 0.01, "itl_p50_s": 0.005}]}]},
    # tests/test_predictors.py
    {"configs": [{"name": "c", "points": [
        {"concurrency": 2, "ttft_p50_s": 0.1, "itl_p50_s": 0.01},
        {"concurrency": 10, "ttft_p50_s": 0.9, "itl_p50_s": 0.05}]}]},
    {"configs": [{"name": "c", "points": [
        {"concurrency": 1, "ttft_p50_s": 2.0, "itl_p50_s": 0.5}]}]},
    {"configs": [{"name": "c", "points": [
        {"concurrency": 1, "ttft_p50_s": 0.1, "itl_p50_s": 0.01},
        {"concurrency": 8, "ttft_p50_s": 0.2, "itl_p50_s": 0.02}]}]},
    # two configs, p99 columns, a missing measurement and equal x's
    {"configs": [
        {"name": "a", "points": [
            {"concurrency": 1, "ttft_p50_s": 0.02, "ttft_p99_s": 0.03,
             "itl_p50_s": 0.004, "itl_p99_s": 0.006},
            {"concurrency": 4, "ttft_p50_s": 0.08, "ttft_p99_s": 0.2,
             "itl_p50_s": 0.009, "itl_p99_s": 0.02},
            {"concurrency": 4, "ttft_p50_s": 0.09, "ttft_p99_s": 0.25,
             "itl_p50_s": 0.011, "itl_p99_s": 0.03},
            {"concurrency": 16, "ttft_p50_s": 0.6, "ttft_p99_s": 1.5,
             "itl_p50_s": 0.04, "itl_p99_s": None}]},
        {"name": "b", "points": [
            {"concurrency": 2, "ttft_p50_s": 0.05, "ttft_p99_s": 0.07,
             "itl_p50_s": 0.006, "itl_p99_s": 0.008},
            {"concurrency": 8, "ttft_p50_s": 0.12, "ttft_p99_s": 0.3,
             "itl_p50_s": 0.015, "itl_p99_s": 0.022}]},
        {"name": "empty", "points": []}]},
]
SLAS = [(0.1, 0.02), (0.1, None), (None, 0.01), (0.5, None), (0.001, None),
        (0.07, 0.012), (0.25, 0.025), (None, None)]


@pytest.mark.parametrize("table", range(len(SLA_TABLES)))
def test_sla_capacity_equals_the_reference(table):
    profile = SLA_TABLES[table]
    names = [None] + [c["name"] for c in profile["configs"]]
    for ttft, itl in SLAS:
        for name in names:
            for pct in ("p50", "p99"):
                kw = dict(ttft_sla_s=ttft, itl_sla_s=itl, config_name=name,
                          percentile=pct)
                ref = rprof.SlaCapacity(profile, **kw)
                port = pprof.SlaCapacity(profile, **kw)
                assert port.max_concurrency() == ref.max_concurrency(), kw
                for c in (0, 0.5, 1, 2.5, 4, 5, 7.25, 10, 40):
                    assert port.interpolate(c) == ref.interpolate(c), (kw, c)
                for streams in (0, 1, 4, 5, 12, 100):
                    for lo in (1, 2):
                        assert (port.replicas_for(streams, lo)
                                == ref.replicas_for(streams, lo))


def test_profile_cli_torch_on_the_cpu_writes_a_table(tmp_path):
    from dynamo_tpu_torch import cli

    out = tmp_path / "profile.json"
    assert cli.main(["profile", "--engine", "torch", "--device", "cpu",
                     "--model-config", "tiny", "--cache-dtype", "float32",
                     "--slots", "4", "--concurrency", "1", "2", "--isl",
                     "24", "--osl", "32", "--output", str(out)]) == 0
    table = json.loads(out.read_text())
    assert list(table) == ["isl", "osl", "configs"]
    (cfg,) = table["configs"]
    assert (cfg["name"], cfg["config"]) == ("slots4",
                                            {"max_decode_slots": 4})
    assert [p["concurrency"] for p in cfg["points"]] == [1, 2]
    for p in cfg["points"]:
        assert list(p) == POINT_KEYS
        assert p["tok_s"] > 0 and p["itl_p50_s"] > 0
        assert 0 < p["ttft_p50_s"] <= p["ttft_p99_s"]


def test_profile_torch_does_not_fall_back_to_the_cpu(tmp_path, monkeypatch):
    import torch

    from dynamo_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "p.json"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["profile", "--engine", "torch", "--model-config", "tiny",
                  "--output", str(out)])
    assert not out.exists()


def _profile(ttft=0.128, itl=0.02, isl=64, slots=8, **cfg_extra):
    return {
        "isl": isl, "osl": 32,
        "configs": [{
            "name": "cfg-a",
            "config": {"max_decode_slots": slots, **cfg_extra},
            "points": [
                {"concurrency": 4, "ttft_p50_s": ttft * 3,
                 "ttft_p99_s": ttft * 4, "itl_p50_s": itl * 2,
                 "itl_p99_s": itl * 3, "tok_s": 300.0},
                {"concurrency": 1, "ttft_p50_s": ttft, "ttft_p99_s": ttft,
                 "itl_p50_s": itl, "itl_p99_s": itl, "tok_s": 100.0},
            ],
        }, {
            "name": "cfg-b",
            "config": {"max_num_seqs": 3},
            "points": [{"concurrency": 2, "ttft_p50_s": 0.3,
                        "itl_p50_s": 0.01}],
        }],
    }


@pytest.mark.parametrize("profile,name", [
    (_profile(), None), (_profile(), "cfg-a"), (_profile(), "cfg-b"),
    (_profile(slots=0), None), (_profile(), "nope"),
    ({"isl": 0, "configs": []}, None), ({"isl": 8, "configs": []}, None),
    (_profile(ttft=0.0), None), (_profile(itl=-1.0), "cfg-a"),
    ({"isl": 8, "configs": [{"name": "x", "points": []}]}, None),
])
def test_calibrate_mocker_equals_the_reference(profile, name):
    try:
        want = rcal.mocker_args_from_profile(profile, config_name=name)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pcal.mocker_args_from_profile(profile, config_name=name)
        assert str(got.value) == str(e)
        return
    assert pcal.mocker_args_from_profile(profile, config_name=name) == want
    # the result builds the port's mocker
    pm.MockerArgs(**want)


def test_calibrate_mocker_cli_equals_the_reference(tmp_path, capsys):
    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps(_profile()))
    outs = []
    for tool in (rcal, pcal):
        out = tmp_path / f"{tool.__name__}.json"
        assert tool.main([str(prof), "--config", "cfg-a", "-o",
                          str(out)]) == 0
        outs.append(out.read_text())
        assert tool.main([str(prof)]) == 0
        outs.append(capsys.readouterr().out)
        assert tool.main([str(prof), "--config", "zzz"]) == 1
        outs.append(capsys.readouterr().err)
    assert outs[3:] == outs[:3]
    assert json.loads(outs[0])["decode_time_per_step_s"] == 0.02
