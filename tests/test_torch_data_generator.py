"""The port's trace generator (dynamo_tpu_torch/data_generator.py) against
the JAX package's: ``synthesize`` gives the same records for the same
config and seed, ``analyze`` the same statistics (exact: the same numpy
draws and sums), the JSONL files are byte-equal and read across packages,
and ``python -m dynamo_tpu_torch.cli datagen`` writes, then analyzes, the
trace the reference's CLI writes."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from dynamo_tpu import data_generator as rdg
from dynamo_tpu_torch import data_generator as pdg

ROOT = Path(__file__).resolve().parent.parent

CONFIGS = [
    dict(),
    dict(num_requests=40, request_rate_per_s=8.0, isl_mean=96, isl_cv=0.2,
         osl_mean=32, osl_cv=1.0, block_size=16, num_sessions=3,
         turns_mean=6.0, seed=4),
    dict(num_requests=25, num_sessions=1, turns_mean=1.0, block_size=64,
         seed=123),
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_synthesize_and_analyze_equal_the_reference(i, tmp_path):
    ref = rdg.synthesize(rdg.TraceConfig(**CONFIGS[i]))
    port = pdg.synthesize(pdg.TraceConfig(**CONFIGS[i]))
    assert port == ref
    ts = [r["timestamp"] for r in port]
    assert ts == sorted(ts)
    assert pdg.analyze(port) == rdg.analyze(ref)
    assert pdg.analyze([]) == rdg.analyze([]) == {"num_requests": 0}
    rf, pf = tmp_path / "r.jsonl", tmp_path / "p.jsonl"
    rdg.write_trace(ref, str(rf))
    pdg.write_trace(port, str(pf))
    assert pf.read_bytes() == rf.read_bytes()
    assert list(pdg.read_trace(str(rf))) == list(rdg.read_trace(str(pf)))


def test_multi_turn_sessions_share_prefixes():
    recs = pdg.synthesize(pdg.TraceConfig(num_requests=60, num_sessions=2,
                                          turns_mean=50.0, seed=1))
    stats = pdg.analyze(recs)
    assert stats["prefix_reuse_ratio"] > 0.5
    assert stats == rdg.analyze(recs)


def test_datagen_cli_round_trips(tmp_path):
    flags = ["--num", "30", "--rate", "5", "--isl", "80", "--osl", "20",
             "--block-size", "16", "--sessions", "4", "--turns", "3",
             "--seed", "9"]
    env = {"PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    outs = {}
    for mod, name in (("dynamo_tpu.cli", "ref"),
                      ("dynamo_tpu_torch.cli", "port")):
        path = tmp_path / f"{name}.jsonl"
        gen = subprocess.run(
            [sys.executable, "-m", mod, "datagen", *flags, "--output",
             str(path)], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=120)
        assert gen.returncode == 0, gen.stderr
        back = subprocess.run(
            [sys.executable, "-m", mod, "datagen", "--analyze", str(path)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert back.returncode == 0, back.stderr
        outs[name] = (path.read_bytes(), gen.stdout.replace(str(path), "P"),
                      json.loads(back.stdout))
    assert outs["port"] == outs["ref"]
    data, _, stats = outs["port"]
    assert stats == pdg.analyze(list(pdg.read_trace(
        str(tmp_path / "port.jsonl"))))
    assert stats["num_requests"] == 30 == len(data.splitlines())
