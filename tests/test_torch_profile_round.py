"""The port's tools/profile_round against the JAX package's
tools/profile_round.py on ModelConfig.tiny (f32, CPU): each ``--spec``
mode's dispatch counts a token equal the reference tool's with the same
weights (both engines take their burst in one intake drain, GatedIntake,
and the JAX package's results settle before they are consumed,
settle_results, so the batching does not follow the host's timing); the
dispatch budget's byte fields equal the reference's at a context where
both kernels' read granularities agree, with their deltas against a
baseline; the timing mode runs its three variants on the CPU without
reporting a time."""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest

import dynamo_tpu.engine.engine as jengine
import dynamo_tpu_torch.engine.engine as tengine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.tools import profile_round as pr
from tests.test_torch_spec_engine import GatedIntake, settle_results

ROOT = Path(__file__).resolve().parent.parent
N_REQ = 4


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_profile_round", ROOT / "tools" / "profile_round.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(fn, *args) -> list[dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn(*args) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


@pytest.fixture
def gated(monkeypatch):
    """Both packages' engines take a burst of N_REQ in one intake drain."""
    class Tpu(jengine.TpuEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._intake = GatedIntake(N_REQ, self)
            settle_results(self)

    class Torch(tengine.TorchEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._intake = GatedIntake(N_REQ, self)

    monkeypatch.setattr(jengine, "TpuEngine", Tpu)
    monkeypatch.setattr(tengine, "TorchEngine", Torch)


@pytest.fixture(scope="module")
def weights():
    """The reference tool's weights (init_params of tiny, seed 0) in the
    port's layout."""
    return params_from_jax(
        jax.tree.map(np.asarray, jl.init_params(JConfig.tiny(
            dtype="float32"), 0)), device="cpu")


@pytest.mark.parametrize("mode", pr.SPEC_ALL + ["tree-vs-linear"])
def test_spec_dispatches_equal_the_reference(gated, weights, mode):
    ref = _run_reference(_reference_tool()._spec_dispatch_mode, [mode],
                         N_REQ, 32)
    port = pr.spec_dispatch([mode], N_REQ, 32, "cpu", weights)
    assert port == ref
    assert all(r["tokens"] == N_REQ * 32 for r in port if "tokens" in r)
    if mode == "draft-perslot":
        assert port[0]["draft_dispatches_per_verify"] > 1.0
    elif mode == "draft":
        assert port[0]["draft_dispatches_per_verify"] == 1.0


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_dispatch_budget_bytes_equal_the_reference(tmp_path, kv_quant):
    """At a context of 256 (the whole tiny region: the TPU kernel's chunk
    and the port's tile both tile it) every byte field equals the
    reference tool's; against the reference line as a baseline the byte
    deltas are 0."""
    osl = 256 - 48
    ref, = _run_reference(_reference_tool()._dispatch_budget_mode, N_REQ,
                          osl, kv_quant)
    base = tmp_path / "ref.json"
    base.write_text(json.dumps(ref))
    port = pr.dispatch_budget("tiny", "cpu", N_REQ, osl, kv_quant,
                              baseline=str(base))
    for k in pr.BYTE_FIELDS:
        assert port[k] == ref[k], k
    assert port["attn_roofline_frac"] is None   # no peak on the CPU
    assert (port["bytes_per_step_breakdown"]["kv_ctx_scales"] > 0) == (
        kv_quant == "int8")
    deltas = port["baseline_deltas"]
    assert deltas["kv_bytes_per_step"] == 0
    assert set(deltas["bytes_per_step_breakdown"].values()) == {0}


def test_byte_accounting_weights_count_the_w8a16_scales():
    """The weights stream is the engine's parameter bytes: a w8a16 model
    counts its int8 weights and their f32 scales."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = dataclasses.replace(ModelConfig.tiny(dtype="float32"),
                              quant="int8")
    eng = tengine.TorchEngine(cfg, EngineConfig(
        num_pages=16, page_size=16, max_pages_per_seq=4, max_decode_slots=2,
        cache_dtype="float32"), device="cpu")
    wq = eng.params["layers"]["wq"]
    assert wq["q"].dtype.itemsize == 1
    weights = pr._byte_accounting(eng, 20, None)[
        "bytes_per_step_breakdown"]["weights"]
    dense = tengine.TorchEngine(ModelConfig.tiny(dtype="float32"),
                                eng.ecfg, device="cpu")
    assert weights == sum(t.nbytes for t in _leaves(eng.params))
    assert weights < pr._byte_accounting(dense, 20, None)[
        "bytes_per_step_breakdown"]["weights"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_timing_mode_runs_its_variants_without_a_time_on_the_cpu(capsys):
    assert pr.main(["--device", "cpu", "--model-config", "tiny"]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["variant"] for r in rows] == [
        "round +flush", "round no flush", "flush only"]
    for r in rows:
        assert (r["slots"], r["max_context"], r["flush_every"], r["ctx"]) \
            == (32, 1024, 16, 356)
        assert r["ms_per_step"] is None and r["attn_roofline_frac"] is None
        assert r["kernel_executions"] is None
        assert r["total_bytes_per_step"] > r["kv_bytes_per_step"] > 0


def test_spec_refuses_another_model():
    with pytest.raises(SystemExit):
        pr.main(["--spec", "ngram", "--model-config", "llama3_8b"])
