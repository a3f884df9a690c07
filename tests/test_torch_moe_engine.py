"""TorchEngine serving ModelConfig.tiny_moe (8 experts, top-2, dropless;
f32, CPU) against TpuEngine with the same weights: greedy streams
token-identical for one request, a burst of 3 whose slots free at
different times and a prefix repeat, with dense and int8 KV and with
w8a16 weights; greedy n-gram speculation, linear and tree, equal to
plain greedy and to the reference; a LoRA bank (attention sites only)
whose adapter 0 equals no bank; and the launcher's ``--model-config
tiny_moe`` (with ``--quantize int8``) on the CPU.

Each burst is held at the intake until all its requests wait, so both
packages admit it in one drain and prefill it in the same groups."""
import asyncio
import queue
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.launch import run as prun
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.tenancy.adapters import adapter_site_dims, random_adapter

ROOT = Path(__file__).resolve().parent.parent
_rng = np.random.RandomState(4)
PROMPTS = [_rng.randint(1, 256, n).tolist() for n in (29, 40, 17)]
# the burst's new tokens: its slots free at different rounds
BURST_NEW = (6, 14, 10)
BASE = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
            max_decode_slots=4, prefill_buckets=(32, 64),
            cache_dtype="float32")
# (weight quantization, KV mode)
CASES = {"f32": (None, "none"), "int8_kv": (None, "int8"),
         "w8a16": ("int8", "none")}


class GatedIntake(queue.Queue):
    """An engine's intake that shows nothing until ``n`` requests wait in
    it, then everything: a burst is admitted in one drain."""

    def __init__(self, n):
        super().__init__()
        self.n, self.open = n, False

    def _qsize(self):
        if not self.open:
            if len(self.queue) < self.n:
                return 0
            self.open = True
        return len(self.queue)


def _request(proto, prompt, n_new, aid=0):
    return proto.PreprocessedRequest(
        token_ids=list(prompt), adapter_id=aid,
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True))


async def _collect(eng, proto, prompt, n_new, aid=0):
    toks = []
    async for out in eng.generate(_request(proto, prompt, n_new, aid)):
        toks.extend(out.token_ids)
    return toks


async def _drive(eng, proto, aid=0):
    """A gated burst of 3, then prompt 0 again alone (a prefix repeat,
    more tokens), then a new prompt alone."""
    eng._intake = GatedIntake(len(PROMPTS))
    try:
        outs = list(await asyncio.gather(*[
            _collect(eng, proto, p, n, aid)
            for p, n in zip(PROMPTS, BURST_NEW)]))
        outs.append(await _collect(eng, proto, PROMPTS[0], 12, aid))
        outs.append(await _collect(eng, proto, PROMPTS[2][::-1], 8, aid))
        return outs
    finally:
        await eng.stop()


def _weights(quant):
    jcfg = JConfig.tiny_moe(dtype="float32", quant=quant)
    tcfg = TConfig.tiny_moe(dtype="float32", quant=quant)
    jparams = jl.init_params(jcfg, 0)
    return (jcfg, tcfg, jparams,
            tl.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    quant, kv = CASES[request.param]
    jcfg, tcfg, jparams, tparams = _weights(quant)
    jeng = TpuEngine(jcfg, JEngineConfig(**BASE, kv_quant=kv),
                     params=jparams, mesh_config=MeshConfig(tp=1))
    teng = TorchEngine(tcfg, TEngineConfig(**BASE, kv_quant=kv),
                       params=tparams, device="cpu")
    return (request.param, asyncio.run(_drive(jeng, jproto)),
            asyncio.run(_drive(teng, tproto)), teng)


def test_engine_greedy_identical_to_tpu_engine(runs):
    case, jout, tout, teng = runs
    assert [len(t) for t in tout] == list(BURST_NEW) + [12, 8]
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert t == j, (case, i)
    # the repeat hit prompt 0's cached blocks and continued its stream
    assert teng.allocator.hit_blocks >= 1
    assert tout[3][:BURST_NEW[0]] == tout[0]
    assert teng.pipeline_stats()["pipelined_dispatches"] > 0


# ---------------------------------------------------------------------------
# speculation


def _spec_run(pkg, weights, **kw):
    jcfg, tcfg, jparams, tparams = weights
    cfg = dict(BASE, max_decode_slots=2, **kw)
    if pkg == "jax":
        eng = TpuEngine(jcfg, JEngineConfig(**cfg), params=jparams,
                        mesh_config=MeshConfig(tp=1))
        proto = jproto
    else:
        eng = TorchEngine(tcfg, TEngineConfig(**cfg), params=tparams,
                          device="cpu")
        proto = tproto
    rng = np.random.RandomState(0)
    pat = rng.randint(1, 256, 8).tolist()
    prompts = [pat * 4, rng.randint(1, 256, 20).tolist()]
    eng._intake = GatedIntake(len(prompts))

    async def go():
        try:
            return await asyncio.gather(*[
                _collect(eng, proto, p, 20) for p in prompts])
        finally:
            await eng.stop()

    return asyncio.run(go()), eng


@pytest.fixture(scope="module")
def spec_weights():
    return _weights(None)


@pytest.fixture(scope="module")
def plain_spec(spec_weights):
    return _spec_run("torch", spec_weights)[0]


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_greedy_ngram_speculation_equals_plain_and_reference(
        spec_weights, plain_spec, tree):
    """The verify (batch_score / batch_score_tree: each row routed alone,
    its padding masked) keeps greedy streams equal to the fused round's,
    and to TpuEngine's with the same settings."""
    kw = dict(speculative="ngram", num_speculative_tokens=4)
    if tree:
        kw.update(spec_tree=True, spec_branches=2)
    got, eng = _spec_run("torch", spec_weights, **kw)
    assert got == plain_spec
    assert got == _spec_run("jax", spec_weights, **kw)[0]
    st = eng.spec.stats()
    assert st["spec_verify_steps"] > 0
    assert st["spec_tree"] is tree


# ---------------------------------------------------------------------------
# tenancy


def test_lora_bank_adapts_attention_only_and_adapter_zero_is_the_base():
    """A bank on tiny_moe has the attention sites only (expert stacks take
    no adapter); adapter 0 through it equals an engine without a bank,
    and a variant parts from it."""
    _, tcfg, _, tparams = _weights(None)
    assert set(adapter_site_dims(tcfg)) == {"wq", "wk", "wv", "wo"}
    banked = TorchEngine(tcfg, TEngineConfig(**BASE, lora_adapters=2,
                                             lora_rank=4),
                         params=tparams, device="cpu")
    banked.install_adapter(1, random_adapter(tcfg, 4, seed=7, scale=0.5))
    assert set(banked.params["adapters"]) == {"wq", "wk", "wv", "wo"}
    bare = TorchEngine(tcfg, TEngineConfig(**BASE), params=tparams,
                       device="cpu")
    base = asyncio.run(_drive(bare, tproto))
    assert asyncio.run(_drive(banked, tproto)) == base
    banked = TorchEngine(tcfg, TEngineConfig(**BASE, lora_adapters=2,
                                             lora_rank=4),
                         params=tparams, device="cpu")
    banked.install_adapter(1, random_adapter(tcfg, 4, seed=7, scale=0.5))
    assert asyncio.run(_drive(banked, tproto, aid=1)) != base


# ---------------------------------------------------------------------------
# the launcher


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8"]],
                         ids=["dense", "w8a16"])
def test_launcher_serves_tiny_moe_on_the_cpu(extra):
    args = prun.build_parser().parse_intermixed_args(
        ["in=text", "out=torch", "--model-config", "tiny_moe",
         "--cache-dtype", "float32", "--device", "cpu"] + extra)
    prun.refuse_unported(args)
    _, chain = prun.build_chain(args)
    eng = chain.engine
    assert eng.config.moe_dict == {"capacity_factor": 0.0,
                                   "num_experts": 8, "top_k": 2}
    layers = eng.params["layers"]
    assert "we_g" in layers and "wg" not in layers
    assert (layers["we_g"]["q"].shape if extra
            else layers["we_g"].shape) == (4, 8, 64, 128)
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=text",
         "out=torch", "--model-config", "tiny_moe", "--cache-dtype",
         "float32", "--device", "cpu", "--prompt", "w1 w2 w3",
         "--max-tokens", "6"] + extra,
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == 1
