"""TorchEngine with a resident LoRA bank against TpuEngine with the same
bank, on ModelConfig.tiny with the same weights and the same variants
(tenancy/adapters.py random_adapter draws the same numpy factors in both
packages): greedy streams must be token-identical for the base model and
for the variants, with mixed adapter ids in one batch, in f32, with int8
KV and with w8a16 weights. In bf16 the two frameworks round the hidden
states apart (the base model's streams part too), so a bf16 stream must
equal the reference's up to a step where the reference's top-2 logprob
gap is at most BF16_TIE, and may part there. Adapter 0 through the bank
must equal an engine without a bank exactly, in every case (its delta is
exactly 0.0). Speculation stays with adapter 0.

Each burst is held at the intake until all its requests wait, so each
package admits it in one drain and both prefill it in the same groups.
"""
import asyncio
import queue

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.tenancy.adapters import random_adapter as jrandom_adapter
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.tenancy import metrics as pmetrics
from dynamo_tpu_torch.tenancy.adapters import random_adapter

RANK = 4
N_NEW = 10
_rng = np.random.RandomState(3)
PROMPTS = [_rng.randint(1, 256, n).tolist() for n in (29, 40, 17, 35)]
# the mixed burst: (prompt, adapter id, served model name: the salt)
BURST = [(0, 0, "base"), (1, 1, "base:v1"), (2, 2, "base:v2"),
         (3, 0, "base")]
# the bf16 case's near-tie: the largest top-2 gap at which the streams
# may part (set from the base model's own bf16 divergence on this tiny
# model, which lies below it)
BF16_TIE = 0.05
# (model dtype, weight quantization, KV mode)
CASES = {
    "f32": ("float32", None, "none"),
    "int8_kv": ("float32", None, "int8"),
    "w8a16": ("float32", "int8", "none"),
    "bf16": ("bfloat16", None, "none"),
}


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


def _ecfg(cls, dtype, kv, **kw):
    return cls(num_pages=64, page_size=16, max_pages_per_seq=8,
               max_decode_slots=4, prefill_buckets=(32, 64),
               cache_dtype=dtype, kv_quant=kv, **kw)


def _variants(cfg, rand):
    return {aid: rand(cfg, RANK, seed=6 + aid, scale=0.5) for aid in (1, 2)}


async def _collect(engine, proto, prompt, aid, model, n_new=N_NEW,
                   gaps=None):
    """The greedy stream; with a ``gaps`` list, each step's top-2 logprob
    gap is appended to it (the request asks for 2 logprobs)."""
    req = proto.PreprocessedRequest(
        token_ids=list(prompt), model=model, adapter_id=aid,
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True),
        output_options=proto.OutputOptions(
            logprobs=None if gaps is None else 2))
    toks = []
    async for out in engine.generate(req):
        toks.extend(out.token_ids)
        for top in out.top_logprobs or []:
            gaps.append(top[0][1] - top[1][1])
    return toks


def _hold(got, want, gaps, case):
    """got == want, or (bf16) equal up to a step at a near-tie."""
    if got == want or gaps is None:
        assert got == want, case
        return
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    assert gaps[k] <= BF16_TIE, (case, k, gaps[k])


async def _drive(engine, proto, burst=BURST, repeat=(1, "base:v1"),
                 gaps=None):
    """The mixed burst (gated), then prompt 1 again as variant 1 alone
    (``repeat``): a prefix hit on the variant's own blocks, prefilled past
    them."""
    engine._intake = GatedIntake(len(burst))
    try:
        g = None if gaps is None else [[] for _ in range(len(burst) + 1)]
        outs = await asyncio.gather(*[
            _collect(engine, proto, PROMPTS[i], aid, model,
                     gaps=None if g is None else g[k])
            for k, (i, aid, model) in enumerate(burst)])
        outs.append(await _collect(engine, proto, PROMPTS[1], *repeat,
                                   gaps=None if g is None else g[-1]))
        if gaps is not None:
            gaps.extend(g)
        return outs
    finally:
        await engine.stop()


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    """(case, TpuEngine streams, banked TorchEngine streams and engine,
    bank-less TorchEngine streams) of one case."""
    dtype, quant, kv = CASES[request.param]
    jcfg = JConfig.tiny(dtype=dtype, quant=quant)
    tcfg = TConfig.tiny(dtype=dtype, quant=quant)
    jparams = jl.init_params(jcfg, 0)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jeng = TpuEngine(jcfg, _ecfg(JEngineConfig, dtype, kv, lora_adapters=4,
                                 lora_rank=RANK),
                     params=jparams, mesh_config=MeshConfig(tp=1))
    for aid, w in _variants(jcfg, jrandom_adapter).items():
        jeng.install_adapter(aid, w)
    teng = TorchEngine(tcfg, _ecfg(TEngineConfig, dtype, kv, lora_adapters=4,
                                   lora_rank=RANK),
                       params=tparams, device="cpu")
    for aid, w in _variants(tcfg, random_adapter).items():
        teng.install_adapter(aid, w)
    bare = TorchEngine(tcfg, _ecfg(TEngineConfig, dtype, kv),
                       params=tparams, device="cpu")
    pmetrics.TENANT.reset()
    tout = asyncio.run(_drive(teng, tproto))
    rounds = pmetrics.TENANT.get("dynamo_tenant_adapter_rounds_total",
                                 "default")
    base_burst = [(i, 0, "base") for i, _, _ in BURST]
    gaps = [] if dtype == "bfloat16" else None
    return (request.param, asyncio.run(_drive(jeng, jproto, gaps=gaps)),
            gaps, tout, teng,
            asyncio.run(_drive(bare, tproto, base_burst, (0, "base"))),
            rounds)


def test_banked_engine_greedy_identical_to_tpu_engine(runs):
    case, jout, gaps, tout, teng, _, rounds = runs
    assert len(tout) == len(jout) == len(BURST) + 1
    for i, (t, j) in enumerate(zip(tout, jout)):
        _hold(t, j, None if gaps is None else gaps[i], (case, i))
        assert len(t) == N_NEW
    # the variants part from the base, and from each other
    assert len({tuple(tout[i]) for i in (0, 1, 2)}) == 3
    # the repeat hit variant 1's own cached blocks (the variant's salt)
    assert tout[4] == tout[1]
    assert teng.allocator.hit_blocks >= 1
    # the rounds that gathered a variant's rows were counted
    assert rounds >= 1


def test_adapter_zero_equals_an_engine_without_a_bank(runs):
    case, _, _, tout, teng, bare_out, _ = runs
    for i, (_, aid, _) in enumerate(BURST):
        if aid == 0:
            assert tout[i] == bare_out[i], (case, i)
    assert "adapter" in teng._dev and teng.n_adapters == 4


def test_adapter_range_is_checked_at_intake():
    tcfg = TConfig.tiny(dtype="float32")
    banked = TorchEngine(tcfg, _ecfg(TEngineConfig, "float32", "none",
                                     lora_adapters=2, lora_rank=RANK),
                         device="cpu")
    bare = TorchEngine(tcfg, _ecfg(TEngineConfig, "float32", "none"),
                       device="cpu")

    async def run():
        for eng, aid, match in ((banked, 2, "out of range"),
                                (banked, -1, "out of range"),
                                (bare, 1, "out of range")):
            with pytest.raises(ValueError, match=match):
                await _collect(eng, tproto, PROMPTS[0], aid, "m")
        await banked.stop()
        await bare.stop()

    asyncio.run(run())
    with pytest.raises(ValueError, match="no adapter bank"):
        bare.install_adapter(1, random_adapter(tcfg, RANK))


def test_speculation_stays_with_adapter_zero():
    """n-gram speculation on a banked engine: a variant's request runs on
    the fused round (no verify), a base request speculates; both streams
    equal TpuEngine's with the same knobs."""
    tcfg, jcfg = TConfig.tiny(dtype="float32"), JConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, 0)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(lora_adapters=3, lora_rank=RANK, speculative="ngram",
              num_speculative_tokens=2)
    # a repeating prompt, so n-gram lookup proposes
    prompt = (PROMPTS[0][:8] * 4)[:30]

    def make(pkg):
        if pkg == "jax":
            eng = TpuEngine(jcfg, _ecfg(JEngineConfig, "float32", "none",
                                        **kw),
                            params=jparams, mesh_config=MeshConfig(tp=1))
            variants = _variants(jcfg, jrandom_adapter)
        else:
            eng = TorchEngine(tcfg, _ecfg(TEngineConfig, "float32", "none",
                                          **kw),
                              params=tparams, device="cpu")
            variants = _variants(tcfg, random_adapter)
        for aid, w in variants.items():
            eng.install_adapter(aid, w)
        return eng

    async def go(eng, proto):
        try:
            variant = await _collect(eng, proto, prompt, 1, "base:v1", 16)
            verifies = eng.spec.stats()["spec_verify_dispatch_total"]
            base = await _collect(eng, proto, prompt, 0, "base", 16)
            return variant, verifies, base, eng.spec.stats()
        finally:
            await eng.stop()

    tv, t_verifies, tb, tstats = asyncio.run(go(make("torch"), tproto))
    jv, j_verifies, jb, _ = asyncio.run(go(make("jax"), jproto))
    assert t_verifies == 0 == j_verifies
    assert tstats["spec_verify_dispatch_total"] > 0
    assert (tv, tb) == (jv, jb)
