"""The port's encoder pass and image-row prefill against the JAX
package's, on ModelConfig.tiny (and tiny_moe) in f32 with the same
weights: ``llama.encode`` equals ``encode_impl`` at several lengths and
paddings (on tiny_moe too, where padding rows claim expert capacity as
in the reference), is padding-invariant on tiny, and
``llama.prefill(embeds=...)`` gives the reference's logits and context
region, fresh and continuing, dense and int8. ``TorchEngine.embed``
equals ``TpuEngine.embed``, refuses what the reference refuses, and
runs beside serving without moving a token.

Tolerances: pooled vectors 1e-5 (f32 sums in another order); logits
1e-4 and the region as tests/test_torch_llama.py holds it."""
import asyncio
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engines import EchoEngine as REcho
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engines import EchoEngine as PEcho
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.protocols import common as tproto
from tests.test_torch_llama import (  # noqa: F401 — model is a fixture
    B,
    S,
    _assert_region,
    _both,
    _int8_region,
    _region,
    model,
)

VEC_TOL = dict(rtol=1e-5, atol=1e-5)
ENGINE_KW = dict(num_pages=32, page_size=16, max_pages_per_seq=8,
                 max_decode_slots=2, prefill_buckets=(32,),
                 cache_dtype="float32")


@pytest.fixture(scope="module")
def moe_model():
    jcfg = JConfig.tiny_moe(dtype="float32")
    jparams = jl.init_params(jcfg, 0)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jcfg, TConfig.tiny_moe(dtype="float32"), jparams, tparams


def _tokens(T, n, seed, vocab):
    toks = np.zeros(T, np.int32)
    toks[:n] = np.random.RandomState(seed).randint(1, vocab, size=n)
    return toks


@pytest.mark.parametrize("T,n", [(8, 3), (16, 11), (32, 32), (64, 5),
                                 (128, 100)])
@pytest.mark.parametrize("moe", [False, True], ids=["tiny", "tiny_moe"])
def test_encode_matches_reference(model, moe_model, T, n, moe):
    jcfg, tcfg, jparams, tparams = (moe_model if moe else model[:4])
    toks = _tokens(T, n, seed=T + n, vocab=jcfg.vocab_size)
    want = np.asarray(jl.encode(jcfg, jparams, jnp.asarray(toks),
                                jnp.int32(n)))
    got = tl.encode(tcfg, tparams, torch.from_numpy(toks), n)
    assert got.dtype == torch.float32 and got.shape == (jcfg.hidden_size,)
    np.testing.assert_allclose(got.numpy(), want, **VEC_TOL)
    assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-5


def test_encode_is_padding_invariant(model):
    _, tcfg, _, tparams = model[:4]
    prompt = list(range(1, 12))

    def run(pad_to):
        toks = np.zeros(pad_to, np.int32)
        toks[: len(prompt)] = prompt
        return tl.encode(tcfg, tparams, torch.from_numpy(toks),
                         len(prompt)).numpy()

    a = run(16)
    for pad in (32, 128):
        np.testing.assert_allclose(run(pad), a, rtol=1e-5, atol=1e-6)
    other = np.zeros(16, np.int32)
    other[:5] = [9, 8, 7, 6, 5]
    c = tl.encode(tcfg, tparams, torch.from_numpy(other), 5).numpy()
    assert not np.allclose(a, c)


def _override(cfg, T, rows, seed):
    """[T, H] override rows and their [T] mask: image rows at ``rows``."""
    rng = np.random.RandomState(seed)
    ov = np.zeros((T, cfg.hidden_size), np.float32)
    msk = np.zeros(T, bool)
    ov[rows] = rng.randn(len(range(T)[rows]), cfg.hidden_size) * 0.5
    msk[rows] = True
    return ov, msk


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_prefill_with_embeds_matches_reference(model, quant):
    """Image rows replace the token embeddings where the mask is set:
    the same logits and region as the reference's prefill, fresh and
    continuing over prior context, and a chunk without rows equals the
    plain prefill."""
    jcfg, tcfg, jparams, tparams, _ = model
    state = (_int8_region(jcfg, B + 1, S, seed=21) if quant
             else _region(jcfg, B + 1, S, seed=21))
    jctx, tctx = _both(state)
    toks = np.random.RandomState(22).randint(
        0, jcfg.vocab_size, size=32).astype(np.int32)
    for slot, q_start, seq_len, rows in [(1, 0, 20, slice(4, 12)),
                                         (2, 16, 40, slice(0, 7)),
                                         (0, 0, 32, slice(20, 32))]:
        ov, msk = _override(jcfg, 32, rows, seed=slot)
        jctx, jlogits = jl.prefill_impl(
            jcfg, jparams, jctx, jnp.asarray(toks), jnp.int32(slot),
            jnp.int32(q_start), jnp.int32(seq_len), jnp.asarray(ov),
            jnp.asarray(msk))
        tlogits = tl.prefill(tcfg, tparams, tctx, torch.from_numpy(toks),
                             slot, q_start, seq_len,
                             embeds=torch.from_numpy(ov),
                             embeds_mask=torch.from_numpy(msk))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        _assert_region(tctx, jctx)
    # the rows reach the model: other rows, other logits
    _, tplain = _both(state)
    plain = tl.prefill(tcfg, tparams, tplain, torch.from_numpy(toks), 1, 0,
                       20)
    ov, msk = _override(jcfg, 32, slice(4, 12), seed=1)
    _, tinj = _both(state)
    inj = tl.prefill(tcfg, tparams, tinj, torch.from_numpy(toks), 1, 0, 20,
                     embeds=torch.from_numpy(ov),
                     embeds_mask=torch.from_numpy(msk))
    assert not torch.allclose(plain, inj)
    _, tnone = _both(state)
    none = tl.prefill(tcfg, tparams, tnone, torch.from_numpy(toks), 1, 0,
                      20, embeds=torch.from_numpy(ov),
                      embeds_mask=torch.zeros(32, dtype=torch.bool))
    assert torch.equal(none, plain)


def _engines(model):
    jcfg, tcfg, jparams, tparams, _ = model
    jeng = TpuEngine(jcfg, JEngineConfig(**ENGINE_KW), params=jparams,
                     mesh_config=MeshConfig(tp=1))
    teng = TorchEngine(tcfg, TEngineConfig(**ENGINE_KW), params=tparams,
                       device="cpu")
    return jeng, teng


def test_engine_embed_matches_reference(model):
    jeng, teng = _engines(model)
    for ids in ([5], list(range(1, 12)), list(range(3, 40)),
                [int(t) for t in np.random.RandomState(0).randint(
                    1, 256, size=128)]):
        want = jeng.embed(ids)
        got = teng.embed(ids)
        assert isinstance(got, list) and len(got) == len(want)
        np.testing.assert_allclose(got, want, **VEC_TOL)
    assert teng.dispatch_counts["encode"] == 4
    assert jeng.dispatch_counts["encode"] == 4
    for bad in ([], list(range(1, 130))):   # empty; past max_context 128
        with pytest.raises(ValueError) as je:
            jeng.embed(bad)
        with pytest.raises(ValueError) as te:
            teng.embed(bad)
        assert str(te.value) == str(je.value)
    assert teng.dispatch_counts["encode"] == 4


def test_echo_embed_matches_reference():
    for ids in ([1], [3, 4, 5], list(range(40))):
        assert PEcho().embed(ids) == REcho().embed(ids)
        assert PEcho().embed(ids, dim=8) == REcho().embed(ids, dim=8)


async def _burst(eng, prompts, n_new):
    async def one(p):
        req = tproto.PreprocessedRequest(
            token_ids=list(p), stop_conditions=tproto.StopConditions(
                max_tokens=n_new, ignore_eos=True))
        toks = []
        async for out in eng.generate(req):
            toks.extend(out.token_ids)
        return toks

    return await asyncio.gather(*[one(p) for p in prompts])


def test_engine_embed_beside_serving_moves_no_token(model):
    """embed() called from other threads while a burst decodes: the
    burst's tokens equal those of the same burst without them, and each
    vector equals the one computed alone."""
    _, tcfg, _, tparams, _ = model
    prompts = [list(range(1, 20)), list(range(7, 30))]
    quiet = TorchEngine(tcfg, TEngineConfig(**ENGINE_KW), params=tparams,
                        device="cpu")
    want = asyncio.run(_burst(quiet, prompts, 16))
    asyncio.run(quiet.stop())
    eng = TorchEngine(tcfg, TEngineConfig(**ENGINE_KW), params=tparams,
                      device="cpu")
    alone = eng.embed([1, 2, 3, 4, 5])
    got_vecs: list = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            got_vecs.append(eng.embed([1, 2, 3, 4, 5]))

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        got = asyncio.run(_burst(eng, prompts, 16))
    finally:
        stop.set()
        for t in threads:
            t.join()
        asyncio.run(eng.stop())
    assert got == want
    assert got_vecs and all(v == alone for v in got_vecs)
