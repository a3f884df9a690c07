"""Parity of the PyTorch port's Llama model and serving-state programs
with the JAX package's, on ModelConfig.tiny in f32: the same weights
(params_from_jax) and the same numpy-made state go through both.

Tolerances: logits and computed KV 1e-5 (f32 matmuls summed in another
order; 1e-4 for logits read through an int8 region); pure copy programs
(flush, load, seal) must be bit-equal on every lane and page that is not
scratch (scratch lane B and page 0 are garbage by contract). Int8 region
bytes written from computed KV are exact but for a value that the other
summation order puts on the other side of a half step (at most one step,
in at most 0.1% of the bytes); their scales, absmaxes of computed values,
agree to 1e-6 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig

B, S, PS, P, R = 3, 64, 16, 12, 4


@pytest.fixture(scope="module")
def model():
    jcfg = JConfig.tiny(dtype="float32")
    tcfg = TConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, 0)
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = tl.params_from_jax(np_params, device="cpu")
    return jcfg, tcfg, jparams, tparams, np_params


def _region(cfg, lanes, length, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.num_layers, cfg.num_kv_heads, lanes, length, cfg.head_dim)
    return {n: (rng.randn(*shape) * 0.5).astype(np.float32) for n in "kv"}


def _both(state):
    return ({n: jnp.asarray(a) for n, a in state.items()},
            {n: torch.from_numpy(a.copy()) for n, a in state.items()})


def test_params_from_jax_carries_every_leaf(model):
    _, tcfg, _, tparams, np_params = model
    flat_j = jax.tree_util.tree_leaves_with_path(np_params)
    assert len(flat_j) == 12  # embed, lm_head, norm_f + 9 layer stacks
    for path, leaf in flat_j:
        t = tparams
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), leaf)
    assert tparams["layers"]["wq"].shape == (
        tcfg.num_layers, tcfg.hidden_size, tcfg.q_dim)  # [L, in, out]


def test_init_params_is_seeded_and_scaled(model):
    _, tcfg, _, _, np_params = model
    a = tl.init_params(tcfg, seed=3, device="cpu")
    b = tl.init_params(tcfg, seed=3, device="cpu")
    for name in ("embed", "lm_head"):
        assert torch.equal(a[name], b[name])
        assert a[name].shape == np_params[name].shape
    assert a["layers"]["wg"].std().item() == pytest.approx(
        float(np_params["layers"]["wg"].std()), rel=0.1)


def test_batch_prefill_matches_jax(model):
    """Two live chunks (one continuing over prior context) plus a
    scratch-lane dummy: logits and the written region agree."""
    jcfg, tcfg, jparams, tparams, _ = model
    state = _region(jcfg, B + 1, S, seed=1)
    jctx, tctx = _both(state)
    rng = np.random.RandomState(2)
    T = 32
    toks = rng.randint(0, jcfg.vocab_size, size=(3, T)).astype(np.int32)
    slots, q_starts, seq_lens = [0, 2, B], [0, 16, 0], [20, 40, 0]
    jctx, jlogits = jl.batch_prefill_impl(
        jcfg, jparams, jctx, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(q_starts), jnp.asarray(seq_lens), 16)
    tlogits = tl.batch_prefill(
        tcfg, tparams, tctx, torch.from_numpy(toks), slots, q_starts,
        seq_lens, 16)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    for n in "kv":
        np.testing.assert_allclose(
            tctx[n][:, :, :B].numpy(), np.asarray(jctx[n])[:, :, :B],
            rtol=1e-5, atol=1e-5)


def test_decode_step_matches_jax(model):
    jcfg, tcfg, jparams, tparams, _ = model
    jctx, tctx = _both(_region(jcfg, B + 1, S, seed=3))
    jring, tring = _both(_region(jcfg, B, R, seed=4))
    rng = np.random.RandomState(5)
    toks = rng.randint(0, jcfg.vocab_size, size=B).astype(np.int32)
    ring_base = np.asarray([0, 17, 40], np.int32)
    ring_pos = 2
    ctx_lens = ring_base + ring_pos + 1
    jring, jlogits = jl.decode_step_impl(
        jcfg, jparams, jctx, jring, jnp.asarray(toks), jnp.asarray(ctx_lens),
        jnp.asarray(ring_base), jnp.int32(ring_pos))
    tlogits = tl.decode_step(
        tcfg, tparams, tctx, tring, torch.from_numpy(toks),
        torch.from_numpy(ctx_lens), torch.from_numpy(ring_base), ring_pos)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    for n in "kv":
        np.testing.assert_allclose(tring[n].numpy(), np.asarray(jring[n]),
                                   rtol=1e-5, atol=1e-5)


def test_flush_ctx_matches_jax(model):
    """Live lanes, a partially valid ring, a freed lane redirected to
    scratch and a ring running past the region end."""
    jcfg = model[0]
    jctx, tctx = _both(_region(jcfg, B + 1, S, seed=6))
    jring, tring = _both(_region(jcfg, B, R, seed=7))
    dest = np.asarray([0, B, 2], np.int32)          # lane 1 freed
    ring_base = np.asarray([10, 5, S - 2], np.int32)
    valid = np.asarray([4, 4, 4], np.int32)
    valid[0] = 3
    jout = jl.flush_ctx_impl(jctx, jring, jnp.asarray(dest),
                             jnp.asarray(ring_base), jnp.asarray(valid))
    tl.flush_ctx(tctx, tring, torch.from_numpy(dest),
                 torch.from_numpy(ring_base), torch.from_numpy(valid))
    for n in "kv":
        np.testing.assert_array_equal(
            tctx[n][:, :, :B].numpy(), np.asarray(jout[n])[:, :, :B])


@pytest.mark.parametrize("page_ids", [[3, 7], [5, 1, 9, 0, 0, 0, 0, 0]])
def test_load_ctx_pages_matches_jax(model, page_ids):
    """The second list is pow2-padded past the region (8 pages x 16 > S):
    the load clamps to the region."""
    jcfg = model[0]
    jctx, tctx = _both(_region(jcfg, B + 1, S, seed=8))
    jcache, tcache = _both(_region(jcfg, P, PS, seed=9))
    ids = np.asarray(page_ids, np.int32)
    jout = jl.load_ctx_pages_impl(jctx, jcache, jnp.int32(1), jnp.asarray(ids))
    tl.load_ctx_pages(tctx, tcache, 1, torch.from_numpy(ids))
    for n in "kv":
        np.testing.assert_array_equal(tctx[n].numpy(), np.asarray(jout[n]))


def test_seal_blocks_matches_jax(model):
    jcfg = model[0]
    jctx, tctx = _both(_region(jcfg, B + 1, S, seed=10))
    jcache, tcache = _both(_region(jcfg, P, PS, seed=11))
    slots = np.asarray([0, 2, 2, 0], np.int32)      # last row: padding
    starts = np.asarray([16, 0, 48, 0], np.int32)
    pages = np.asarray([4, 1, 11, 0], np.int32)
    jout = jl.seal_blocks_impl(jcache, jctx, jnp.asarray(slots),
                               jnp.asarray(starts), jnp.asarray(pages), PS)
    tl.seal_blocks(tcache, tctx, torch.from_numpy(slots),
                   torch.from_numpy(starts), torch.from_numpy(pages), PS)
    for n in "kv":
        np.testing.assert_array_equal(
            tcache[n][:, :, 1:].numpy(), np.asarray(jout[n])[:, :, 1:])


def _int8_region(cfg, lanes, length, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.num_layers, cfg.num_kv_heads, lanes, length, cfg.head_dim)
    out = {n: rng.randint(-127, 128, size=shape).astype(np.int8)
           for n in "kv"}
    for n in "kv":
        out[n + "_scale"] = (rng.rand(cfg.num_layers, lanes, length // PS)
                             * 0.02 + 1e-3).astype(np.float32)
    return out


def _assert_region(tctx, jctx, lanes=slice(None)):
    for n, a in jctx.items():
        a, b = np.asarray(a), tctx[n].numpy()
        if n in "kv":
            if a.dtype == np.int8:
                diff = np.abs(b[:, :, lanes].astype(np.int32)
                              - a[:, :, lanes].astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, n
            else:
                np.testing.assert_allclose(b[:, :, lanes], a[:, :, lanes],
                                           rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(b[:, lanes], a[:, lanes], rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_matches_jax(model, quant):
    """The single-request prefill, fresh and continuing over prior
    context (a padded chunk), dense and int8."""
    jcfg, tcfg, jparams, tparams, _ = model
    state = (_int8_region(jcfg, B + 1, S, seed=12) if quant
             else _region(jcfg, B + 1, S, seed=12))
    jctx, tctx = _both(state)
    toks = np.random.RandomState(13).randint(
        0, jcfg.vocab_size, size=32).astype(np.int32)
    for slot, q_start, seq_len in [(1, 0, 20), (2, 16, 40)]:
        jctx, jlogits = jl.prefill_impl(
            jcfg, jparams, jctx, jnp.asarray(toks), jnp.int32(slot),
            jnp.int32(q_start), jnp.int32(seq_len))
        tlogits = tl.prefill(tcfg, tparams, tctx, torch.from_numpy(toks),
                             slot, q_start, seq_len)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        _assert_region(tctx, jctx)


def test_batch_prefill_int8_matches_jax(model):
    jcfg, tcfg, jparams, tparams, _ = model
    jctx, tctx = _both(_int8_region(jcfg, B + 1, S, seed=14))
    toks = np.random.RandomState(15).randint(
        0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    slots, q_starts, seq_lens = [0, 2], [0, 24], [25, 50]
    jctx, jlogits = jl.batch_prefill_impl(
        jcfg, jparams, jctx, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(q_starts), jnp.asarray(seq_lens), S)
    tlogits = tl.batch_prefill(tcfg, tparams, tctx, torch.from_numpy(toks),
                               slots, q_starts, seq_lens, S)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    _assert_region(tctx, jctx, lanes=slice(0, B))


def test_decode_step_int8_matches_jax(model):
    """Decode reads the int8 region through the plain int8 flash decode;
    the ring (compute dtype) is written as in dense mode."""
    jcfg, tcfg, jparams, tparams, _ = model
    jctx, tctx = _both(_int8_region(jcfg, B + 1, S, seed=16))
    jring, tring = _both(_region(jcfg, B, R, seed=17))
    toks = np.random.RandomState(18).randint(
        0, jcfg.vocab_size, size=B).astype(np.int32)
    ring_base = np.asarray([0, 17, 40], np.int32)
    ctx_lens = ring_base + 2
    jring, jlogits = jl.decode_step_impl(
        jcfg, jparams, jctx, jring, jnp.asarray(toks), jnp.asarray(ctx_lens),
        jnp.asarray(ring_base), jnp.int32(1))
    tlogits = tl.decode_step(
        tcfg, tparams, tctx, tring, torch.from_numpy(toks),
        torch.from_numpy(ctx_lens), torch.from_numpy(ring_base), 1)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    for n in "kv":
        np.testing.assert_allclose(tring[n].numpy(), np.asarray(jring[n]),
                                   rtol=1e-5, atol=1e-5)
