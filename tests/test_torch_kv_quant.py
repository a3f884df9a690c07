"""The port's int8 KV (kv_quant.py and the int8 state programs of
models/llama.py) against the JAX package's on the same numpy-made inputs.

Tolerances: int8 bytes and scales EXACT (the same f32 arithmetic, and
``torch.round``/``jnp.round`` both round half to even); dequantized f32
values to 1e-6. Ring flushes compare live lanes only: vacated lanes all
alias the scratch lane, whose overlapping writes are garbage by contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import kv_quant as jq
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu_torch import kv_quant as tq
from dynamo_tpu_torch.models import llama as tl

CFG = JConfig.tiny(dtype="float32")
LY, KVH, HD = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim
B, S, PS, R, P = 3, 64, 16, 4, 12


def _int8_region(seed, lanes, length, group=PS):
    """An int8 region with scales [L, lanes, length/group]."""
    rng = np.random.RandomState(seed)
    shape = (LY, KVH, lanes, length, HD)
    out = {n: rng.randint(-127, 128, size=shape).astype(np.int8)
           for n in "kv"}
    for n in "kv":
        out[n + "_scale"] = (rng.rand(LY, lanes, length // group) * 0.02
                             + 1e-3).astype(np.float32)
    return out


def _int8_pool(seed):
    region = _int8_region(seed, P, PS)
    for n in "kv":
        region[n + "_scale"] = region[n + "_scale"][:, :, 0]   # [L, P]
    return region


def _both(state):
    return ({n: jnp.asarray(a) for n, a in state.items()},
            {n: torch.from_numpy(a.copy()) for n, a in state.items()})


def _assert_equal(t, j, lanes=None):
    for n, a in j.items():
        a, b = np.asarray(a), t[n].numpy()
        if lanes is not None:
            idx = (slice(None), slice(None), lanes) if n in "kv" else (
                slice(None), lanes)
            a, b = a[idx], b[idx]
        np.testing.assert_array_equal(b, a, err_msg=n)


def test_dequantize_groups_matches_jax():
    rng = np.random.RandomState(0)
    q = rng.randint(-127, 128, size=(LY, KVH, 3, 48, HD)).astype(np.int8)
    sc = (rng.rand(LY, 3, 3) * 0.05).astype(np.float32)
    want = np.asarray(jq.dequantize_groups(jnp.asarray(q), jnp.asarray(sc), 16))
    got = tq.dequantize_groups(torch.from_numpy(q), torch.from_numpy(sc),
                               16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_requantize_groups_matches_jax(seed):
    """Random valid masks and written groups; exact halves (x.5 steps)
    included so that round-half-to-even is exercised."""
    rng = np.random.RandomState(seed)
    N, W, g = 3, 48, 16
    wf = (rng.randn(LY, KVH, N, W, HD) * 0.3).astype(np.float32)
    old = (rng.rand(LY, N, W // g) * 0.01 + 1e-3).astype(np.float32)
    # exact half steps of the old scale in the untouched groups
    wf[..., :4] = (np.arange(4) + 0.5)[None] * old[:, None, :, :1, None]
    valid = rng.rand(N, W) < 0.7
    written = rng.rand(N, W // g) < 0.5
    jqv, js = jq.requantize_groups(jnp.asarray(wf), jnp.asarray(old),
                                   jnp.asarray(valid), jnp.asarray(written), g)
    tqv, ts = tq.requantize_groups(torch.from_numpy(wf), torch.from_numpy(old),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(written), g)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("start,T,valid_t", [
    (0, 16, None),     # group-aligned, whole span real
    (5, 16, 10),       # straddles two groups, padded tail
    (16, 32, 20),      # two-group span from a boundary
    (30, 16, 3),       # a few real rows, window clipped to the region end
    (48, 16, 16),      # the last group
    (56, 8, 3),        # past the region end: offset clamped as DUS does
])
def test_quant_store_span_matches_jax(start, T, valid_t):
    """A stale suffix from a previous slot occupant (huge values past the
    span) must not feed a scale: the port's bytes and scales equal the
    JAX version's, and each written group's scale is the absmax of its
    real rows only."""
    state = _int8_region(3, B + 1, S)
    slot = 1
    state["k"][:, :, slot, start + (valid_t or T):] = 127
    state["k_scale"][:, slot] *= 50.0        # stale: huge dequantized
    span = (np.random.RandomState(4).randn(LY, KVH, T, HD)
            * 0.4).astype(np.float32)
    jb, tb = _both(state)
    vt = None if valid_t is None else jnp.int32(valid_t)
    jk, jsc = jl._quant_store_span(jb["k"], jb["k_scale"], jnp.int32(slot),
                                   jnp.int32(start), jnp.asarray(span), PS,
                                   valid_t=vt)
    tl._quant_store_span(tb["k"], tb["k_scale"], slot, start,
                         torch.from_numpy(span), PS, valid_t=valid_t)
    np.testing.assert_array_equal(tb["k"].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tb["k_scale"].numpy(), np.asarray(jsc))
    if start + T <= S and start % PS == 0 and valid_t in (None, T):
        # a group wholly inside the span: its scale is the span's absmax
        g = start // PS
        want = np.abs(span[:, :, :PS]).max(axis=(1, 2, 3)) / 127.0
        np.testing.assert_allclose(tb["k_scale"][:, slot, g].numpy(), want,
                                   rtol=1e-6)


@pytest.mark.parametrize("dest,base,valid", [
    ([0, B, 2], [10, 5, S - 2], [3, 4, 4]),   # a freed lane, region end
    ([0, 1, 2], [0, 14, 30], [4, 4, 0]),      # straddles, empty ring
    ([2, 0, 1], [60, 15, 16], [4, 2, 1]),     # past the end, boundaries
    ([B, B, 1], [3, 40, 20], [4, 4, 4]),      # two vacated lanes alias
])
def test_flush_ctx_int8_matches_jax(dest, base, valid):
    jctx, tctx = _both(_int8_region(5, B + 1, S))
    ring = np.random.RandomState(6).randn(LY, KVH, B, R, HD).astype(
        np.float32) * 0.5
    dest, base, valid = (np.asarray(a, np.int32) for a in (dest, base, valid))
    jout = jl.flush_ctx_impl(jctx, {"k": jnp.asarray(ring),
                                    "v": jnp.asarray(ring * 0.7)},
                             jnp.asarray(dest), jnp.asarray(base),
                             jnp.asarray(valid))
    tl.flush_ctx(tctx, {"k": torch.from_numpy(ring),
                        "v": torch.from_numpy(ring * 0.7)},
                 torch.from_numpy(dest), torch.from_numpy(base),
                 torch.from_numpy(valid))
    live = sorted(set(dest.tolist()) - {B})
    _assert_equal(tctx, jout, lanes=live)
    # lanes nobody flushed into are untouched
    idle = sorted(set(range(B)) - set(live))
    _assert_equal(tctx, jctx, lanes=idle)


def test_seal_blocks_int8_matches_jax():
    """A raw copy of the int8 blocks and their scales (padding row ->
    scratch page 0, not compared)."""
    jctx, tctx = _both(_int8_region(7, B + 1, S))
    jcache, tcache = _both(_int8_pool(8))
    slots = np.asarray([0, 2, 2, 0], np.int32)
    starts = np.asarray([16, 0, 48, 0], np.int32)
    pages = np.asarray([4, 1, 11, 0], np.int32)
    jout = jl.seal_blocks_impl(jcache, jctx, jnp.asarray(slots),
                               jnp.asarray(starts), jnp.asarray(pages), PS)
    tl.seal_blocks(tcache, tctx, torch.from_numpy(slots),
                   torch.from_numpy(starts), torch.from_numpy(pages), PS)
    for n in "kv":
        np.testing.assert_array_equal(tcache[n][:, :, 1:].numpy(),
                                      np.asarray(jout[n])[:, :, 1:])
        np.testing.assert_array_equal(tcache[n + "_scale"][:, 1:].numpy(),
                                      np.asarray(jout[n + "_scale"])[:, 1:])


@pytest.mark.parametrize("page_ids", [[3, 7], [5, 1, 9, 0, 0, 0, 0, 0]])
def test_load_ctx_pages_int8_matches_jax(page_ids):
    """A raw page copy plus a scale copy; the pow2-padded list is clamped
    to the region."""
    jctx, tctx = _both(_int8_region(9, B + 1, S))
    jcache, tcache = _both(_int8_pool(10))
    ids = np.asarray(page_ids, np.int32)
    jout = jl.load_ctx_pages_impl(jctx, jcache, jnp.int32(1), jnp.asarray(ids))
    tl.load_ctx_pages(tctx, tcache, 1, torch.from_numpy(ids))
    _assert_equal(tctx, jout)


def test_cross_mode_copies_are_refused():
    """Until the transfer plane was ported a dense pool beside an int8
    region was refused; it is now served as the reference serves it: the
    dense pages quantize per (layer, page) on the way in, byte-equal to
    the JAX package's load_ctx_pages_impl."""
    jctx, tctx = _both(_int8_region(11, B + 1, S))
    vals = np.random.RandomState(13).randn(LY, KVH, P, PS, HD).astype(
        np.float32)
    jdense = {n: jnp.asarray(vals * (1.0 if n == "k" else 0.5)) for n in "kv"}
    tdense = {n: torch.from_numpy(np.array(a)) for n, a in jdense.items()}
    ids = np.asarray([3, 5], np.int32)
    jout = jl.load_ctx_pages_impl(jctx, jdense, jnp.int32(1),
                                  jnp.asarray(ids))
    tl.load_ctx_pages(tctx, tdense, 1, torch.from_numpy(ids))
    _assert_equal(tctx, jout)


def test_seal_load_roundtrip_within_half_a_step():
    """ctx (dense values quantized on store) -> int8 pool -> another lane
    reproduces every element within half a quantization step
    (absmax/254 per layer and block) of the original f32 values, as
    tests/test_kv_quant.py pins the JAX version."""
    vals = np.random.RandomState(12).randn(LY, KVH, S, HD).astype(np.float32)
    ctx = tl.init_ctx(CFG, 2, S, torch.float32, "cpu", kv_quant="int8",
                      group=PS)
    cache = tl.init_cache(CFG, 8, PS, torch.float32, "cpu", kv_quant="int8")
    for n, scale in (("k", 1.0), ("v", 0.5)):
        tl._quant_store_span(ctx[n], ctx[n + "_scale"], 0, 0,
                             torch.from_numpy(vals * scale), PS)
    tl.seal_blocks(cache, ctx, torch.zeros(4, dtype=torch.int32),
                   torch.arange(0, S, PS, dtype=torch.int32),
                   torch.arange(1, 5, dtype=torch.int32), PS)
    tl.load_ctx_pages(ctx, cache, 1, torch.arange(1, 5))
    for n, scale in (("k", 1.0), ("v", 0.5)):
        for layer in range(LY):
            got = tl._ctx_slot_slab(ctx, n, layer, 1, torch.float32).numpy()
            want = vals[layer] * scale
            for blk in range(S // PS):
                sl = slice(blk * PS, (blk + 1) * PS)
                step = np.abs(want[:, sl]).max() / 127.0
                assert np.abs(got[:, sl] - want[:, sl]).max() <= (
                    step * 0.5 + 1e-6)
