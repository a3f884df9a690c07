"""Parity of the PyTorch port's ops with the JAX package's: rope, the
plain flash-decode in its dense and int8 modes (against both the Pallas
kernel in interpret mode and the pure-jnp reference), the blocked prefill
attention and the dense single-request prefill attention. Inputs are made
with numpy from a seed and fed to both sides."""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.ops import attention as jattn
from dynamo_tpu.ops import flash_decode as jfd
from dynamo_tpu.ops import rope as jrope
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.ops import flash_decode as tfd
from dynamo_tpu_torch.ops import rope as trope

L, NKV, NH, HD = 3, 2, 4, 16
B, S, R = 4, 64, 4

LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 8192,
}


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING])
@pytest.mark.parametrize("hd", [16, 128])
def test_rope_matches_jax(scaling, hd):
    """inv_freq is the same numpy code (exact); cos/sin and the rotation
    run in f32 on both sides (tolerance 1e-6, f32 trig)."""
    inv_j = jrope.rope_inv_freq(hd, 500000.0, scaling)
    inv_t = trope.rope_inv_freq(hd, 500000.0, scaling)
    np.testing.assert_array_equal(inv_j, inv_t)
    rng = np.random.RandomState(0)
    pos = rng.randint(0, 4096, size=(5,)).astype(np.int32)
    x = rng.randn(5, 3, hd).astype(np.float32)
    cj, sj = jrope.rope_cos_sin(jnp.asarray(pos), jnp.asarray(inv_j))
    ct, st = trope.rope_cos_sin(torch.from_numpy(pos), torch.from_numpy(inv_t))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    got = trope.apply_rope(torch.from_numpy(x), ct, st).numpy()
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), cj, sj))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def decode_data():
    rng = np.random.RandomState(0)
    return [
        (rng.randn(*shape) * 0.3).astype(np.float32) for shape in (
            (B, NH, HD), (L, NKV, B + 1, S, HD), (L, NKV, B + 1, S, HD),
            (L, NKV, B, R, HD), (L, NKV, B, R, HD),
        )
    ]


DECODE_PATTERNS = {
    # mid-round: ring holds 2 tokens beyond each slot's ctx base
    "mid_round": ([1, 15, 31, 60], [3, 17, 33, 62]),
    "ring_only": ([0, 0, 0, 0], [1, 2, 3, 4]),
    "single_token": ([0, 0, 0, 0], [1, 1, 1, 1]),
    # region full to the last position, ring base at the end
    "full_region": ([S - 1, S - 2, S - 4, 40], [S, S, S, 44]),
    # a freed lane (patched to ctx 1, base 0) beside live ones
    "freed_lane": ([30, 0, 12, 50], [32, 1, 14, 53]),
}


@pytest.mark.parametrize("pattern", sorted(DECODE_PATTERNS))
@pytest.mark.parametrize("layer", [0, L - 1])
def test_plain_flash_decode_matches_jax(decode_data, pattern, layer):
    """Plain port vs the jnp reference (same math in f32: 1e-5) and vs the
    Pallas kernel in interpret mode (its emulated MXU passes: 5e-3, as
    tests/test_flash_decode.py)."""
    base, ctx = (np.asarray(a, np.int32) for a in DECODE_PATTERNS[pattern])
    j_in = [jnp.asarray(a) for a in decode_data]
    t_in = [torch.from_numpy(a) for a in decode_data]
    q, ck, cv, rk, rv = j_in
    want_ref = np.asarray(jfd.flash_decode_attention_reference(
        q, ck, cv, rk, rv, jnp.int32(layer), jnp.asarray(ctx),
        jnp.asarray(base)))
    want_kernel = np.asarray(jfd.flash_decode_attention(
        q, ck, cv, rk, rv, jnp.int32(layer), jnp.asarray(ctx),
        jnp.asarray(base), chunk=16, interpret=True))
    before = tfd.launches
    got = tfd.flash_decode_attention(
        *t_in, layer, torch.from_numpy(ctx), torch.from_numpy(base)).numpy()
    assert tfd.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_kernel, rtol=5e-3, atol=5e-3)


def test_pick_splits_fills_the_card():
    # Llama-3.1-8B serving shape: 64 (slot, KV head) pairs over 132 SMs
    assert tfd.pick_splits(8, 8, 4096, 64) == 9
    assert tfd.pick_splits(1, 1, 128, 64) == 2   # capped at the tile count
    assert tfd.pick_splits(64, 64, 4096, 64) == 1


def test_cluster_splits_fit_one_cluster():
    """The int8 bf16 kernel's context splits and its ring block form one
    thread-block cluster of at most 8 blocks."""
    assert tfd.MAX_CLUSTER == 8
    assert tfd.cluster_splits(8, 8, 4096, 64) == 7   # Llama-3.1-8B serve
    assert tfd.cluster_splits(1, 1, 128, 64) == 2    # capped at the tile count
    assert tfd.cluster_splits(1, 1, 64, 64) == 1
    assert tfd.cluster_splits(64, 64, 4096, 64) == 1
    for batch, kvh, s in [(1, 1, 4096), (2, 8, 4096), (4, 2, 640), (32, 8, 64)]:
        n = tfd.cluster_splits(batch, kvh, s, 64)
        assert 1 <= n <= min(tfd.MAX_CLUSTER - 1, -(-s // 64))
    # given how many clusters of each size the card holds at once (here
    # as an H100 reports it for the hd-128 kernel), the largest cluster
    # whose B * n_kv copies all fit in one wave
    held = {8: 62, 7: 69, 6: 79, 5: 94, 4: 124, 3: 170, 2: 264}
    assert tfd.cluster_splits(8, 8, 4096, 64, held) == 6
    assert tfd.cluster_splits(8, 8, 4096, 64, {n: 107 for n in held}) == 7
    assert tfd.cluster_splits(4, 8, 4096, 64, held) == 7   # 32 clusters fit
    assert tfd.cluster_splits(1, 1, 128, 64, held) == 2    # tile count first
    assert tfd.cluster_splits(64, 8, 4096, 64, held) == 1  # 512 never fit


def test_cluster_residency_per_mode_and_head_dim(monkeypatch):
    """The card is asked once per (device, mode, head dim): the dense
    kernel's larger blocks fit fewer clusters than the int8 kernel's, so
    at the Llama-3.1-8B serve shape it takes fewer splits."""
    tables = {  # (quant, hd) -> {cluster size: clusters held}
        (1, 128): {8: 62, 7: 69, 6: 79, 5: 94, 4: 124, 3: 170, 2: 264},
        (0, 128): {8: 46, 7: 52, 6: 60, 5: 70, 4: 90, 3: 124, 2: 190},
        (1, 64): {n: 107 for n in range(2, 9)},
        (0, 64): {n: 80 for n in range(2, 9)},
    }
    asked = []

    def max_active_clusters(quant, hd, cluster):
        asked.append((quant, hd, cluster))
        return tables[quant, hd][cluster]

    lib = type("Lib", (), {})()
    lib.flash_decode_max_active_clusters = max_active_clusters
    monkeypatch.setattr(tfd, "_resident", {})
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    dev = torch.device("cuda", 0)
    for quant in (False, True):
        for hd in (64, 128):
            assert tfd._cluster_residency(lib, dev, quant, hd) == tables[int(quant), hd]
    n_asked = len(asked)
    tfd._cluster_residency(lib, dev, False, 128)  # asked once, then kept
    assert len(asked) == n_asked == 4 * 7
    dense = tfd._cluster_residency(lib, dev, False, 128)
    int8 = tfd._cluster_residency(lib, dev, True, 128)
    assert tfd.cluster_splits(8, 8, 4096, 64, dense) == 4  # 70 clusters of 5
    assert tfd.cluster_splits(8, 8, 4096, 64, int8) == 6   # 69 clusters of 7
    assert tfd.cluster_splits(8, 8, 4096, 64,
                              tfd._cluster_residency(lib, dev, False, 64)) == 7


def _prefill_inputs(T, Sc, seed=0):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(T, NH, HD).astype(np.float32),
        rng.randn(NKV, Sc, HD).astype(np.float32),
        rng.randn(NKV, Sc, HD).astype(np.float32),
        rng.randn(T, NKV, HD).astype(np.float32),
        rng.randn(T, NKV, HD).astype(np.float32),
    )


@pytest.mark.parametrize("T,Sc,q_start,seq_len,with_ctx,block", [
    (32, 0, 0, 20, False, 256),   # fresh prefill, padded tail rows
    (32, 0, 0, 32, False, 8),     # fresh, several key blocks
    (16, 64, 24, 35, True, 16),   # continuation over prior context
    (16, 64, 40, 56, True, 256),  # continuation, one block
    (16, 64, 0, 0, True, 16),     # dummy lane: every row fully masked
    (8, 0, 0, 0, False, 256),     # dummy fresh lane
])
def test_prefill_attention_matches_jax(T, Sc, q_start, seq_len, with_ctx,
                                       block):
    """f32 on both sides, blocked running softmax: 1e-5. Fully masked rows
    must be exact zeros."""
    q, kc, vc, kn, vn = _prefill_inputs(T, max(Sc, 1))
    jk = (jnp.asarray(kc), jnp.asarray(vc)) if with_ctx else (None, None)
    tk = ((torch.from_numpy(kc), torch.from_numpy(vc)) if with_ctx
          else (None, None))
    want = np.asarray(jattn.flash_prefill_attention(
        jnp.asarray(q), *jk, jnp.asarray(kn), jnp.asarray(vn),
        jnp.int32(q_start), jnp.int32(seq_len), block=block))
    got = tattn.flash_prefill_attention(
        torch.from_numpy(q), *tk, torch.from_numpy(kn), torch.from_numpy(vn),
        q_start, seq_len, block=block).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if seq_len == 0:
        assert not got.any()


def _quantize_ctx(x, group):
    """Per-(layer, lane, group) absmax int8, as tests/test_flash_decode.py
    quantizes the region: (int8 [L, kvh, lanes, S, hd], f32 [L, lanes,
    S/group])."""
    lyr, kvh, lanes, s, hd = x.shape
    grouped = x.reshape(lyr, kvh, lanes, s // group, group, hd)
    scale = np.maximum(np.abs(grouped).max(axis=(1, 4, 5)) / 127.0,
                       1e-8).astype(np.float32)
    q = np.clip(np.rint(grouped / scale[:, None, :, :, None, None]),
                -127, 127).astype(np.int8).reshape(x.shape)
    return q, scale


@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("bases", [[1, 15, 31, 60], [15, 16, 17, 33]])
def test_plain_int8_flash_decode_matches_jax(decode_data, group, bases):
    """Int8 mode over group widths 16 and 64 (4 and 1 groups over S) and
    ring bases that straddle group boundaries: the plain port vs the
    quantized jnp reference (same f32 math: 1e-5) and vs the Pallas
    kernel in interpret mode (5e-3, as the dense mode)."""
    q, ck, cv, rk, rv = decode_data
    ck_q, ks = _quantize_ctx(ck, group)
    cv_q, vs = _quantize_ctx(cv, group)
    base = np.asarray(bases, np.int32)
    ctx = base + 2
    j_in = [jnp.asarray(a) for a in (q, ck_q, cv_q, rk, rv)]
    t_in = [torch.from_numpy(a) for a in (q, ck_q, cv_q, rk, rv)]
    for layer in (0, L - 1):
        want_ref = np.asarray(jfd.flash_decode_attention_reference(
            *j_in, jnp.int32(layer), jnp.asarray(ctx), jnp.asarray(base),
            ctx_k_scale=jnp.asarray(ks), ctx_v_scale=jnp.asarray(vs)))
        want_kernel = np.asarray(jfd.flash_decode_attention(
            *j_in, jnp.int32(layer), jnp.asarray(ctx), jnp.asarray(base),
            chunk=group, interpret=True, ctx_k_scale=jnp.asarray(ks),
            ctx_v_scale=jnp.asarray(vs)))
        before = tfd.launches_int8
        got = tfd.flash_decode_attention(
            *t_in, layer, torch.from_numpy(ctx), torch.from_numpy(base),
            torch.from_numpy(ks), torch.from_numpy(vs)).numpy()
        assert tfd.launches_int8 == before
        np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_kernel, rtol=5e-3, atol=5e-3)


# bf16 decode cases as the card serves them: head_dim 64, S = 64 (one
# 64-row chunk of the Pallas kernel holds a slot's whole ctx region)
BF16_NL, BF16_HD, BF16_S = 3, 64, 64
BF16_BASES = [
    [1, 15, 31, 60],    # mid-round, ctx and ring chunks
    [63, 62, 40, 2],    # region nearly full beside a short context
    [0, 0, 0, 0],       # ring only: one chunk holds the context
]


def _bf16_decode_data(seed):
    """q, ctx_k, ctx_v, ring_k, ring_v in f32 for the bf16 cases."""
    nkv, nh, b, r = 2, 4, 4, 4
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.3).astype(np.float32)
            for shape in ((b, nh, BF16_HD),
                          (BF16_NL, nkv, b + 1, BF16_S, BF16_HD),
                          (BF16_NL, nkv, b + 1, BF16_S, BF16_HD),
                          (BF16_NL, nkv, b, r, BF16_HD),
                          (BF16_NL, nkv, b, r, BF16_HD))]


@pytest.mark.parametrize("bases", BF16_BASES)
def test_plain_flash_decode_bf16_matches_jax(bases):
    """Dense mode in bf16 at head_dim 64, as the card serves it. The plain
    port equals the jnp reference bit for bit (both round the normalized
    probabilities to bf16). With p_round=bfloat16 it rounds P as the
    Pallas kernel (interpret mode) and the card's dense bf16 kernel do,
    exp(s - max) before P.V: exactly the Pallas output where one chunk
    holds the context, and otherwise within one bf16 step of the output
    (rtol 2**-7) plus 2**-9, as in the int8 mode."""
    base = np.asarray(bases, np.int32)
    ctx = base + 2
    data = _bf16_decode_data(2)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in data]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in data]
    for layer in (0, BF16_NL - 1):
        j_args = (*jb, jnp.int32(layer), jnp.asarray(ctx), jnp.asarray(base))
        want_ref = np.asarray(jfd.flash_decode_attention_reference(
            *j_args).astype(jnp.float32))
        want_kernel = np.asarray(jfd.flash_decode_attention(
            *j_args, chunk=BF16_S, interpret=True).astype(jnp.float32))
        t_args = (*tb, layer, torch.from_numpy(ctx), torch.from_numpy(base))
        before = tfd.launches
        got = tfd.flash_decode_attention(*t_args)
        assert tfd.launches == before  # CPU tensors take the plain version
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want_ref)
        got_p = tfd.flash_decode_attention_plain(
            *t_args, p_round=torch.bfloat16).float().numpy()
        if not base.any():
            np.testing.assert_array_equal(got_p, want_kernel)
        np.testing.assert_allclose(got_p, want_kernel, rtol=2**-7,
                                   atol=2**-9)


@pytest.mark.parametrize("bases", BF16_BASES)
def test_plain_int8_flash_decode_bf16_matches_jax(bases):
    """Int8 mode in bf16 with group 64 at head_dim 64, as the card serves
    it. The plain port equals the jnp reference bit for bit (both round
    the normalized probabilities to bf16). With p_round=bfloat16 it
    rounds P as the Pallas kernel (interpret mode) and the card's int8
    kernel do, exp(s - max) before P.V: exactly the Pallas output where
    one chunk holds the context, and otherwise within one bf16 step of
    the output (rtol 2**-7) plus 2**-9, the most that moving one
    probability's rounding point (the kernel's running max over its two
    chunks) can shift an output near zero."""
    nl, group = BF16_NL, BF16_S
    q, ck, cv, rk, rv = _bf16_decode_data(1)
    ck_q, ks = _quantize_ctx(ck, group)
    cv_q, vs = _quantize_ctx(cv, group)
    base = np.asarray(bases, np.int32)
    ctx = base + 2
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, rk, rv)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, rk, rv)]
    for layer in (0, nl - 1):
        j_args = (jb[0], jnp.asarray(ck_q), jnp.asarray(cv_q), jb[1], jb[2],
                  jnp.int32(layer), jnp.asarray(ctx), jnp.asarray(base))
        j_scales = dict(ctx_k_scale=jnp.asarray(ks), ctx_v_scale=jnp.asarray(vs))
        want_ref = np.asarray(jfd.flash_decode_attention_reference(
            *j_args, **j_scales).astype(jnp.float32))
        want_kernel = np.asarray(jfd.flash_decode_attention(
            *j_args, chunk=group, interpret=True,
            **j_scales).astype(jnp.float32))
        t_args = (tb[0], torch.from_numpy(ck_q), torch.from_numpy(cv_q),
                  tb[1], tb[2], layer, torch.from_numpy(ctx),
                  torch.from_numpy(base), torch.from_numpy(ks),
                  torch.from_numpy(vs))
        got = tfd.flash_decode_attention(*t_args)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want_ref)
        got_p = tfd.flash_decode_attention_plain(
            *t_args, p_round=torch.bfloat16).float().numpy()
        if not base.any():
            np.testing.assert_array_equal(got_p, want_kernel)
        np.testing.assert_allclose(got_p, want_kernel, rtol=2**-7,
                                   atol=2**-9)


@pytest.mark.parametrize("T,q_start,seq_len", [
    (32, 0, 20),    # fresh prefill, padded tail rows
    (16, 24, 35),   # continuation over prior context
    (16, 40, 56),   # continuation, chunk fully valid
    (16, 0, 0),     # every row fully masked
])
def test_ctx_prefill_attention_matches_jax(T, q_start, seq_len):
    """Dense [T, S+T] softmax over the slot's whole region, f32 on both
    sides: 1e-5."""
    q, kc, vc, kn, vn = _prefill_inputs(T, S, seed=3)
    want = np.asarray(jattn.ctx_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
        jnp.asarray(vn), jnp.int32(q_start), jnp.int32(seq_len)))
    got = tattn.ctx_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(kn), torch.from_numpy(vn), q_start,
        seq_len).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
