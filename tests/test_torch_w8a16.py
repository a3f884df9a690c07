"""w8a16 weights in the PyTorch port against the JAX package, and the f32
logits product of a bf16 model.

Each test feeds the same numpy-made inputs (or the same JAX-made weights,
carried across by params_from_jax) to the JAX function and its port
counterpart on the CPU, where the port's w8a16 wrapper runs its plain
version. Tolerances:
  - quantize_tensor: q bit-equal, s within 1 f32 ulp (the same f32 amax
    and division on both sides);
  - a product in f32: 1e-5 of the output's scale (another summation
    order); in bf16: one bf16 step of the value (2**-7 relative; the two
    frameworks may round an f32 sum that lies near a half step apart);
  - model logits (prefill, decode) and engine logprobs: 1e-4, as the
    dense parity tests; greedy tokens identical. With int8 KV a computed
    K/V value that the two summation orders put on the two sides of a
    rounding half step is stored one int8 step apart (tests/
    test_torch_llama.py allows one step in 0.1% of the bytes); here one V
    byte of the second request's prefill does so, which moves that
    request's later logprobs by up to 1.3e-4, so int8 KV is held to
    5e-4;
  - the f32 logits product of bf16 operands: 1e-5 relative to the
    logits' scale, which a product rounded to bf16 (2**-9 relative)
    fails.
"""
import asyncio
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from dynamo_tpu_torch.ops import w8a16
from dynamo_tpu_torch.protocols import common as tproto

ROOT = Path(__file__).resolve().parent.parent
B, S, R = 3, 64, 4
BF16_STEP = 2.0 ** -7


def _bf16_np(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _torch(a):
    """A numpy array (ml_dtypes bf16 included) as a CPU tensor."""
    return tl._tensor_from_numpy(np.asarray(a), "cpu")


def _to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.fixture(scope="module")
def model():
    jcfg = JConfig.tiny(quant="int8", dtype="float32")
    tcfg = TConfig.tiny(quant="int8", dtype="float32")
    jparams = jl.init_params(jcfg, 0)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tl.params_from_jax(np_params, "cpu"), np_params


# ---------------------------------------------------------------------------
# quantization


def _weights(seed, shape, zero_channel_axis=None):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.05
    if zero_channel_axis is not None:
        # one all-zero output channel: the scale floors at 1e-10
        idx = [slice(None)] * w.ndim
        idx[zero_channel_axis] = 3
        w[tuple(idx)] = 0.0
    return w


@pytest.mark.parametrize("axis,shape", [
    (-2, (2, 48, 32)),   # a stacked layer weight [L, in, out]
    (-2, (64, 96)),      # lm_head [H, V]
    (-1, (96, 64)),      # embed [V, H], one scale per row
])
def test_quantize_tensor_matches_jax(axis, shape):
    keep = -1 if axis == -2 else -2  # the axis the scales run along
    w = _weights(1, shape, zero_channel_axis=keep)
    want = jl.quantize_tensor(jnp.asarray(w), axis)
    got = tl.quantize_tensor(torch.from_numpy(w), axis)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    s_want = np.asarray(want["s"])
    assert got["s"].shape == s_want.shape
    assert np.all(np.abs(got["s"].numpy() - s_want)
                  <= np.spacing(np.abs(s_want)))
    assert s_want.min() == np.float32(1e-10)  # the zero channel's floor


def test_quantize_tensor_matches_jax_on_bf16_weights():
    w = _bf16_np(_weights(2, (48, 32)))
    want = jl.quantize_tensor(jnp.asarray(w), -2)
    got = tl.quantize_tensor(_torch(w), -2)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


def test_quantize_params_gives_the_reference_tree():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 3)
    want = jax.tree.map(np.asarray, jl.quantize_params(jparams))
    got = tl.quantize_params(tl.params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == 2 * 9 + 3  # 9 quantized weights, 3 norm stacks
    for path, leaf in flat:
        t = got
        for key in path:
            t = t[key.key]
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name, path
        if leaf.dtype == np.int8:
            np.testing.assert_array_equal(t.numpy(), leaf)
        else:
            np.testing.assert_allclose(t.numpy(), leaf, rtol=1e-6, atol=0)


def test_init_params_draws_int8_with_the_reference_scales(model):
    _, tcfg, _, _, np_params = model
    a = tl.init_params(tcfg, seed=5, device="cpu")
    b = tl.init_params(tcfg, seed=5, device="cpu")
    for name in ("embed", "lm_head"):
        assert torch.equal(a[name]["q"], b[name]["q"])
        assert a[name]["q"].dtype == torch.int8
        assert a[name]["q"].shape == np_params[name]["q"].shape
        np.testing.assert_array_equal(a[name]["s"].numpy(),
                                      np_params[name]["s"])
    wq = a["layers"]["wq"]
    assert wq["q"].shape == np_params["layers"]["wq"]["q"].shape
    assert int(wq["q"].min()) >= -127 and int(wq["q"].max()) <= 127
    np.testing.assert_array_equal(wq["s"].numpy(),
                                  np_params["layers"]["wq"]["s"])
    assert a["layers"]["ln1"].dtype == torch.float32


def test_params_from_jax_carries_the_quantized_tree(model):
    _, tcfg, _, tparams, np_params = model
    flat = jax.tree_util.tree_leaves_with_path(np_params)
    assert len(flat) == 2 * 9 + 3
    for path, leaf in flat:
        t = tparams
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.numpy(), leaf)
    lp = tl._layer(tparams, 2)
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        np.testing.assert_array_equal(
            lp[name]["q"].numpy(), np_params["layers"][name]["q"][2])
        np.testing.assert_array_equal(
            lp[name]["s"].numpy(), np_params["layers"][name]["s"][2])
    np.testing.assert_array_equal(lp["ln1"].numpy(),
                                  np_params["layers"]["ln1"][2])


# ---------------------------------------------------------------------------
# products


def _quant_weight(seed, K, N):
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, size=(K, N)).astype(np.int8)
    s = (rng.rand(N).astype(np.float32) + 0.5) * 1e-3
    return q, s


def _assert_product(got, want, dtype):
    got, want = _to_np(got), np.asarray(want, np.float32)
    if dtype == "bfloat16":
        # one bf16 step of the value (2**-7 relative), plus an absolute
        # 1e-6 of the scale for values that round near zero
        tol = BF16_STEP * np.abs(want) + 1e-6 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 8, 33, 64, 200])
def test_mm_matches_jax(dtype, M):
    """A layer product: the port's _mm (the wrapper's plain version on the
    CPU) against the reference's _mm, in x's dtype."""
    q, s = _quant_weight(M, 96, 64)
    x = np.random.RandomState(100 + M).randn(M, 96).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_np(x)
    want = jl._mm(jnp.asarray(x), {"q": jnp.asarray(q), "s": jnp.asarray(s)})
    got = tl._mm(_torch(x), {"q": torch.from_numpy(q),
                             "s": torch.from_numpy(s)})
    assert str(got.dtype).split(".")[-1] == dtype
    _assert_product(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True])
def test_logits_quant_branch_matches_jax(dtype, tied):
    """The quantized branch of _logits (an f32 product times s): untied
    with lm_head [H, V], tied with the embedding table [V, H] read as the
    weight ("nk" layout)."""
    jcfg = JConfig.tiny(quant="int8", dtype=dtype, tie_word_embeddings=tied)
    tcfg = TConfig.tiny(quant="int8", dtype=dtype, tie_word_embeddings=tied)
    np_params = jax.tree.map(np.asarray, jl.init_params(jcfg, 7))
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = tl.params_from_jax(np_params, "cpu")
    assert ("lm_head" in tparams) != tied
    h = np.random.RandomState(8).randn(5, jcfg.hidden_size).astype(np.float32)
    if dtype == "bfloat16":
        h = _bf16_np(h)
    want = np.asarray(jl._logits(jcfg, jparams, jnp.asarray(h)))
    got = tl._logits(tcfg, tparams, _torch(h))
    assert got.dtype == torch.float32 and got.shape == want.shape
    # bf16: the norm in front rounds h separately in the two frameworks
    # (one bf16 step), which the f32 product carries into the logits
    atol = (1e-5 if dtype == "float32" else 4 * BF16_STEP) * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_plain_version_is_the_reference_formula(layout):
    """w8a16_matmul_plain in both layouts and both output rules against
    the formulas it copies: jnp.matmul(x, q.astype(x.dtype)) *
    s.astype(x.dtype) and jnp.matmul(x, q, preferred_element_type=f32) *
    s."""
    q, s = _quant_weight(9, 64, 48)
    qk = q if layout == "kn" else np.ascontiguousarray(q.T)
    x = _bf16_np(np.random.RandomState(10).randn(6, 64))
    xj, qj = jnp.asarray(x), jnp.asarray(q)
    layer = jnp.matmul(xj, qj.astype(jnp.bfloat16)) * jnp.asarray(
        s).astype(jnp.bfloat16)
    logits = jnp.matmul(xj, qj.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32) * jnp.asarray(s)
    got_layer = w8a16.w8a16_matmul_plain(_torch(x), torch.from_numpy(qk),
                                         torch.from_numpy(s), torch.bfloat16,
                                         layout)
    got_logits = w8a16.w8a16_matmul(_torch(x), {"q": torch.from_numpy(qk),
                                                "s": torch.from_numpy(s)},
                                    torch.float32, layout)
    _assert_product(got_layer, layer, "bfloat16")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               rtol=0, atol=1e-5 * float(jnp.abs(logits).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_rows_quantized_matches_jax(model, dtype):
    _, _, jparams, tparams, _ = model
    toks = np.asarray([0, 5, 255, 5, 17], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jl._embed_rows(jparams, jnp.asarray(toks), jdt)
    got = tl._embed_rows(tparams, torch.from_numpy(toks),
                         tl.torch_dtype(dtype))
    np.testing.assert_array_equal(_to_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("M,N,K,want", [
    (8, 4096, 4096, (8, 8)),      # wq, wo at 8B decode: 32 tiles x 8
    (8, 1024, 4096, (8, 8)),      # wk, wv: 8 tiles x 8
    (8, 14336, 4096, (8, 3)),     # wg, wu: 112 tiles x 3
    (8, 128256, 4096, (8, 1)),    # lm_head
    (32, 4096, 14336, (32, 8)),   # wd
    (1024, 4096, 4096, (64, 1)),  # prefill rows
    (8, 64, 64, (8, 1)),          # tiny: one k tile, no split
])
def test_kernel_plan(M, N, K, want):
    bm, splits = w8a16.plan(M, N, K)
    assert (bm, splits) == want
    k_tiles = -(-K // 64)
    per = -(-k_tiles // splits)
    assert (splits - 1) * per < k_tiles  # no split is empty


_BF, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,N,K,layout,xdt,odt,want", [
    # the serve's prefill groups (8B layer products): the wgmma kernel
    (2048, 4096, 4096, "kn", _BF, _BF, "wgmma"),
    (1024, 14336, 4096, "kn", _BF, _BF, "wgmma"),
    (512, 4096, 14336, "kn", _BF, _BF, "wgmma"),
    (128, 1024, 4096, "kn", _BF, _BF, "wgmma"),
    # the threshold
    (64, 4096, 4096, "kn", _BF, _BF, "wgmma"),
    (33, 4096, 4096, "kn", _BF, _BF, "wgmma"),
    # decode steps
    (32, 4096, 4096, "kn", _BF, _BF, "mma"),
    (8, 14336, 4096, "kn", _BF, _BF, "mma"),
    (1, 1024, 4096, "kn", _BF, _BF, "mma"),
    # the f32 logits (a prefill's last rows, and any M), untied and tied
    (8, 128256, 4096, "kn", _BF, _F32, "mma"),
    (1024, 128256, 4096, "kn", _BF, _F32, "mma"),
    (1024, 128256, 2048, "nk", _BF, _F32, "mma"),
    # layout NK with a bf16 output, and f32 x (the tiny model)
    (1024, 4096, 4096, "nk", _BF, _BF, "mma"),
    (1024, 64, 64, "kn", _F32, _F32, "fma"),
    (4, 64, 64, "kn", _F32, _F32, "fma"),
])
def test_route(M, N, K, layout, xdt, odt, want):
    """Which kernel a CUDA call takes: the wgmma kernel for the layer
    products of prefill (bf16 x, "kn", bf16 out, M >= WGMMA_MIN_M), the
    unchanged mma kernel for every other bf16 product, the FMA kernel for
    f32 x; each with its own plan."""
    kind, plan = w8a16.route(M, N, K, layout, xdt, odt)
    assert kind == want
    if kind == "wgmma":
        assert plan == w8a16.wgmma_plan(M, N, K)
    elif kind == "mma":
        assert plan == w8a16.plan(M, N, K)
    assert w8a16.WGMMA_MIN_M == 33


@pytest.mark.parametrize("M,N,K,want", [
    # the fastest plans of tools/torch_w8a16_sweep.py on an H100 at M =
    # 1024 (the 8B layer shapes) and at the serve's smallest group
    (1024, 4096, 4096, (256, 1)),
    (1024, 1024, 4096, (128, 2)),    # 64 tiles, 64 clusters of 2 (66 fit)
    (1024, 14336, 4096, (256, 1)),   # 448 tiles, 4 waves
    (1024, 4096, 14336, (256, 1)),
    (128, 4096, 4096, (128, 3)),     # 32 tiles, 32 clusters of 3 (39 fit)
    (128, 1024, 4096, (128, 8)),
    (64, 4096, 64, (128, 1)),        # one k tile: nothing to split
])
def test_wgmma_plan(M, N, K, want):
    br, splits = w8a16.wgmma_plan(M, N, K)
    assert (br, splits) == want
    k_tiles = -(-K // 64)
    per = -(-k_tiles // splits)
    assert (splits - 1) * per < k_tiles  # no split is empty
    tiles = -(-M // br) * -(-N // 128)
    # one wave, unless the tiles alone fill the card more than once
    assert tiles <= w8a16.H100_CLUSTERS[splits] or splits == 1


def test_wgmma_plan_counts_the_cards_clusters():
    """A card that runs fewer clusters at once moves the plan off split
    K: wk/wv at M = 1024 with room for only 8 clusters of any size > 1
    takes whole-K blocks."""
    few = {sp: 132 if sp == 1 else 8 for sp in w8a16.WGMMA_SPLITS}
    assert w8a16.wgmma_plan(1024, 1024, 4096, few)[1] == 1
    # a cluster size the card cannot run is never planned
    no_pairs = {**w8a16.H100_CLUSTERS, 2: 0}
    assert w8a16.wgmma_plan(1024, 1024, 4096, no_pairs)[1] != 2
    assert w8a16.route(1024, 1024, 4096, "kn", _BF, _BF, few) == (
        "wgmma", w8a16.wgmma_plan(1024, 1024, 4096, few))


@pytest.mark.parametrize("br", [128, 256])
def test_wgmma_smem_fits_a_block(br):
    """The wgmma kernel's shared memory: at most 227 KB a block, at least
    4 stages, and the f32 output tile fits in the pipeline's bytes it
    reuses."""
    nbytes, stages = w8a16.wgmma_smem_bytes(br)
    assert nbytes <= 232448
    assert 4 <= stages <= 8
    stage = br * 64 * 2 + 64 * 128
    assert br * (128 + 4) * 4 <= 1024 + stages * stage <= nbytes


# ---------------------------------------------------------------------------
# the f32 logits product of a bf16 model


@pytest.mark.parametrize("tied", [False, True])
def test_bf16_logits_product_is_accumulated_in_f32(monkeypatch, tied):
    """_logits of a dense bf16 model against the reference's
    jnp.matmul(h, w, preferred_element_type=f32) on the same bf16 h and
    w, with the final norm taken out on both sides (it rounds separately
    in the two frameworks). A product rounded to bf16 before widening is
    off by up to 2**-9 of a logit, 100x the tolerance."""
    cfg = TConfig.tiny(dtype="bfloat16", tie_word_embeddings=tied)
    rng = np.random.RandomState(11)
    h = _bf16_np(rng.randn(4, cfg.hidden_size))
    embed = _bf16_np(rng.randn(cfg.vocab_size, cfg.hidden_size) * 0.5)
    head = _bf16_np(rng.randn(cfg.hidden_size, cfg.vocab_size) * 0.5)
    w = embed.T if tied else head
    want = np.asarray(jnp.matmul(jnp.asarray(h), jnp.asarray(w),
                                 preferred_element_type=jnp.float32))
    params = {"embed": _torch(embed), "norm_f": torch.ones(
        cfg.hidden_size, dtype=torch.bfloat16)}
    if not tied:
        params["lm_head"] = _torch(head)
    monkeypatch.setattr(tl, "rms_norm", lambda x, w, eps: x)
    got = tl._logits(cfg, params, _torch(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the slice: model programs and the engine on tiny w8a16 (f32)


def _region(cfg, lanes, length, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.num_layers, cfg.num_kv_heads, lanes, length, cfg.head_dim)
    return {n: (rng.randn(*shape) * 0.5).astype(np.float32) for n in "kv"}


def _both(state):
    return ({n: jnp.asarray(a) for n, a in state.items()},
            {n: torch.from_numpy(a.copy()) for n, a in state.items()})


def test_prefill_then_decode_logits_match_jax(model):
    """Prefill of one request into slot 0, then three decode steps of all
    B slots (the others over a random region), each step feeding both
    packages the reference's greedy tokens."""
    jcfg, tcfg, jparams, tparams, _ = model
    jctx, tctx = _both(_region(jcfg, B + 1, S, seed=20))
    jring, tring = _both(_region(jcfg, B, R, seed=21))
    prompt = np.random.RandomState(22).randint(
        0, jcfg.vocab_size, size=32).astype(np.int32)
    seq_len = 20
    jctx, jlogits = jl.prefill_impl(
        jcfg, jparams, jctx, jnp.asarray(prompt), jnp.int32(0), jnp.int32(0),
        jnp.int32(seq_len))
    tlogits = tl.prefill(tcfg, tparams, tctx, torch.from_numpy(prompt), 0,
                         0, seq_len)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    toks = np.asarray([int(np.argmax(jlogits)), 7, 9], np.int32)
    ring_base = np.asarray([seq_len, 30, 41], np.int32)
    for step in range(3):
        ctx_lens = ring_base + step + 1
        jring, jlogits = jl.decode_step_impl(
            jcfg, jparams, jctx, jring, jnp.asarray(toks),
            jnp.asarray(ctx_lens), jnp.asarray(ring_base), jnp.int32(step))
        tlogits = tl.decode_step(
            tcfg, tparams, tctx, tring, torch.from_numpy(toks.copy()),
            torch.from_numpy(ctx_lens), torch.from_numpy(ring_base), step)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        toks = np.asarray(jnp.argmax(jlogits, axis=-1), np.int32)


ENGINE_KW = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                 max_decode_slots=4, prefill_buckets=(32, 64),
                 cache_dtype="float32")
_rng = np.random.RandomState(0)
PROMPTS = [list(range(1 + i, 30 + 3 * i)) for i in range(4)] + [
    [int(t) for t in _rng.randint(1, 256, size=100)]]
N_NEW = 12


async def _collect(engine, proto, prompt, n_new):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True),
        output_options=proto.OutputOptions(logprobs=2),
    )
    return [out async for out in engine.generate(req)]


async def _drive(engine, proto):
    outs = await asyncio.gather(
        *[_collect(engine, proto, p, N_NEW) for p in PROMPTS])
    outs.append(await _collect(engine, proto, PROMPTS[0], N_NEW))
    await engine.stop()
    return outs


@pytest.fixture(scope="module", params=["none", "int8"])
def engine_runs(request, model):
    """TpuEngine and TorchEngine on tiny w8a16 (f32) with the same int8
    weights, with dense or int8 KV, rounds pipelined (the default)."""
    jcfg, tcfg, jparams, tparams, _ = model
    kw = dict(ENGINE_KW, kv_quant=request.param)
    jeng = TpuEngine(jcfg, JEngineConfig(**kw), params=jparams,
                     mesh_config=MeshConfig(tp=1))
    teng = TorchEngine(tcfg, TEngineConfig(**kw), params=tparams,
                       device="cpu")
    assert teng.ecfg.round_pipeline
    return (asyncio.run(_drive(jeng, jproto)),
            asyncio.run(_drive(teng, tproto)), teng)


def test_engine_greedy_identical_to_tpu_engine(engine_runs):
    jouts, touts, teng = engine_runs
    for j, t in zip(jouts, touts):
        assert [x for o in t for x in o.token_ids] == \
            [x for o in j for x in o.token_ids]
        assert t[-1].finish_reason.value == "length"
    assert touts[-1][-1].annotations["cached_blocks"] == 1
    assert teng.pipeline_stats()["pipelined_dispatches"] > 0


def test_engine_logprobs_match_tpu_engine(engine_runs):
    jouts, touts, teng = engine_runs
    tol = 5e-4 if teng.kv_quant else 1e-4  # see the module docstring
    for j, t in zip(jouts, touts):
        got = [x for o in t for x in (o.log_probs or [])]
        want = [x for o in j for x in (o.log_probs or [])]
        assert len(got) == len(want) == N_NEW
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the entry point


def test_launcher_serves_quantized_weights():
    args = prun.build_parser().parse_intermixed_args(
        ["in=text", "out=torch", "--model-config", "tiny", "--quantize",
         "int8", "--cache-dtype", "float32", "--device", "cpu"])
    prun.refuse_unported(args)  # --quantize is served now
    _, chain = prun.build_chain(args)
    eng = chain.engine
    assert eng.config.quant == "int8"
    assert eng.params["layers"]["wq"]["q"].dtype == torch.int8
    assert "llama3_8b_int8" in prun._SERVED_CONFIGS
    assert TConfig.llama3_8b_int8(dtype="float32").quant == "int8"
    assert TConfig.llama3_1b_int8().tie_word_embeddings


def test_launcher_cli_serves_a_quantized_prompt():
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=text",
         "out=torch", "--model-config", "tiny", "--quantize", "int8",
         "--cache-dtype", "float32", "--device", "cpu", "--prompt",
         "w1 w2 w3", "--max-tokens", "6"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == 1


def test_w8a16_module_imports_no_jax():
    code = ("import sys, dynamo_tpu_torch.ops.w8a16, "
            "dynamo_tpu_torch.models.llama\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'dynamo_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
