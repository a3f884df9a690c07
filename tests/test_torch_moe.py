"""The port's Mixture-of-Experts layer and FFN (dynamo_tpu_torch/models/
moe.py, models/llama.py ``_moe_ffn``) against the JAX package's, on the
CPU in f32 with the same weights and numpy-seeded inputs: moe_reference
and moe_layer (one device), capacity drops, both product paths of the
FFN (dense dispatch and grouped) with masked rows, per-row capacity in
the batch paths, prefill and a decode step with dead lanes, and the
w8a16 expert stacks.

Ties in top-k: ``jax.lax.top_k`` breaks them toward the lower index and
``torch.topk`` promises no order. These seeds give no tied gate among a
live row's picks under random weights (checked by ``_no_ties``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import moe as jmoe
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import moe as tmoe
from dynamo_tpu_torch.models.config import ModelConfig as TConfig

B, S, R = 3, 128, 4
# the reference's own tolerance (tests/test_moe.py)
TOL = dict(rtol=2e-5, atol=2e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _moe(cf, k=2, e=8):
    return (("capacity_factor", cf), ("num_experts", e), ("top_k", k))


def _configs(cf=0.0, quant=None):
    kw = dict(dtype="float32", moe=_moe(cf), quant=quant)
    return JConfig.tiny_moe(**kw), TConfig.tiny_moe(**kw)


def _no_ties(x, wr, k):
    """No two of a row's k+1 largest gates are equal (the order top-k
    gives them would then be the package's own)."""
    g = np.sort(np.asarray(x, np.float64) @ np.asarray(wr, np.float64),
                axis=-1)[:, ::-1][:, :k + 1]
    return bool((np.diff(g, axis=-1) < 0).all())


@pytest.fixture(scope="module", params=[None, "int8"], ids=["dense", "w8a16"])
def moe_model(request):
    """tiny_moe (dropless, f32) weights from the JAX init, carried to the
    port with params_from_jax."""
    jcfg, tcfg = _configs(quant=request.param)
    jparams = jl.init_params(jcfg, 0)
    return jcfg, tcfg, jparams, tl.params_from_jax(_np_tree(jparams), "cpu")


# ---------------------------------------------------------------------------
# models/moe.py


def _moe_weights(cfg, seed):
    jp = jmoe.init_moe_params(cfg, seed)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _one_device(h, params):
    mesh = Mesh(np.array(jax.devices()[:1]), ("ep",))
    sh = jmoe.moe_params_shardings(mesh)
    return (jax.device_put(h, NamedSharding(mesh, P("ep", None))),
            {k: jax.device_put(v, sh[k]) for k, v in params.items()}, mesh)


def _jcfg_pair(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


@pytest.mark.parametrize("T,top_k,cf", [(32, 2, 8.0), (24, 1, 4.0),
                                        (16, 3, 0.0)])
def test_moe_reference_and_layer_match_jax(T, top_k, cf):
    """Ample capacity (or dropless): the port's reference and its
    one-device moe_layer equal the JAX package's."""
    jcfg, tcfg = _jcfg_pair(hidden_size=16, intermediate_size=32,
                            num_experts=8, top_k=top_k, capacity_factor=cf)
    jp, tp = _moe_weights(jcfg, 0)
    h = np.random.default_rng(1).standard_normal((T, 16)).astype(np.float32)
    assert _no_ties(h, jp["wr"], top_k)
    want_ref = np.asarray(jmoe.moe_reference(jnp.asarray(h), jp, jcfg))
    hs, ps, mesh = _one_device(jnp.asarray(h), jp)
    want_layer = np.asarray(jmoe.moe_layer(hs, ps, jcfg, mesh))
    th = torch.from_numpy(h)
    np.testing.assert_allclose(tmoe.moe_reference(th, tp, tcfg).numpy(),
                               want_ref, **TOL)
    np.testing.assert_allclose(tmoe.moe_layer(th, tp, tcfg).numpy(),
                               want_layer, **TOL)
    np.testing.assert_allclose(tmoe.moe_layer(th, tp, tcfg).numpy(),
                               want_ref, **TOL)


def test_moe_capacity_overflow_drops_the_same_rows():
    """top_k 1 at capacity_factor 0.25: the JAX package's dropped tokens
    are the port's (zero rows), the kept ones equal."""
    jcfg, tcfg = _jcfg_pair(hidden_size=8, intermediate_size=16,
                            num_experts=4, top_k=1, capacity_factor=0.25)
    jp, tp = _moe_weights(jcfg, 0)
    h = np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32)
    hs, ps, mesh = _one_device(jnp.asarray(h), jp)
    want = np.asarray(jmoe.moe_layer(hs, ps, jcfg, mesh))
    got = tmoe.moe_layer(torch.from_numpy(h), tp, tcfg).numpy()
    assert np.isfinite(got).all()
    dropped = np.abs(want).sum(-1) == 0
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0, dropped)
    np.testing.assert_allclose(got, want, **TOL)


def test_moe_layer_validates_divisibility_and_refuses_ep():
    tcfg = tmoe.MoEConfig(hidden_size=8, intermediate_size=16, num_experts=6)
    tp = tmoe.init_moe_params(tcfg, 0)
    h = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="experts 6 not divisible"):
        tmoe.moe_layer(h, tp, tcfg, ep=4)
    with pytest.raises(ValueError, match="tokens 16 not divisible"):
        tmoe.moe_layer(h, tp, tcfg, ep=3)
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        tmoe.moe_layer(h, tp, tcfg, ep=2)


@pytest.mark.parametrize("T,cf", [(7, 0.0), (16, 1.25), (100, 0.25),
                                  (1, 0.5)])
def test_capacity_is_the_reference_formula(T, cf):
    kw = dict(hidden_size=8, intermediate_size=16, num_experts=8, top_k=2,
              capacity_factor=cf)
    assert tmoe.MoEConfig(**kw).capacity(T) == jmoe.MoEConfig(**kw).capacity(T)


def test_init_moe_params_is_seeded_and_scaled():
    cfg = tmoe.MoEConfig(hidden_size=64, intermediate_size=128,
                         num_experts=4)
    a, b = tmoe.init_moe_params(cfg, 3), tmoe.init_moe_params(cfg, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["wd"].shape == (4, 128, 64)
    assert a["wg"].std().item() == pytest.approx(1 / 8, rel=0.1)


# ---------------------------------------------------------------------------
# llama._moe_ffn: both product paths against the JAX package's


@pytest.mark.parametrize("cf", [0.0, 1.25, 0.25])
@pytest.mark.parametrize("grouped", [False, True], ids=["dispatch", "grouped"])
def test_moe_ffn_matches_jax(moe_model, cf, grouped):
    """Layer 0 of tiny_moe with rows masked out of routing: the port's
    FFN on each product path equals the reference's, drops included."""
    jcfg, tcfg = _configs(cf, moe_model[0].quant)
    jparams, tparams = moe_model[2], moe_model[3]
    lpj = jax.tree.map(lambda x: x[0], jparams["layers"])
    lpt = tl._layer(tparams, 0)
    T = 48
    x = np.random.RandomState(1).randn(T, 64).astype(np.float32)
    valid = np.ones(T, bool)
    valid[[3, 7, 40, 41, 42, 47]] = False
    assert _no_ties(x, lpj["wr"], 2)
    want = np.asarray(jl._moe_ffn(jcfg, lpj, jnp.asarray(x),
                                  jnp.asarray(valid)))
    got = tl._moe_ffn(tcfg, lpt, torch.from_numpy(x),
                      torch.from_numpy(valid), 1, grouped).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    zero = np.abs(want).sum(-1) == 0
    assert zero[~valid].all()
    if cf == 0.25:
        assert zero[valid].any()   # capacity drops of live rows
    else:
        assert not zero[valid].any()


@pytest.mark.parametrize("cf", [0.0, 0.25])
def test_moe_ffn_groups_route_alone(moe_model, cf):
    """groups=G routes each group of T rows as the reference routes one
    call of T rows (its vmap over a batch's rows), on both paths."""
    jcfg, tcfg = _configs(cf, moe_model[0].quant)
    lpj = jax.tree.map(lambda x: x[0], moe_model[2]["layers"])
    lpt = tl._layer(moe_model[3], 0)
    G, T = 3, 20
    x = np.random.RandomState(2).randn(G * T, 64).astype(np.float32)
    valid = np.arange(G * T) % T < np.repeat([20, 9, 0], T)
    want = np.concatenate([np.asarray(jl._moe_ffn(
        jcfg, lpj, jnp.asarray(x[g * T:(g + 1) * T]),
        jnp.asarray(valid[g * T:(g + 1) * T]))) for g in range(G)])
    for grouped in (False, True):
        got = tl._moe_ffn(tcfg, lpt, torch.from_numpy(x),
                          torch.from_numpy(valid), G, grouped).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_moe_ffn_paths_agree_with_each_other(moe_model):
    """The dense dispatch and the grouped products give the same values
    (the dispatch buffer's spare slot and the grouped row order move no
    value)."""
    tcfg = _configs(0.25, moe_model[0].quant)[1]
    lpt = tl._layer(moe_model[3], 1)
    x = torch.from_numpy(np.random.RandomState(3).randn(64, 64).astype(
        np.float32))
    valid = torch.arange(64) % 5 != 0
    a = tl._moe_ffn(tcfg, lpt, x, valid, 2, grouped=False)
    b = tl._moe_ffn(tcfg, lpt, x, valid, 2, grouped=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_moe_ffn_matches_moe_reference():
    """Dropless, unmasked, dense experts: the FFN is moe.moe_reference on
    the layer's router and experts (tests/test_moe_serving.py's check)."""
    tcfg = _configs()[1]
    lpt = tl._layer(tl.init_params(tcfg, 5, device="cpu"), 0)
    x = torch.from_numpy(np.random.RandomState(0).randn(12, 64).astype(
        np.float32))
    ref = tmoe.moe_reference(
        x, {"wr": lpt["wr"], "wg": lpt["we_g"], "wu": lpt["we_u"],
            "wd": lpt["we_d"]},
        tmoe.MoEConfig(hidden_size=64, intermediate_size=128,
                       num_experts=8, top_k=2))
    for grouped in (False, True):
        got = tl._moe_ffn(tcfg, lpt, x, None, 1, grouped)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# the model programs on tiny_moe


def _region(cfg, lanes, length, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.num_layers, cfg.num_kv_heads, lanes, length, cfg.head_dim)
    return {n: (rng.randn(*shape) * 0.5).astype(np.float32) for n in "kv"}


def _both(state):
    return ({n: jnp.asarray(a) for n, a in state.items()},
            {n: torch.from_numpy(a.copy()) for n, a in state.items()})


@pytest.mark.parametrize("fn", ["batch_prefill", "batch_score"])
def test_batch_paths_route_each_row_alone(moe_model, fn):
    """capacity_factor 0.25 (drops), two live rows of different lengths
    (one continuing over prior context) and a scratch-lane dummy: the
    logits equal the reference's, whose vmap routes each row alone with
    C = capacity(T)."""
    jcfg, tcfg = _configs(0.25, moe_model[0].quant)
    jparams, tparams = moe_model[2], moe_model[3]
    jctx, tctx = _both(_region(jcfg, B + 1, S, seed=1))
    T = 32
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, size=(3, T)).astype(np.int32)
    slots, q_starts = [0, 2, B], [0, 16, 0]
    seq_lens = [20, 48, 0] if fn == "batch_prefill" else [32, 48, 0]
    jargs = (jnp.asarray(toks), jnp.asarray(slots), jnp.asarray(q_starts),
             jnp.asarray(seq_lens), 16)
    targs = (torch.from_numpy(toks), slots, q_starts, seq_lens, 16)
    if fn == "batch_prefill":
        jctx, want = jl.batch_prefill_impl(jcfg, jparams, jctx, *jargs)
        got = tl.batch_prefill(tcfg, tparams, tctx, *targs)
    else:
        jctx, want = jl.batch_score_impl(jcfg, jparams, jctx, *jargs)
        got = tl.batch_score(tcfg, tparams, tctx, *targs)
        want, got = np.asarray(want)[:2], got[:2]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for n in "kv":
        np.testing.assert_allclose(
            tctx[n][:, :, :B].numpy(), np.asarray(jctx[n])[:, :, :B],
            rtol=1e-4, atol=1e-4)


def test_prefill_then_decode_with_dead_lanes_match_jax(moe_model):
    """Prefill into slot 0 over a bucket with padding, then decode steps
    with lane 1 dead (live False): the logits of the live lanes equal
    the reference's, and do not change when the dead lane's token does
    (dropless masked lanes keep decode independent of occupancy)."""
    jcfg, tcfg, jparams, tparams = moe_model
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
    live = np.asarray([True, False, True])
    for step in range(3):
        ctx_lens = ring_base + step + 1
        jring, jlogits = jl.decode_step_impl(
            jcfg, jparams, jctx, jring, jnp.asarray(toks),
            jnp.asarray(ctx_lens), jnp.asarray(ring_base), jnp.int32(step),
            jnp.asarray(live))
        args = (tcfg, tparams, tctx, tring)
        rest = (torch.from_numpy(ctx_lens), torch.from_numpy(ring_base),
                step, torch.from_numpy(live))
        other = toks.copy()
        other[1] = (other[1] + 11) % jcfg.vocab_size
        ring_copy = {n: t.clone() for n, t in tring.items()}
        alt = tl.decode_step(tcfg, tparams, tctx, ring_copy,
                             torch.from_numpy(other), *rest)
        tlogits = tl.decode_step(*args, torch.from_numpy(toks.copy()), *rest)
        np.testing.assert_allclose(tlogits.numpy()[live],
                                   np.asarray(jlogits)[live], rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(alt[live], tlogits[live])
        toks = np.asarray(jnp.argmax(jlogits, axis=-1), np.int32)


# ---------------------------------------------------------------------------
# parameters


def test_quantize_params_gives_the_reference_tree():
    """tiny_moe's dense weights quantized by both packages: the router
    stays dense, each expert stack is an {"q" [L, E, in, out], "s" [L, E,
    out]} pair equal to the reference's."""
    jcfg, _ = _configs()
    jparams = jl.init_params(jcfg, 0)
    want = _np_tree(jl.quantize_params(jparams))
    got = tl.quantize_params(tl.params_from_jax(_np_tree(jparams), "cpu"))
    gl, wl = got["layers"], want["layers"]
    assert isinstance(gl["wr"], torch.Tensor) and not isinstance(
        wl["wr"], dict)
    np.testing.assert_array_equal(gl["wr"].numpy(), wl["wr"])
    for name in ("we_g", "we_u", "we_d", "wq", "wo"):
        np.testing.assert_array_equal(gl[name]["q"].numpy(), wl[name]["q"])
        np.testing.assert_allclose(gl[name]["s"].numpy(), wl[name]["s"],
                                   rtol=1e-7, atol=0)
    L, E, H, I = 4, 8, 64, 128
    assert gl["we_g"]["q"].shape == (L, E, H, I)
    assert gl["we_g"]["s"].shape == (L, E, I)
    assert gl["we_d"]["s"].shape == (L, E, H)
    assert "wg" not in gl


@pytest.mark.parametrize("quant", [None, "int8"], ids=["dense", "w8a16"])
def test_init_params_draws_the_reference_leaves(quant):
    """The port's own draw has the reference's leaves, shapes, dtypes and
    scales; params_from_jax carries the reference's tree leaf for leaf."""
    jcfg, tcfg = _configs(quant=quant)
    want = _np_tree(jl.init_params(jcfg, 0))
    got = tl.init_params(tcfg, 3, device="cpu")
    carried = tl.params_from_jax(want, "cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        else:
            yield prefix, tree

    w, g, c = (dict(leaves(t)) for t in (want, got, carried))
    assert w.keys() == g.keys() == c.keys()
    for k in w:
        assert tuple(g[k].shape) == w[k].shape, k
        assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), k
        np.testing.assert_array_equal(c[k].numpy(), w[k])
    assert isinstance(got["layers"]["wr"], torch.Tensor)
    if quant is None:
        assert got["layers"]["we_g"].std().item() == pytest.approx(
            float(w["/layers/we_g"].std()), rel=0.1)


def test_checkpoints_refuse_a_moe_config(tmp_path):
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="MoE"):
        tl.params_from_state_dict(tcfg, {}, device="cpu")
    from dynamo_tpu_torch import gguf

    with pytest.raises(ValueError, match="MoE"):
        gguf.load_gguf_params(tcfg, str(tmp_path / "none.gguf"),
                              device="cpu")
