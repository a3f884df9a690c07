"""Linear speculative decoding of the PyTorch port (dynamo_tpu_torch/spec/)
against the JAX package's, piece by piece, on the CPU: the n-gram
proposer, the PRNG pieces acceptance draws from, greedy and
rejection-sampling acceptance with and without penalties, the verify's
scorer and the batched draft (dense and int8 regions), the adaptive-K
controller, and the launcher's flags. The engine differentials are in
tests/test_torch_spec_engine.py.

Tolerances: proposals, acceptance results (tokens, counts, advanced
keys), the split keys and uniforms are exactly equal. Logits agree to
1e-5 (f32 matmuls summed in another order; 1e-4 through an int8
region); drafted tokens are equal; written regions as
tests/test_torch_llama.py holds them, but int8 scales (absmaxes of
computed KV over up to five verify rows) to 5e-6 relative; a span bounded
to the 256-key block gives the full span's logits bit for bit."""
import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.launch import run as rrun
from dynamo_tpu.models import llama as jl
from dynamo_tpu.spec import decoder as jdec
from dynamo_tpu.spec import proposer as jprop
from dynamo_tpu.spec import verifier as jver
from dynamo_tpu_torch.engine import sampling as ts
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.launch import run as prun
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.spec import decoder as tdec
from dynamo_tpu_torch.spec import proposer as tprop
from dynamo_tpu_torch.spec import verifier as tver
from tests.test_torch_llama import (
    _both,
    _int8_region,
    _region,
    model,  # noqa: F401 — the module-scoped weights fixture
)
from tests.test_torch_spec_engine import collect, request

B, S = 3, 64


def _assert_region(tctx, jctx, lanes):
    for n, a in jctx.items():
        a, b = np.asarray(a), tctx[n].numpy()
        if n.endswith("_scale"):            # [L, lanes, groups]
            np.testing.assert_allclose(b[:, lanes], a[:, lanes], rtol=5e-6,
                                       atol=0)
        elif a.dtype == np.int8:            # [L, kvh, lanes, S, hd]
            diff = np.abs(b[:, :, lanes].astype(np.int32)
                          - a[:, :, lanes].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, n
        else:
            np.testing.assert_allclose(b[:, :, lanes], a[:, :, lanes],
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# NGramProposer (tests/test_spec.py's four cases)

@pytest.mark.parametrize("k,max_n,min_n,history,want", [
    (3, 3, 1, [5, 6, 7, 8, 9, 1, 6, 7], [8, 9, 1]),   # tail match
    (2, 2, 1, [1, 2, 3, 1, 2, 4, 1, 2], [4, 1]),      # most recent wins
    (4, 3, 2, [1, 2, 3, 4], [0, 0, 0, 0]),            # no match: zeros
    (4, 1, 1, [1, 2, 3, 2], [3, 2, 0, 0]),            # short, padded
])
def test_ngram_proposes_as_the_reference(k, max_n, min_n, history, want):
    got = tprop.NGramProposer(k, max_n, min_n).propose(history)
    ref = jprop.NGramProposer(k, max_n, min_n).propose(history)
    assert got == ref == want


# ---------------------------------------------------------------------------
# the PRNG pieces acceptance draws from

KEYS = np.asarray([[0, 0], [7, 11], [3, 9], [0xFFFFFFFF, 12345],
                   [0x46697273, 0xDEADBEEF]], np.uint32)


def _jkey(k):
    return jax.random.wrap_key_data(jnp.asarray(k), impl="threefry2x32")


@pytest.mark.parametrize("n", [1, 2, 5, 9])
def test_n_way_split_is_bit_equal_to_jax(n):
    want = np.stack([np.asarray(jax.random.key_data(
        jax.random.split(_jkey(k), n))) for k in KEYS])
    got = ts.split_keys_n(torch.from_numpy(KEYS.astype(np.int64)), n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_uniform_is_bit_equal_to_jax():
    keys = np.random.RandomState(0).randint(
        0, 2**32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
    keys = np.concatenate([KEYS, keys])
    want = np.asarray([np.asarray(jax.random.uniform(_jkey(k)))
                       for k in keys], np.float32)
    got = ts.uniform(torch.from_numpy(keys.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# acceptance: exactly JAX's out, n_out and new keys

V, KT = 48, 16


def _accept_case(seed, K, temp, top_k, top_p, rows=6):
    """Logits [rows, K+1, V] and proposals that follow the argmax for a
    random prefix, then leave it (so acceptance lengths vary)."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(rows, K + 1, V) * 2.0).astype(np.float32)
    toks = np.zeros((rows, K + 1), np.int32)
    toks[:, 0] = rng.randint(0, V, rows)
    greedy = logits.argmax(-1)
    for r in range(rows):
        keep = rng.randint(0, K + 1)
        for i in range(K):
            toks[r, i + 1] = (greedy[r, i] if i < keep
                              else rng.randint(0, V))
    keys = rng.randint(0, 2**32, size=(rows, 2),
                       dtype=np.uint64).astype(np.uint32)
    knobs = (np.full(rows, temp, np.float32), np.full(rows, top_k, np.int32),
             np.full(rows, top_p, np.float32))
    return logits, toks, keys, knobs


ACCEPT_CASES = [
    pytest.param(0.0, 0, 1.0, id="greedy"),
    pytest.param(0.9, 0, 1.0, id="temperature"),
    pytest.param(0.7, 5, 1.0, id="top_k"),
    pytest.param(1.2, 0, 0.6, id="top_p"),
    pytest.param(0.8, 8, 0.9, id="top_k_top_p"),
]


def _jax_accept(fn, arrays, **kw):
    out = jax.vmap(functools.partial(fn, max_top_k=KT, **kw))(
        *[jnp.asarray(a) for a in arrays])
    return [np.asarray(o) for o in out]


def _check_equal(got, want):
    out, n_out, keys = (t.numpy() for t in got)
    np.testing.assert_array_equal(out, want[0])
    np.testing.assert_array_equal(n_out, want[1])
    np.testing.assert_array_equal(keys, want[2].astype(np.int64))


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("temp,top_k,top_p", ACCEPT_CASES)
def test_accept_tokens_is_exactly_jax(K, temp, top_k, top_p):
    logits, toks, keys, knobs = _accept_case(K * 10 + int(temp * 10), K,
                                             temp, top_k, top_p)
    want = _jax_accept(jver.accept_tokens, (logits, toks, keys, *knobs))
    got = tver.accept_tokens(
        torch.from_numpy(logits), torch.from_numpy(toks),
        torch.from_numpy(keys.astype(np.int64)),
        *[torch.from_numpy(a) for a in knobs], KT)
    _check_equal(got, want)
    if temp <= 0.0:
        # greedy: the accepted prefix follows the argmax, then the bonus
        # is the first mismatching row's argmax
        greedy = logits.argmax(-1)
        for r in range(len(toks)):
            n = int(want[1][r])
            assert list(want[0][r, :n]) == list(greedy[r, :n])


@pytest.mark.parametrize("temp,top_k,top_p", ACCEPT_CASES)
@pytest.mark.parametrize("penalty", ["identity", "penalized"])
def test_accept_tokens_penalized_is_exactly_jax(temp, top_k, top_p, penalty):
    K = 4
    logits, toks, keys, knobs = _accept_case(7 + int(temp * 10), K, temp,
                                             top_k, top_p)
    rows = len(toks)
    rng = np.random.RandomState(3)
    if penalty == "identity":
        counts = np.zeros((rows, V), np.int32)
        pens = (np.zeros(rows, np.float32), np.zeros(rows, np.float32),
                np.ones(rows, np.float32))
    else:
        counts = rng.randint(0, 3, size=(rows, V)).astype(np.int32)
        # the proposals themselves carry counts, so the advance shows
        counts[np.arange(rows), toks[:, 1]] += 1
        pens = (np.full(rows, 0.4, np.float32), np.full(rows, 0.2, np.float32),
                np.full(rows, 1.3, np.float32))
    arrays = (logits, toks, keys, *knobs, counts, *pens)
    want = _jax_accept(jver.accept_tokens_penalized, arrays)
    before = torch.from_numpy(counts.copy())
    got = tver.accept_tokens_penalized(
        *[torch.from_numpy(a.astype(np.int64) if a is keys else a)
          for a in arrays], max_top_k=KT)
    _check_equal(got, want)
    assert torch.equal(before, torch.from_numpy(counts))
    if penalty == "identity":
        # zero counts and identity penalties draw as the plain path does
        plain = _jax_accept(jver.accept_tokens, (logits, toks, keys, *knobs))
        for a, b in zip(want, plain):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the verify's scorer and the batched draft

def _prefilled(jcfg, tcfg, jparams, tparams, quant, lanes, length, slots,
               lens, seed):
    """Both regions with prompts of ``lens`` prefilled into ``slots``."""
    state = (_int8_region(jcfg, lanes + 1, length, seed) if quant
             else _region(jcfg, lanes + 1, length, seed))
    jctx, tctx = _both(state)
    rng = np.random.RandomState(seed + 1)
    for slot, n in zip(slots, lens):
        toks = rng.randint(0, jcfg.vocab_size, size=32).astype(np.int32)
        jctx, _ = jl.prefill_impl(jcfg, jparams, jctx, jnp.asarray(toks),
                                  jnp.int32(slot), jnp.int32(0), jnp.int32(n))
        tl.prefill(tcfg, tparams, tctx, torch.from_numpy(toks), slot, 0, n)
    return jctx, tctx


@pytest.mark.parametrize("quant", [False, True])
def test_batch_score_matches_jax(model, quant):  # noqa: F811
    """Two speculating rows (pending + 4 proposals) over prefilled
    context: logits for every row and the optimistic KV write agree."""
    jcfg, tcfg, jparams, tparams, _ = model
    jctx, tctx = _prefilled(jcfg, tcfg, jparams, tparams, quant, B, S,
                            [0, 2], [20, 29], seed=20)
    toks = np.random.RandomState(21).randint(
        0, jcfg.vocab_size, size=(2, 5)).astype(np.int32)
    slots, q_starts = [0, 2], [19, 28]
    seq_lens = [q + 5 for q in q_starts]
    jctx, jlogits = jl.batch_score_impl(
        jcfg, jparams, jctx, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(q_starts), jnp.asarray(seq_lens), S)
    tlogits = tl.batch_score(tcfg, tparams, tctx, torch.from_numpy(toks),
                             slots, q_starts, seq_lens, S)
    assert tlogits.shape == (2, 5, jcfg.vocab_size)
    tol = 1e-4 if quant else 1e-5
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=tol, atol=tol)
    _assert_region(tctx, jctx, lanes=slice(0, B))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_batch_draft_matches_jax(model, quant, k):  # noqa: F811
    """The catch-up chunks and k-1 argmax steps: the drafted tokens and
    the draft region agree with batch_draft_impl (m = 1)."""
    jcfg, tcfg, jparams, tparams, _ = model
    jctx, tctx = _prefilled(jcfg, tcfg, jparams, tparams, quant, B, S,
                            [1, 2], [12, 17], seed=30)
    rng = np.random.RandomState(31)
    T = 8
    toks = rng.randint(0, jcfg.vocab_size, size=(2, T)).astype(np.int32)
    slots, q_starts, seq_lens = [1, 2], [12, 17], [12 + 6, 17 + 8]
    jctx, jdrafted = jl.batch_draft_impl(
        jcfg, jparams, jctx, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(q_starts), jnp.asarray(seq_lens), S, k)
    tdrafted = tl.batch_draft(tcfg, tparams, tctx, torch.from_numpy(toks),
                              slots, q_starts, seq_lens, S, k)
    np.testing.assert_array_equal(tdrafted.numpy(), np.asarray(jdrafted))
    _assert_region(tctx, jctx, lanes=slice(0, B))


@pytest.mark.parametrize("quant", [False, True])
def test_bounded_span_equals_the_full_span(model, quant):  # noqa: F811
    """A verify over a 512-position region whose rows sit below 256:
    reading the first 256-key block only (spec_span) gives the full
    region's logits and KV bit for bit."""
    _, tcfg, _, tparams, _ = model
    jcfg = tcfg
    length = 512
    state = (_int8_region(jcfg, B + 1, length, 40) if quant
             else _region(jcfg, B + 1, length, 40))
    toks = torch.from_numpy(np.random.RandomState(41).randint(
        0, jcfg.vocab_size, size=(2, 5)).astype(np.int32))
    slots, q_starts = [0, 1], [100, 250]
    seq_lens = [q + 5 for q in q_starts]
    span = tl.spec_span(max(q_starts), length)
    assert span == 256
    out = []
    for s in (length, span):
        ctx = {n: torch.from_numpy(a.copy()) for n, a in state.items()}
        out.append((tl.batch_score(tcfg, tparams, ctx, toks, slots,
                                   q_starts, seq_lens, s), ctx))
    assert torch.equal(out[0][0], out[1][0])
    for n in state:
        assert torch.equal(out[0][1][n], out[1][1][n])
    assert tl.spec_span(300, length) == 512
    assert tl.spec_span(300, 320) == 320


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_spec_verify_matches_jax(model, temp):  # noqa: F811
    """The whole verify program (draft spliced on the device, score,
    accept): the packed result equals JAX's three arrays."""
    jcfg, tcfg, jparams, tparams, _ = model
    jctx, tctx = _prefilled(jcfg, tcfg, jparams, tparams, False, B, S,
                            [0, 1], [21, 14], seed=50)
    rng = np.random.RandomState(51)
    K = 3
    toks = np.zeros((2, K + 1), np.int32)
    toks[:, 0] = rng.randint(0, jcfg.vocab_size, 2)
    draft = rng.randint(0, jcfg.vocab_size, size=(2, K)).astype(np.int32)
    slots, q_starts = [0, 1], [20, 13]
    seq_lens = [q + K + 1 for q in q_starts]
    keys = np.asarray([[1, 2], [3, 4]], np.uint32)
    knobs = (np.full(2, temp, np.float32), np.zeros(2, np.int32),
             np.ones(2, np.float32))
    _, jout, jn, jkeys = jver.spec_verify(
        jcfg, jparams, jctx, jnp.asarray(toks), jnp.asarray(draft),
        jnp.asarray(slots), jnp.asarray(q_starts), jnp.asarray(seq_lens),
        jnp.asarray(keys), *[jnp.asarray(a) for a in knobs], KT, S)
    packed = tver.spec_verify(
        tcfg, tparams, tctx, torch.from_numpy(toks),
        torch.from_numpy(draft).long(), slots, q_starts, seq_lens,
        torch.from_numpy(keys.astype(np.int64)),
        *[torch.from_numpy(a) for a in knobs], KT,
        tl.spec_span(max(q_starts), S)).numpy()
    np.testing.assert_array_equal(packed[:, :K + 1], np.asarray(jout))
    np.testing.assert_array_equal(packed[:, K + 1], np.asarray(jn))
    np.testing.assert_array_equal(packed[:, K + 2:],
                                  np.asarray(jkeys).astype(np.int64))


def test_draft_proposer_batch_matches_per_slot_and_jax(model):  # noqa: F811
    """DraftModelProposer: the batched draft of two histories equals the
    per-slot path's and the JAX proposer's tokens, and the rollback
    pointers move as the reference's."""
    jcfg, tcfg, jparams, tparams, _ = model
    ecfg = dict(num_pages=16, page_size=16, max_pages_per_seq=4,
                max_decode_slots=2, cache_dtype="float32")
    rng = np.random.RandomState(60)
    rows = [(0, rng.randint(1, 256, 21).tolist()),
            (1, rng.randint(1, 256, 9).tolist())]
    jp = jprop.DraftModelProposer(jcfg, JEngineConfig(**ecfg),
                                  params=jparams)
    want = np.asarray(jp.propose_batch(rows, 2, 3))
    tb = tprop.DraftModelProposer(tcfg, TEngineConfig(**ecfg),
                                  device=torch.device("cpu"),
                                  params=tparams)
    got = tb.propose_batch(rows, 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert tb.pos.tolist() == jp.pos.tolist() == [23, 11]
    ts_ = tprop.DraftModelProposer(tcfg, TEngineConfig(**ecfg),
                                   device=torch.device("cpu"),
                                   params=tparams)
    per = np.stack([ts_.propose(s, h, 3).numpy() for s, h in rows])
    np.testing.assert_array_equal(per, want)
    tb.truncate(0, 22)
    tb.release(1)
    assert tb.pos.tolist() == [22, 0]


# ---------------------------------------------------------------------------
# AdaptiveKController (tests/test_spec_adaptive.py's cases)

def _controller(pkg, **kw):
    k_max = kw.pop("k_max", 8)
    k_min = kw.pop("k_min", 1)
    base = dict(grow_at=0.8, shrink_at=0.4, despec_at=0.125, ewma=0.75,
                min_obs=8)
    base.update(kw)
    return pkg.AdaptiveKController(k_max, k_min, **base)


def _k_starts_at_cap(c):
    return [c.k_for(0), c.k_for(3)]


def _k_shrinks_to_floor(c):
    for _ in range(20):
        c.observe(0, accepted=0, k_used=c.k_for(0))
    return [c.k_for(0), c.shrink_total]


def _k_grows_back(c):
    for _ in range(20):
        c.observe(0, accepted=0, k_used=c.k_for(0))
    low = c.k_for(0)
    for _ in range(30):
        c.observe(0, accepted=c.k_for(0), k_used=c.k_for(0))
    return [low, c.k_for(0), c.grow_total]


def _k_hysteresis(c):
    for _ in range(16):
        c.observe(0, accepted=5, k_used=8)
    return [c.k_for(0), c.grow_total, c.shrink_total]


def _k_despec_needs_min_obs(c):
    seen = []
    for _ in range(8):
        c.observe(0, accepted=0, k_used=4)
        seen.append(c.should_despec(0))
    for _ in range(20):
        c.observe(1, accepted=4, k_used=4)
    return seen + [c.should_despec(1)]


def _k_release_forgets(c):
    for _ in range(10):
        c.observe(0, accepted=0, k_used=4)
    before = c.k_for(0)
    c.release(0)
    return [before, c.k_for(0), c.should_despec(0)]


def _k_ewma_recovers(c):
    for _ in range(10):
        c.observe(0, accepted=4, k_used=4)
    c.observe(0, accepted=0, k_used=4)
    return [c.should_despec(0), c.rate_for(0)]   # one bad step: 0.75


@pytest.mark.parametrize("kw,walk,want", [
    (dict(k_max=8), _k_starts_at_cap, [8, 8]),
    (dict(k_max=4, k_min=2), _k_shrinks_to_floor, [2, 2]),
    (dict(k_max=8, k_min=1), _k_grows_back, [1, 8, 7]),
    (dict(k_max=8, k_min=1), _k_hysteresis, [8, 0, 0]),
    (dict(k_max=4, min_obs=8), _k_despec_needs_min_obs,
     [False] * 7 + [True, False]),
    (dict(k_max=4), _k_release_forgets, [1, 4, False]),
    (dict(k_max=4, min_obs=1), _k_ewma_recovers, [False, 0.75]),
], ids=["starts_at_cap", "shrinks_to_floor", "grows_back", "hysteresis",
        "despec_needs_min_obs", "release_forgets", "ewma_recovers"])
def test_adaptive_k_controller_walks_as_the_reference(kw, walk, want):
    got = walk(_controller(tdec, **dict(kw)))
    ref = walk(_controller(jdec, **dict(kw)))
    assert got == ref == want


def test_round_k_buckets_to_pow2_clamped_at_cli_k():
    cfg = TConfig.tiny(dtype="float32")
    dec = tdec.SpecDecoder(cfg, TEngineConfig(
        speculative="ngram", num_speculative_tokens=6), device="cpu")
    assert [dec.round_k(ks) for ks in ([1], [2, 1], [3], [5, 2])] == \
        [1, 2, 4, 6]
    off = tdec.SpecDecoder(cfg, TEngineConfig(
        speculative="ngram", num_speculative_tokens=6, spec_adaptive=False),
        device="cpu")
    assert off.k_for(0) == 6 and not off.should_despec(0)
    assert off.effective_k_dist([0, 1]) == (6.0, 6.0, 6.0)
    assert off.effective_k_dist([]) == (0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="draft_config"):
        tdec.SpecDecoder(cfg, TEngineConfig(speculative="draft"),
                         device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        tdec.SpecDecoder(cfg, TEngineConfig(speculative="draft"),
                         device="cpu",
                         draft_config=TConfig.tiny(vocab_size=512))


# ---------------------------------------------------------------------------
# the launcher

LINEAR_FLAGS = ("--speculative", "--num-speculative-tokens",
                "--spec-adaptive", "--spec-min-k", "--spec-gate-acceptance",
                "--spec-gate-window", "--spec-rearm-tokens",
                "--draft-model-config")
TREE_FLAGS = ("--spec-tree", "--spec-branches", "--spec-tree-budget")


def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


def test_launcher_serves_the_eight_linear_flags(monkeypatch):
    import os

    for k in list(os.environ):
        if k.startswith("DYNTPU_"):
            monkeypatch.delenv(k)
    ref, port = _options(rrun.build_parser()), _options(prun.build_parser())
    for flag in LINEAR_FLAGS:
        assert flag not in prun.UNPORTED_FLAGS, flag
        for attr in ("default", "choices", "type", "help"):
            assert getattr(port[flag], attr) == getattr(ref[flag], attr), \
                (flag, attr)
    for flag in TREE_FLAGS:
        assert flag not in prun.UNPORTED_FLAGS, flag
        for attr in ("default", "choices", "type", "help"):
            assert getattr(port[flag], attr) == getattr(ref[flag], attr), \
                (flag, attr)
    argv = ["out=torch", "--model-config", "tiny", "--speculative", "draft",
            "--draft-model-config", "tiny", "--num-speculative-tokens", "3",
            "--spec-adaptive", "off", "--spec-min-k", "2",
            "--spec-gate-acceptance", "0.25", "--spec-gate-window", "3",
            "--spec-rearm-tokens", "0", "--device", "cpu",
            "--cache-dtype", "float32"]
    args = prun.build_parser().parse_intermixed_args(argv)
    prun.refuse_unported(args)
    _, chain = prun.build_chain(args)
    eng = chain.engine
    e = eng.ecfg
    assert (e.speculative, e.num_speculative_tokens, e.spec_adaptive,
            e.spec_min_k, e.spec_gate_acceptance, e.spec_gate_window,
            e.spec_rearm_tokens) == ("draft", 3, False, 2, 0.25, 3, 0)
    assert eng.spec.mode == "draft" and eng.spec.adaptive is None
    assert eng.spec.draft.config.num_layers == TConfig.tiny().num_layers


@pytest.mark.parametrize("argv,match", [
    (["--spec-tree", "on"], "--spec-tree='on'"),
    (["--spec-branches", "2"], "--spec-branches=2"),
    (["--spec-tree-budget", "9"], "--spec-tree-budget=9"),
    (["out=torch", "--model-config", "tiny", "--speculative", "draft"],
     "--speculative draft needs --draft-model-config"),
])
def test_launcher_refuses_trees_and_a_draft_without_its_config(argv, match):
    """A draft without its config is refused. Each tree flag is served
    (no refusal naming it): it reaches the EngineConfig, the built tiny
    n-gram engine verifies trees, and the launcher answers a prompt."""
    if argv[0] not in TREE_FLAGS:
        with pytest.raises(SystemExit) as e:
            prun.run_cli(["in=text", "--prompt", "x"] + argv)
        assert match in str(e.value)
        return
    tree = ["--spec-tree", "on"] if argv[0] != "--spec-tree" else []
    full = (["out=torch", "--model-config", "tiny", "--device", "cpu",
             "--cache-dtype", "float32", "--speculative", "ngram",
             "--max-tokens", "6"] + tree + argv)
    args = prun.build_parser().parse_intermixed_args(full)
    prun.refuse_unported(args)
    eng = prun.build_chain(args)[1].engine
    e = eng.ecfg
    assert e.spec_tree is True
    assert (e.spec_branches, e.spec_tree_budget) == (
        int(argv[1]) if argv[0] == "--spec-branches" else 4,
        int(argv[1]) if argv[0] == "--spec-tree-budget" else 0)

    async def go():
        try:
            return await collect(eng, request(tproto, [1, 2, 3] * 4, 6))
        finally:
            await eng.stop()

    toks, _ = asyncio.run(go())
    assert len(toks) == 6 and eng.spec.tree_verify_steps > 0
    assert prun.run_cli(["in=text", "--prompt", "1 2 3 1 2 3"] + full) == 0


def test_spec_tree_knob_is_refused_by_name(model):  # noqa: F811
    """The tree knobs build (the reference's defaults: 4 branches, the
    auto budget), and batch_draft drafts a comb for m > 1."""
    e = TEngineConfig(speculative="ngram", spec_tree=True)
    assert (e.spec_tree, e.spec_branches, e.spec_tree_budget) == (True, 4, 0)
    TEngineConfig(spec_branches=2, spec_tree_budget=9)  # inert without a tree
    _, tcfg, _, tparams, _ = model
    ctx = tl.init_ctx(tcfg, 2, S, torch.float32, "cpu")
    drafted = tl.batch_draft(tcfg, tparams, ctx,
                             torch.zeros(1, 8, dtype=torch.long), [0], [0],
                             [4], S, 2, m=2)
    assert drafted.shape == (1, 4)


def test_isolation_walk_covers_the_spec_package():
    """tests/test_torch_engine.py's import walk (pkgutil over the
    package) reaches every spec module."""
    import pkgutil

    import dynamo_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(
        dynamo_tpu_torch.__path__, "dynamo_tpu_torch.")}
    for mod in ("spec", "spec.decoder", "spec.metrics", "spec.proposer",
                "spec.verifier"):
        assert "dynamo_tpu_torch." + mod in names
