"""Tree speculation of the PyTorch port (dynamo_tpu_torch/spec/ under
``spec_tree``) against the JAX package's, on the CPU: the packed-tree
metadata walk, the comb parents and the n-gram trie, greedy and sampled
tree acceptance with and without penalties (duplicate-token siblings and
padding nodes included), the tree-causal chunk mask of the blocked
prefill attention, the tree scorer and the path commit (dense and int8
regions), the comb draft, the whole tree verify, the controller's branch
axis, and TorchEngine against TpuEngine with ``spec_tree`` on (greedy
n-gram and comb drafts at K = 2 and 4, seeded sampled and penalized
streams, the gate, the context limit, the metrics surfaces).

Tolerances: tree metadata, comb parents, tries, acceptance results
(tokens, paths, counts, advanced keys), drafted tokens and packed verify
results are exactly equal. Attention outputs agree to 1e-5 and padding
rows are exact zeros; logits to 1e-5 (1e-4 through an int8 region);
committed regions as tests/test_torch_spec.py holds the linear verify's
(f32 to 1e-5, int8 bytes within one step on at most 0.1% of them, scales
to 5e-6 relative)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.spec import decoder as jdec
from dynamo_tpu.spec import proposer as jprop
from dynamo_tpu.spec import verifier as jver
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.spec import decoder as tdec
from dynamo_tpu_torch.spec import proposer as tprop
from dynamo_tpu_torch.spec import verifier as tver
from dynamo_tpu_torch.spec.metrics import SPEC, SPEC_FAMILIES
from tests.test_torch_llama import model  # noqa: F401 — weights fixture
from tests.test_torch_spec import (
    ACCEPT_CASES,
    KT,
    V,
    _assert_region,
    _prefilled,
)
from tests.test_torch_spec_engine import (  # noqa: F401 — fixtures
    COUNTERS,
    assert_same_run,
    baseline_mixed,
    prompt_long,
    prompts_mixed,
    run,
    weights,
)

B, S = 3, 64
TREE_COUNTERS = COUNTERS + (
    "spec_tree_nodes_total", "spec_tree_accepted_path_len_total",
    "spec_tree_verify_steps", "spec_branch_accept_hist",
    "spec_branch_grow_total", "spec_branch_shrink_total")


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_parents(rng, T, d_max, n_real):
    """A valid packed tree of ``n_real`` nodes (root included) no deeper
    than ``d_max``, padded with -2 to T."""
    parents, depth = [-1], [0]
    for _ in range(1, n_real):
        choices = [i for i, d in enumerate(depth) if d < d_max]
        p = int(rng.choice(choices))
        parents.append(p)
        depth.append(depth[p] + 1)
    return parents + [-2] * (T - n_real)


# ---------------------------------------------------------------------------
# tree metadata, comb parents, tries

PARENT_CASES = [
    [-1, 0, 0, 1, -2],                     # tests/test_spec_tree.py's
    [-1, 0, 1, 2],                         # a chain: the causal mask
    [-1, -2, -2, -2],                      # the root alone, padded
    [-1],                                  # a single node
    jprop.comb_parents(3, 2) + [-2, -2],   # a padded comb
]


@pytest.mark.parametrize("parents", PARENT_CASES + ["random"])
def test_tree_meta_matches_jax(parents):
    if parents == "random":
        rng = np.random.RandomState(5)
        rows = np.asarray([_random_parents(rng, 12, 4, n)
                           for n in (1, 5, 9, 12, 12, 7)], np.int32)
    else:
        rows = np.asarray([parents], np.int32)
    want = [np.asarray(x) for x in jax.vmap(jver.tree_meta)(
        jnp.asarray(rows))]
    got = [x.numpy() for x in tver.tree_meta(_t(rows))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if parents == [-1, 0, 1, 2]:
        assert np.array_equal(got[1][0], np.tri(4, dtype=bool))


@pytest.mark.parametrize("k,m", [(1, 1), (3, 1), (2, 3), (4, 4), (1, 5)])
def test_comb_parents_match_jax(k, m):
    assert tprop.comb_parents(k, m) == jprop.comb_parents(k, m)
    assert len(tprop.comb_parents(k, m)) == 1 + k * m


_H = [1, 2, 3, 9, 1, 2, 4, 9, 1, 2]


@pytest.mark.parametrize("history,depth,branches,budget", [
    (_H, 2, 2, 16),                        # two forks at the root
    (_H, 4, 4, 4),                         # the budget caps the trie
    ([1, 2, 3, 4], 3, 2, 8),               # no match: the zero chain
    ([5, 6, 5, 6, 5, 6, 5], 4, 3, 17),     # shared prefixes merge
    ([7] * 12, 3, 4, 6),                   # one continuation
    ("random", 4, 4, 17),
])
def test_propose_tree_matches_jax(history, depth, branches, budget):
    if history == "random":
        history = np.random.RandomState(8).randint(0, 5, 200).tolist()
    for max_n, min_n in ((3, 1), (2, 2)):
        t = tprop.NGramProposer(4, max_n, min_n).propose_tree(
            history, depth, branches, budget)
        j = jprop.NGramProposer(4, max_n, min_n).propose_tree(
            history, depth, branches, budget)
        assert t == j
        toks, pars = t
        assert len(toks) == len(pars) <= budget - 1
        assert all(0 <= p <= i for i, p in enumerate(pars))
    if history == [1, 2, 3, 4]:
        assert t == ([0, 0, 0], [0, 1, 2])


# ---------------------------------------------------------------------------
# tree acceptance: exactly JAX's out, path, n_out and new keys

def _tree_case(seed, temp, top_k, top_p, rows=6, T=10, D=3):
    """Logits [rows, T, V], trees whose children often carry their
    parent row's argmax or one of its top tokens (so paths of every
    length occur), duplicate-token siblings and padding nodes."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(rows, T, V) * 2.0).astype(np.float32)
    parents = np.asarray([_random_parents(rng, T, D, rng.randint(2, T + 1))
                          for _ in range(rows)], np.int32)
    toks = np.zeros((rows, T), np.int32)
    toks[:, 0] = rng.randint(0, V, rows)
    order = np.argsort(-logits, axis=-1)
    for r in range(rows):
        for i in range(1, T):
            p = parents[r, i]
            if p < 0:
                continue
            sib = [j for j in range(1, i) if parents[r, j] == p]
            x = rng.rand()
            if sib and x < 0.2:
                toks[r, i] = toks[r, sib[0]]            # a duplicate
            elif x < 0.6:
                toks[r, i] = order[r, p, 0]             # the argmax
            elif x < 0.85:
                toks[r, i] = order[r, p, rng.randint(1, 4)]
            else:
                toks[r, i] = rng.randint(0, V)
    keys = rng.randint(0, 2**32, size=(rows, 2),
                       dtype=np.uint64).astype(np.uint32)
    knobs = (np.full(rows, temp, np.float32), np.full(rows, top_k, np.int32),
             np.full(rows, top_p, np.float32))
    return logits, toks, parents, keys, knobs


def _jax_tree(fn, arrays, D):
    out = jax.vmap(functools.partial(fn, max_top_k=KT, d_max=D))(
        *[jnp.asarray(a) for a in arrays])
    return [np.asarray(o) for o in out]


def _check_tree_equal(got, want):
    out, path, n_out, keys = (t.numpy() for t in got)
    np.testing.assert_array_equal(out, want[0])
    np.testing.assert_array_equal(path, want[1])
    np.testing.assert_array_equal(n_out, want[2])
    np.testing.assert_array_equal(keys, want[3].astype(np.int64))


@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("temp,top_k,top_p", ACCEPT_CASES)
def test_accept_tree_is_exactly_jax(D, temp, top_k, top_p):
    logits, toks, parents, keys, knobs = _tree_case(
        D * 10 + int(temp * 10), temp, top_k, top_p, D=D)
    valid = parents >= -1
    want = _jax_tree(jver.accept_tree,
                     (logits, toks, parents, valid, keys, *knobs), D)
    got = tver.accept_tree(
        _t(logits), _t(toks), _t(parents), _t(valid),
        _t(keys.astype(np.int64)), *[_t(a) for a in knobs], KT, D)
    _check_tree_equal(got, want)
    assert len(set(want[2].tolist())) > 1     # paths of several lengths
    if temp <= 0.0:
        # greedy: each accepted node carries its parent row's argmax
        greedy = logits.argmax(-1)
        for r in range(len(toks)):
            n = int(want[2][r])
            nodes = [0] + list(want[1][r, 1:n])
            for a, b in zip(nodes, nodes[1:]):
                assert toks[r, b] == greedy[r, a]


@pytest.mark.parametrize("temp,top_k,top_p", ACCEPT_CASES)
@pytest.mark.parametrize("penalty", ["identity", "penalized"])
def test_accept_tree_penalized_is_exactly_jax(temp, top_k, top_p, penalty):
    D = 3
    logits, toks, parents, keys, knobs = _tree_case(
        40 + int(temp * 10), temp, top_k, top_p, D=D)
    rows = len(toks)
    valid = parents >= -1
    rng = np.random.RandomState(4)
    if penalty == "identity":
        counts = np.zeros((rows, V), np.int32)
        pens = (np.zeros(rows, np.float32), np.zeros(rows, np.float32),
                np.ones(rows, np.float32))
    else:
        counts = rng.randint(0, 3, size=(rows, V)).astype(np.int32)
        counts[np.arange(rows), toks[:, 1]] += 1
        pens = (np.full(rows, 0.4, np.float32), np.full(rows, 0.2, np.float32),
                np.full(rows, 1.3, np.float32))
    arrays = (logits, toks, parents, valid, keys, *knobs, counts, *pens)
    want = _jax_tree(jver.accept_tree_penalized, arrays, D)
    before = counts.copy()
    got = tver.accept_tree_penalized(
        *[_t(a.astype(np.int64) if a is keys else a) for a in arrays],
        max_top_k=KT, d_max=D)
    _check_tree_equal(got, want)
    np.testing.assert_array_equal(counts, before)
    if penalty == "identity":
        # zero counts and identity penalties draw as the plain walk does
        plain = _jax_tree(jver.accept_tree,
                          (logits, toks, parents, valid, keys, *knobs), D)
        for a, b in zip(want, plain):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the tree-causal mask of the blocked prefill attention

def _attn_inputs(seed, T, Sc, nh=4, kvh=2, hd=16):
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.7).astype(np.float32)  # noqa: E731
    return (f(T, nh, hd), f(kvh, Sc, hd), f(kvh, Sc, hd), f(T, kvh, hd),
            f(T, kvh, hd))


# key blocks that divide T (and the context): the JAX function pads a
# ragged tail block and would read the mask past its end there, which
# the engine never asks for (a verify's T is below the 256-key block)
@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("block", [3, 256])
def test_flash_prefill_chunk_mask_matches_jax(with_ctx, block):
    T, Sc, q_start = 9, 24, 13
    q, kc, vc, kn, vn = _attn_inputs(3, T, Sc)
    parents = np.asarray([[-1, 0, 0, 1, 1, 2, 3, -2, -2]], np.int32)
    anc = np.asarray(jax.vmap(jver.tree_meta)(jnp.asarray(parents))[1])[0]
    qs = q_start if with_ctx else 0
    ctx_j = (jnp.asarray(kc), jnp.asarray(vc)) if with_ctx else (None, None)
    ctx_t = (_t(kc), _t(vc)) if with_ctx else (None, None)
    want = np.asarray(jatt.flash_prefill_attention(
        jnp.asarray(q), *ctx_j, jnp.asarray(kn), jnp.asarray(vn),
        jnp.int32(qs), jnp.int32(qs + 7), block=block,
        chunk_mask=jnp.asarray(anc)))
    got = tatt.flash_prefill_attention(
        _t(q), *ctx_t, _t(kn), _t(vn), qs, qs + 7, block=block,
        chunk_mask=_t(anc)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if not with_ctx:
        # padding nodes see no key at all: exact zeros, not NaN
        assert not got[7:].any()
    # a chain's ancestor mask is the causal mask
    chain = np.tri(T, dtype=bool)
    causal = tatt.flash_prefill_attention(
        _t(q), *ctx_t, _t(kn), _t(vn), qs, qs + T, block=block)
    masked = tatt.flash_prefill_attention(
        _t(q), *ctx_t, _t(kn), _t(vn), qs, qs + T, block=block,
        chunk_mask=_t(chain))
    np.testing.assert_allclose(masked.numpy(), causal.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the tree scorer, the path commit and the comb draft

def _tree_rows(jcfg, seed, T):
    """Two rows' packed trees: a trie with padding, and a comb."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, T)).astype(np.int32)
    parents = np.full((2, T), -2, np.int32)
    parents[0, :6] = [-1, 0, 0, 1, 2, 4]
    comb = jprop.comb_parents(3, 2)
    parents[1, :len(comb)] = comb
    return toks, parents


@pytest.mark.parametrize("quant", [False, True])
def test_batch_score_tree_and_commit_match_jax(model, quant):  # noqa: F811
    """Logits for every node and the chunk's KV, then an accepted path's
    rows committed into the region, agree with the JAX functions; the
    scorer alone leaves the region as it was."""
    jcfg, tcfg, jparams, tparams, _ = model
    _, tctx = _prefilled(jcfg, tcfg, jparams, tparams, quant, B, S,
                         [0, 2], [20, 29], seed=70)
    # one region for both: the two prefills may round an int8 byte at a
    # tie apart, which is the prefill's difference, not the tree's
    jctx = {n: jnp.asarray(t.numpy()) for n, t in tctx.items()}
    T = 8
    toks, parents = _tree_rows(jcfg, 71, T)
    slots, q_starts = [0, 2], [19, 28]
    seq_lens = [q + T for q in q_starts]
    depths, ancs, _ = jax.vmap(jver.tree_meta)(jnp.asarray(parents))
    jks, jvs, jlogits = jax.jit(jl.batch_score_tree_impl,
                                static_argnums=(0, 9))(
        jcfg, jparams, jctx, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(q_starts), jnp.asarray(seq_lens), depths, ancs, S)
    before = {n: t.clone() for n, t in tctx.items()}
    tdepths, tancs, _ = tver.tree_meta(_t(parents))
    tks, tvs, tlogits = tl.batch_score_tree(
        tcfg, tparams, tctx, _t(toks), slots, q_starts, seq_lens, tdepths,
        tancs, S)
    for n in tctx:
        assert torch.equal(tctx[n], before[n])
    tol = 1e-4 if quant else 1e-5
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), rtol=tol,
                               atol=tol)
    path = np.zeros((2, T), np.int32)
    path[0, :4] = [0, 2, 4, 5]
    path[1, :3] = [0, 1, 4]
    n_out = [4, 3]
    commit = [q + n for q, n in zip(q_starts, n_out)]
    jctx = jl.commit_tree_path(jctx, jks, jvs, jnp.asarray(path),
                               jnp.asarray(slots), jnp.asarray(q_starts),
                               jnp.asarray(commit))
    tl.commit_tree_path(tctx, tks, tvs, _t(path).long(), slots, q_starts,
                        [torch.tensor(c) for c in commit])
    _assert_region(tctx, jctx, lanes=slice(0, B))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("k,m", [(1, 3), (4, 2)])
def test_batch_draft_comb_matches_jax(model, quant, k, m):  # noqa: F811
    """m > 1: the top-m a level (columns level-major, the spine first)
    and the draft region, where only the spine's KV lands."""
    jcfg, tcfg, jparams, tparams, _ = model
    jctx, tctx = _prefilled(jcfg, tcfg, jparams, tparams, quant, B, S,
                            [1, 2], [12, 17], seed=80)
    toks = np.random.RandomState(81).randint(
        0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    slots, q_starts, seq_lens = [1, 2], [12, 17], [12 + 6, 17 + 8]
    jctx, jdrafted = jl.batch_draft_impl(
        jcfg, jparams, jctx, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(q_starts), jnp.asarray(seq_lens), S, k, m)
    tdrafted = tl.batch_draft(tcfg, tparams, tctx, _t(toks), slots,
                              q_starts, seq_lens, S, k, m)
    assert tdrafted.shape == (2, k * m)
    np.testing.assert_array_equal(tdrafted.numpy(), np.asarray(jdrafted))
    _assert_region(tctx, jctx, lanes=slice(0, B))
    # the spine is the linear draft's chain
    _, lin = _prefilled(jcfg, tcfg, jparams, tparams, quant, B, S, [1, 2],
                        [12, 17], seed=80)
    chain = tl.batch_draft(tcfg, tparams, lin, _t(toks), slots, q_starts,
                           seq_lens, S, k)
    np.testing.assert_array_equal(tdrafted[:, ::m].numpy(), chain.numpy())


def test_top_m_orders_ties_as_jax_top_k():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits.numpy()), 4)[1])
    np.testing.assert_array_equal(tl._top_m(logits, 4).numpy(), want)


@pytest.mark.parametrize("temp,draft", [(0.0, False), (0.9, False),
                                        (0.0, True), (0.8, True)])
def test_spec_verify_tree_matches_jax(model, temp, draft):  # noqa: F811
    """The whole tree verify (a comb draft spliced on the device, or host
    trees; metadata, score, walk, path commit): the packed result equals
    JAX's and the committed region agrees."""
    jcfg, tcfg, jparams, tparams, _ = model
    jctx, tctx = _prefilled(jcfg, tcfg, jparams, tparams, False, B, S,
                            [0, 1], [21, 14], seed=90)
    rng = np.random.RandomState(91)
    D, M = 3, 2
    T = 1 + D * M
    toks, parents = _tree_rows(jcfg, 92, T)
    dr = None
    if draft:
        parents[:] = jprop.comb_parents(D, M)
        dr = rng.randint(0, jcfg.vocab_size, size=(2, T - 1)).astype(np.int32)
    slots, q_starts = [0, 1], [20, 13]
    seq_lens = [q + T for q in q_starts]
    keys = np.asarray([[1, 2], [3, 4]], np.uint32)
    knobs = (np.full(2, temp, np.float32), np.zeros(2, np.int32),
             np.ones(2, np.float32))
    jctx, jpacked = jver.spec_verify_tree(
        jcfg, jparams, jctx, jnp.asarray(toks),
        None if dr is None else jnp.asarray(dr), jnp.asarray(parents),
        jnp.asarray(slots), jnp.asarray(q_starts), jnp.asarray(seq_lens),
        jnp.asarray(keys), *[jnp.asarray(a) for a in knobs], KT, S, D)
    packed = tver.spec_verify_tree(
        tcfg, tparams, tctx, _t(toks), None if dr is None else _t(dr).long(),
        _t(parents), slots, q_starts, seq_lens, _t(keys.astype(np.int64)),
        *[_t(a) for a in knobs], KT, tl.spec_span(max(q_starts), S), D)
    jpacked = np.asarray(jpacked)
    assert packed.shape == (2, 2 * D + 4)
    np.testing.assert_array_equal(packed[:, :2 * D + 2].numpy(),
                                  jpacked[:, :2 * D + 2])
    np.testing.assert_array_equal(
        packed[:, 2 * D + 2:].numpy(),
        jpacked[:, 2 * D + 2:].view(np.uint32).astype(np.int64))
    _assert_region(tctx, jctx, lanes=slice(0, B))


def test_draft_proposer_comb_matches_jax(model):  # noqa: F811
    """DraftModelProposer.propose_batch with branches: the comb equals
    the JAX proposer's, and the rollback pointers move as the chain's."""
    jcfg, tcfg, jparams, tparams, _ = model
    ecfg = dict(num_pages=16, page_size=16, max_pages_per_seq=4,
                max_decode_slots=2, cache_dtype="float32")
    rng = np.random.RandomState(60)
    rows = [(0, rng.randint(1, 256, 21).tolist()),
            (1, rng.randint(1, 256, 9).tolist())]
    jp = jprop.DraftModelProposer(jcfg, JEngineConfig(**ecfg),
                                  params=jparams)
    want = np.asarray(jp.propose_batch(rows, 2, 3, branches=2))
    tp = tprop.DraftModelProposer(tcfg, TEngineConfig(**ecfg),
                                  device=torch.device("cpu"), params=tparams)
    got = tp.propose_batch(rows, 3, branches=2).numpy()
    np.testing.assert_array_equal(got, want)
    assert tp.pos.tolist() == jp.pos.tolist() == [23, 11]


# ---------------------------------------------------------------------------
# the controller's branch axis and the decoder's tree state

def _branch_walk(c):
    seen = [(c.k_for(0), c.m_for(0))]
    for _ in range(12):
        c.observe(0, accepted=0, k_used=c.k_for(0))
        seen.append((c.k_for(0), c.m_for(0)))
    for _ in range(20):
        c.observe(0, accepted=c.k_for(0), k_used=c.k_for(0))
        seen.append((c.k_for(0), c.m_for(0)))
    c.release(0)
    seen.append((c.k_for(0), c.m_for(0)))
    return seen + [c.branch_grow_total, c.branch_shrink_total, c.m_for(40)]


@pytest.mark.parametrize("m_max", [1, 4])
def test_controller_branch_axis_walks_as_the_reference(m_max):
    kw = dict(grow_at=0.8, shrink_at=0.4, despec_at=0.125, ewma=0.75,
              min_obs=8, m_max=m_max)
    got = _branch_walk(tdec.AdaptiveKController(4, 1, **kw))
    want = _branch_walk(jdec.AdaptiveKController(4, 1, **kw))
    assert got == want
    with pytest.raises(ValueError, match="spec_branches"):
        tdec.AdaptiveKController(4, 1, **dict(kw, m_max=0))


def test_decoder_tree_state_matches_the_reference():
    """Budget (auto and explicit) and its validation, m_for / round_m,
    and on_result_tree's counters, branch histogram and draft rollback."""
    cfg = TConfig.tiny(dtype="float32")
    ekw = dict(speculative="ngram", num_speculative_tokens=4,
               spec_tree=True, spec_branches=3)
    from dynamo_tpu.models.config import ModelConfig as JConfig

    t = tdec.SpecDecoder(cfg, TEngineConfig(**ekw), device="cpu")
    j = jdec.SpecDecoder(JConfig.tiny(dtype="float32"), JEngineConfig(**ekw))
    assert (t.tree, t.branches, t.tree_budget) == (j.tree, j.branches,
                                                    j.tree_budget) == \
        (True, 3, 13)
    assert [t.round_m(ms) for ms in ([1], [2, 1], [3])] == \
        [j.round_m(ms) for ms in ([1], [2, 1], [3])] == [1, 2, 3]
    parents = tprop.comb_parents(4, 3)
    for dec in (t, j):
        dec.on_result_tree(0, 30, 3, 4, 3, 12, [1, 4, 8, 0], parents)
        dec.on_result_tree(1, 30, 2, 4, 3, 12, [2, 5, 0, 0], parents)
        dec.on_result_tree(0, 34, 0, 4, 3, 12, [0, 0, 0, 0], parents)
    ts, js = t.stats(), j.stats()
    for key in js:
        assert ts[key] == js[key], key
    assert ts["spec_branch_accept_hist"] == [2, 3, 0]
    assert t.m_for(0) == j.m_for(0) and t.m_for(1) == j.m_for(1)
    with pytest.raises(ValueError, match="spec_tree_budget"):
        tdec.SpecDecoder(cfg, TEngineConfig(**ekw, spec_tree_budget=4),
                         device="cpu")
    lin = tdec.SpecDecoder(cfg, TEngineConfig(speculative="ngram"),
                           device="cpu")
    assert lin.m_for(0) == 1 and lin.stats()["spec_tree"] is False


# ---------------------------------------------------------------------------
# TorchEngine against TpuEngine with spec_tree on

def assert_same_tree_run(t, j, baseline=None):
    assert_same_run(t, j, baseline, counters=False)
    assert {k: t[2].get(k) for k in TREE_COUNTERS} == \
        {k: j[2].get(k) for k in TREE_COUNTERS}
    assert t[2]["spec_tree"] is True and t[2]["spec_tree_verify_steps"] > 0


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_tree_greedy_identical_to_the_reference(weights, baseline_mixed, mode,
                                                k):
    """Greedy tries and combs: the streams, the prefix registry (only the
    accepted path is committed, so sibling rows never show) and every
    counter equal TpuEngine's and the non-speculative run's."""
    kw = dict(speculative=mode, num_speculative_tokens=k, spec_tree=True,
              spec_branches=2)
    draft = mode == "draft"
    t = run("torch", weights, prompts_mixed(), draft=draft, **kw)
    assert_same_tree_run(t, run("jax", weights, prompts_mixed(), draft=draft,
                                **kw), baseline_mixed)
    if draft:
        assert t[2]["spec_acceptance_rate"] > 0.8
        dc = t[4].dispatch_counts
        assert dc["spec_draft"] == dc["spec_verify"] > 0
    else:
        assert t[2]["spec_reject_events"] > 0


@pytest.mark.parametrize("so", [
    dict(temperature=0.8, top_k=8, seed=7),
    dict(temperature=0.9, seed=11, presence_penalty=0.5),
], ids=["sampled", "sampled_penalized"])
def test_tree_seeded_sampled_streams_draw_the_reference_tokens(weights, so):
    """The tree walk consumes the slot's key stream as the JAX walk does:
    a seeded request draws the reference's tokens, and repeats itself."""
    kw = dict(speculative="ngram", num_speculative_tokens=4, spec_tree=True,
              spec_branches=2)
    t = run("torch", weights, prompts_mixed()[:1], so=so, **kw)
    assert_same_tree_run(t, run("jax", weights, prompts_mixed()[:1], so=so,
                                **kw))
    again = run("torch", weights, prompts_mixed()[:1], so=so, **kw)
    assert again[0] == t[0] and len(t[0][0]) == 24


def test_tree_penalized_greedy_identical_to_the_reference(weights):
    """Penalized greedy requests ride the penalized walk (counts advance
    down the accepted path) and match the fused run token for token."""
    so = dict(frequency_penalty=0.6, presence_penalty=0.3,
              repetition_penalty=1.2)
    kw = dict(speculative="ngram", num_speculative_tokens=4, spec_tree=True,
              spec_branches=2)
    t = run("torch", weights, prompts_mixed(), so=so, **kw)
    assert_same_tree_run(t, run("jax", weights, prompts_mixed(), so=so, **kw),
                         run("torch", weights, prompts_mixed(), so=so))


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_tree_despec_at_the_context_limit(weights, mode):
    """The commit spans up to the budget's rows: near the region's end
    the slot goes back to the fused round before anything is packed, and
    its tail matches the reference's (64 positions: 44 new tokens)."""
    kw = dict(max_pages_per_seq=4, speculative=mode, num_speculative_tokens=4,
              spec_tree=True, spec_branches=2)
    draft = mode == "draft"
    t = run("torch", weights, prompt_long(), 100, draft=draft, **kw)
    j = run("jax", weights, prompt_long(), 100, draft=draft, **kw)
    base = run("torch", weights, prompt_long(), 100, max_pages_per_seq=4)
    assert_same_tree_run(t, j, base)
    assert len(t[0][0]) == 44 and t[2]["spec_despec_total"] >= 1


def test_tree_gate_despecs_and_rearms(weights):
    """The acceptance gate hands low-acceptance tree streams back to the
    fused round and re-arms them; the output stays the plain run's and
    the reference's (a re-arm waits out the rounds in flight, which
    depends on when fetches land, so counters are held to the rules)."""
    kw = dict(speculative="ngram", num_speculative_tokens=4, spec_tree=True,
              spec_branches=2, spec_adaptive=False, spec_gate_acceptance=0.5,
              spec_gate_window=2, spec_rearm_tokens=4)
    t = run("torch", weights, prompts_mixed(), 48, **kw)
    j = run("jax", weights, prompts_mixed(), 48, **kw)
    assert_same_run(t, j, run("torch", weights, prompts_mixed(), 48),
                    counters=False)
    assert t[2]["spec_gated_despec_total"] >= 1
    assert t[2]["spec_rearm_total"] >= 1


def test_tree_metrics_surface(weights):
    """The tree counters reach stats(), metrics()' WorkerStats and the
    SPEC registry, which renders all four families."""
    kw = dict(speculative="ngram", num_speculative_tokens=4, spec_tree=True,
              spec_branches=2)
    nodes0 = SPEC.get("dynamo_spec_tree_nodes_total")
    path0 = SPEC.get("dynamo_spec_tree_accepted_path_len_total")
    t = run("torch", weights, prompts_mixed(), 16, **kw)
    st = t[2]
    assert st["spec_tree_nodes_total"] > 0
    assert st["spec_tree_mean_path_len"] >= 0.0
    assert len(st["spec_branch_accept_hist"]) == 2
    ws = t[4].metrics().worker_stats
    assert ws.spec_tree_nodes_total == st["spec_tree_nodes_total"]
    assert (ws.spec_tree_accepted_path_len_total
            == st["spec_tree_accepted_path_len_total"])
    assert (SPEC.get("dynamo_spec_tree_nodes_total") - nodes0
            == st["spec_tree_nodes_total"])
    assert (SPEC.get("dynamo_spec_tree_accepted_path_len_total") - path0
            == st["spec_tree_accepted_path_len_total"])
    text = SPEC.render()
    for name, _, _ in SPEC_FAMILIES:
        assert name in text
