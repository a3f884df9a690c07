"""Parity of the PyTorch port's sampler with the JAX package's. The port
carries its own threefry2x32, so with the same keys the split keys and
random bits are bit-equal to JAX's, and sampled draws (temperature, top-k,
top-p, penalties) are token-identical to ``sample_step_impl`` step after
step. Greedy decoding, with or without penalties, picks the same tokens;
logprobs agree to float32 rounding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as js
from dynamo_tpu_torch.engine import sampling as ts

B, V, TOPK = 4, 64, 16


def _params(temp, top_k, top_p, freq, pres, rep):
    cols = dict(temperature=temp, top_k=top_k, top_p=top_p,
                frequency_penalty=freq, presence_penalty=pres,
                repetition_penalty=rep)
    jp = js.SamplingParams(**{
        k: jnp.asarray(np.asarray(v, np.int32 if k == "top_k" else np.float32))
        for k, v in cols.items()})
    tp = ts.SamplingParams(**{
        k: torch.tensor(v, dtype=torch.int32 if k == "top_k" else torch.float32)
        for k, v in cols.items()})
    return jp, tp


def _keys(seed, n=B):
    """Random uint32 key pairs: (jax uint32 [n, 2], port int64 [n, 2])."""
    k = np.random.RandomState(seed).randint(0, 2**32, size=(n, 2),
                                            dtype=np.uint64)
    return (jnp.asarray(k.astype(np.uint32)),
            torch.from_numpy(k.astype(np.int64)))


def _logits_counts(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 2).astype(np.float32)
    counts = rng.randint(0, 3, size=(B, V)).astype(np.int32)
    counts[:, ::3] = 0
    return logits, counts


def test_apply_penalties_matches_jax():
    """Same elementwise f32 arithmetic on both sides: 1e-6."""
    logits, counts = _logits_counts(0)
    jp, tp = _params([0.0] * B, [0] * B, [1.0] * B,
                     [0.0, 0.5, 0.2, 1.0], [0.0, 0.3, 0.0, 0.7],
                     [1.0, 1.3, 0.8, 2.0])
    want = np.asarray(js.apply_penalties(
        jnp.asarray(logits), jnp.asarray(counts), jp))
    got = ts.apply_penalties(
        torch.from_numpy(logits), torch.from_numpy(counts), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_with_penalties_matches_jax(seed):
    logits, counts = _logits_counts(seed)
    jp, tp = _params([0.0] * B, [0] * B, [1.0] * B,
                     [0.0, 0.5, 0.2, 1.0], [0.0, 0.3, 0.0, 0.7],
                     [1.0, 1.3, 0.8, 2.0])
    jkeys, tkeys = _keys(seed)
    state = js.SamplerState(keys=jkeys, counts=jnp.asarray(counts))
    jtok, jstate = js.sample_step_impl(jnp.asarray(logits), state, jp, TOPK)
    tcounts = torch.from_numpy(counts.copy())
    ttok = ts.sample_step(torch.from_numpy(logits), tcounts, tp, TOPK, tkeys)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jstate.counts))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jstate.keys))


def _support(draw, n=300):
    seen = [set() for _ in range(B)]
    for i in range(n):
        for b, t in enumerate(draw(i)):
            seen[b].add(int(t))
    return seen


def test_top_k_top_p_masks_match_jax():
    """Rows: top-k 3 over near-equal leaders, top-p cutting after the
    first two lanes, top-k 1 (always the argmax), top-p ~0 (argmax). The
    same keys give the same draws on both sides."""
    rng = np.random.RandomState(3)
    logits = (rng.randn(B, V) * 0.1 - 5.0).astype(np.float32)
    logits[0, [5, 9, 40]] = [3.0, 3.05, 2.95]
    logits[1, [1, 2, 3]] = [3.0, 3.0, 0.0]
    logits[2, 7] = 2.0
    logits[3, 11] = 2.0
    counts = np.zeros((B, V), np.int32)
    args = ([1.0] * B, [3, 0, 1, 0], [1.0, 0.6, 1.0, 1e-6],
            [0.0] * B, [0.0] * B, [1.0] * B)
    jp, tp = _params(*args)
    j_logits, j_counts = jnp.asarray(logits), jnp.asarray(counts)

    def jdraw(i):
        st = js.init_state(B, V, seed=i)._replace(counts=j_counts)
        return np.asarray(js.sample_step_impl(j_logits, st, jp, TOPK)[0])

    def tdraw(i):
        keys = torch.from_numpy(np.asarray(
            js.init_state(B, V, seed=i).keys).astype(np.int64))
        return ts.sample_step(torch.from_numpy(logits),
                              torch.zeros(B, V, dtype=torch.int32), tp,
                              TOPK, keys).numpy()

    want = [{5, 9, 40}, {1, 2}, {7}, {11}]
    assert _support(jdraw) == want
    assert _support(tdraw) == want
    for i in range(20):
        np.testing.assert_array_equal(tdraw(i), jdraw(i))


def test_seeded_sampling_is_reproducible():
    logits, _ = _logits_counts(4)
    _, tp = _params([0.9] * B, [0] * B, [0.95] * B, [0.0] * B, [0.0] * B,
                    [1.0] * B)

    def run(seed):
        keys = torch.tensor([[0, seed + b] for b in range(B)])
        counts = torch.zeros(B, V, dtype=torch.int32)
        return [ts.sample_step(torch.from_numpy(logits), counts, tp, TOPK,
                               keys).tolist() for _ in range(20)]

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_threefry_split_bits_and_categorical_equal_jax():
    """A grid of keys (zeros, the first-token tag, all-ones words and
    random ones): split keys and 32-bit random words exact; categorical
    draws identical (Gumbel noise agrees to 2 ulp, the last bit of f32
    log)."""
    kj, kt = _keys(11, 12)
    grid = np.asarray(kj).copy()
    grid[0] = [0, 0]
    grid[1] = [0x46697273, 7]
    grid[2] = [0xFFFFFFFF, 0xFFFFFFFF]
    kt = torch.from_numpy(grid.astype(np.int64))
    new, sub = ts.split_keys(kt)
    rng = np.random.RandomState(12)
    for b, row in enumerate(grid):
        key = jax.random.wrap_key_data(jnp.asarray(row),
                                       impl="threefry2x32")
        j_new, j_sub = jax.random.split(key)
        np.testing.assert_array_equal(
            new[b].numpy(), np.asarray(jax.random.key_data(j_new)))
        np.testing.assert_array_equal(
            sub[b].numpy(), np.asarray(jax.random.key_data(j_sub)))
        np.testing.assert_array_equal(
            ts.random_bits(sub[b:b + 1], 37)[0].numpy(),
            np.asarray(jax.random.bits(j_sub, (37,), jnp.uint32)))
        np.testing.assert_allclose(
            ts.gumbel(sub[b:b + 1], 37)[0].numpy(),
            np.asarray(jax.random.gumbel(j_sub, (37,))), rtol=3e-7,
            atol=3e-7)
        row_logits = rng.randn(V).astype(np.float32)
        assert int(ts.categorical(
            sub[b:b + 1], torch.from_numpy(row_logits)[None])[0]) == int(
            jax.random.categorical(j_sub, jnp.asarray(row_logits)))


@pytest.mark.parametrize("knobs", [
    dict(temp=[0.7, 1.0, 1.3, 0.0], top_k=[0] * B, top_p=[1.0] * B),
    dict(temp=[0.8] * B, top_k=[5, 1, 0, 12], top_p=[1.0] * B),
    dict(temp=[0.9] * B, top_k=[0] * B, top_p=[0.9, 0.5, 0.99, 1e-6]),
    dict(temp=[1.0] * B, top_k=[8] * B, top_p=[0.8] * B,
         freq=[0.5] * B, pres=[0.3] * B, rep=[1.2] * B),
])
def test_sample_step_token_identical_to_jax(knobs):
    """60 chained steps with fresh logits each step: tokens, counts and
    keys equal sample_step_impl's at every step (exact)."""
    jp, tp = _params(knobs["temp"], knobs["top_k"], knobs["top_p"],
                     knobs.get("freq", [0.0] * B),
                     knobs.get("pres", [0.0] * B),
                     knobs.get("rep", [1.0] * B))
    jkeys, tkeys = _keys(21)
    state = js.SamplerState(keys=jkeys, counts=jnp.zeros((B, V), jnp.int32))
    tcounts = torch.zeros(B, V, dtype=torch.int32)
    rng = np.random.RandomState(22)
    step = jax.jit(js.sample_step_impl, static_argnums=(3,))
    for _ in range(60):
        logits = (rng.randn(B, V) * 2).astype(np.float32)
        jtok, state = step(jnp.asarray(logits), state, jp, TOPK)
        ttok = ts.sample_step(torch.from_numpy(logits), tcounts, tp, TOPK,
                              tkeys)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(tkeys.numpy(), np.asarray(state.keys))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(state.counts))


def test_compute_logprobs_matches_jax():
    """log-softmax in f32 on both sides: 1e-5; the same top ids."""
    logits, _ = _logits_counts(5)
    toks = np.asarray([3, 0, 63, 17], np.int32)
    want = js.compute_logprobs(jnp.asarray(logits), jnp.asarray(toks), 5)
    got = ts.compute_logprobs(torch.from_numpy(logits),
                              torch.from_numpy(toks), 5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5)
    packed = ts.pack_logprobs(*got)
    assert packed.shape == (B, 1 + 2 * 5)
    np.testing.assert_array_equal(packed[:, 1:6].int().numpy(),
                                  np.asarray(want[1]))
