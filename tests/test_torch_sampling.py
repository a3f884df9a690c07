"""Parity of the PyTorch port's sampler with the JAX package's. Greedy
decoding, with or without penalties, must pick the same tokens; sampled
draws come from different generators (threefry vs torch.Generator), so
they are compared by the set of tokens each side can emit."""
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
    state = js.SamplerState(keys=jnp.zeros((B, 2), jnp.uint32),
                            counts=jnp.asarray(counts))
    jtok, jstate = js.sample_step_impl(jnp.asarray(logits), state, jp, TOPK)
    tcounts = torch.from_numpy(counts.copy())
    gens = [torch.Generator().manual_seed(i) for i in range(B)]
    ttok = ts.sample_step(torch.from_numpy(logits), tcounts, tp, TOPK, gens)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jstate.counts))


def _support(draw, n=300):
    seen = [set() for _ in range(B)]
    for i in range(n):
        for b, t in enumerate(draw(i)):
            seen[b].add(int(t))
    return seen


def test_top_k_top_p_masks_match_jax():
    """Rows: top-k 3 over near-equal leaders, top-p cutting after the
    first two lanes, top-k 1 (always the argmax), top-p ~0 (argmax)."""
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

    gens = [torch.Generator().manual_seed(100 + b) for b in range(B)]

    def tdraw(i):
        return ts.sample_step(torch.from_numpy(logits),
                              torch.zeros(B, V, dtype=torch.int32), tp,
                              TOPK, gens).numpy()

    want = [{5, 9, 40}, {1, 2}, {7}, {11}]
    assert _support(jdraw) == want
    assert _support(tdraw) == want


def test_seeded_sampling_is_reproducible():
    logits, _ = _logits_counts(4)
    _, tp = _params([0.9] * B, [0] * B, [0.95] * B, [0.0] * B, [0.0] * B,
                    [1.0] * B)

    def run(seed):
        gens = [torch.Generator().manual_seed(seed + b) for b in range(B)]
        counts = torch.zeros(B, V, dtype=torch.int32)
        return [ts.sample_step(torch.from_numpy(logits), counts, tp, TOPK,
                               gens).tolist() for _ in range(20)]

    assert run(7) == run(7)
    assert run(7) != run(8)
