"""Batched on-device sampling: greedy / temperature / top-k / top-p plus
frequency, presence and repetition penalties, and OpenAI-style logprobs
(port of the JAX package's engine/sampling.py).

Randomness is JAX's: per-slot threefry2x32 keys ``[B, 2]`` on the device
(int64 tensors holding uint32 values), split once per sampled step, and
``categorical`` by the Gumbel-max trick over the candidates, bit for bit
as JAX 0.9 computes ``random.split``, ``random.bits``, ``uniform`` and
``gumbel`` with ``jax_threefry_partitionable`` on. So a seeded request
draws the same tokens here as in the JAX package, on the CPU and on the
card. Only the final ``log`` calls may differ in the last bit between
libraries, which can flip a draw only at an exact near-tie.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
# threefry2x32's rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny


@dataclass
class SamplingParams:
    """Per-slot sampling knobs as device tensors (set on slot assignment)."""

    temperature: torch.Tensor          # [B] f32; <=0 means greedy
    top_k: torch.Tensor                # [B] i32; 0/negative disables
    top_p: torch.Tensor                # [B] f32; 1.0 disables
    frequency_penalty: torch.Tensor    # [B] f32
    presence_penalty: torch.Tensor     # [B] f32
    repetition_penalty: torch.Tensor   # [B] f32; 1.0 disables


def default_params(batch: int, device="cuda") -> SamplingParams:
    f32 = dict(dtype=torch.float32, device=device)
    return SamplingParams(
        temperature=torch.zeros(batch, **f32),
        top_k=torch.zeros(batch, dtype=torch.int32, device=device),
        top_p=torch.ones(batch, **f32),
        frequency_penalty=torch.zeros(batch, **f32),
        presence_penalty=torch.zeros(batch, **f32),
        repetition_penalty=torch.ones(batch, **f32),
    )


# ---------------------------------------------------------------------------
# threefry2x32 (uint32 values carried in int64 tensors, masked to 32 bits
# after every add and shift, so nothing reaches int64's sign bit)

def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) of counters (x1, x2)
    under key (k1, k2); all four broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & _M32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def split_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(key)`` per row of ``keys`` [B, 2]: (new key,
    subkey), each [B, 2] (counters 0 and 1, high words 0)."""
    lo = torch.arange(2, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return (torch.stack([b1[:, 0], b2[:, 0]], dim=-1),
            torch.stack([b1[:, 1], b2[:, 1]], dim=-1))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per row: [B, n] uint32
    values in int64."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return b1 ^ b2


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per row (the default
    "low" mode): -log(-log(u)), u uniform in [tiny, 1) from the top 23
    bits of each word."""
    bits = random_bits(keys, n)
    f = (((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
         - 1.0)
    u = torch.clamp(f * 1.0 + _F32_TINY, min=_F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, row)`` per row: argmax of logits plus
    Gumbel noise. Returns [B] int64 lane indices."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


# ---------------------------------------------------------------------------
# sampling

def apply_penalties(
    logits: torch.Tensor, counts: torch.Tensor, p: SamplingParams
) -> torch.Tensor:
    """OpenAI-style frequency/presence penalties + HF repetition penalty."""
    seen = counts > 0
    logits = logits - p.frequency_penalty[:, None] * counts.float()
    logits = logits - p.presence_penalty[:, None] * seen.float()
    rep = p.repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    return torch.where(seen, penalized, logits)


def filter_logits(
    logits: torch.Tensor, p: SamplingParams, max_top_k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Temperature-scaled top-k/top-p candidates: (final [B, K] with
    excluded lanes at NEG_INF, vocab ids [B, K]), K = max_top_k lanes in
    descending logit order."""
    temps = torch.clamp(p.temperature, min=1e-6)[:, None]
    vals, idxs = torch.topk(logits, max_top_k, dim=-1)
    scaled = vals / temps
    pos = torch.arange(max_top_k, device=logits.device)[None, :]
    k_eff = torch.where(p.top_k <= 0, max_top_k, p.top_k)
    mask_k = pos < torch.clamp(k_eff, max=max_top_k)[:, None]
    probs = torch.softmax(torch.where(mask_k, scaled, NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # nucleus: keep lanes whose cumulative prob (exclusive) is < top_p
    mask_p = (cum - probs) < p.top_p[:, None]
    return torch.where(mask_k & mask_p, scaled, NEG_INF), idxs


def sample_step(
    logits: torch.Tensor,      # [B, V] f32
    counts: torch.Tensor,      # [B, V] int32 output-token histogram
    params: SamplingParams,
    max_top_k: int,
    keys: torch.Tensor,        # [B, 2] int64 threefry keys (uint32 words)
) -> torch.Tensor:
    """Sample one token per slot; returns tokens [B] int32. ``counts``
    and ``keys`` advance IN PLACE (the JAX version returns a new
    SamplerState): every row's key is split once, greedy rows too."""
    B = logits.shape[0]
    logits = apply_penalties(logits, counts, params)
    greedy = torch.argmax(logits, dim=-1)
    final, idxs = filter_logits(logits, params, max_top_k)
    new_keys, sub = split_keys(keys)
    choice = categorical(sub, final)
    sampled = idxs.gather(1, choice[:, None])[:, 0]
    tokens = torch.where(params.temperature <= 0.0, greedy, sampled).int()
    counts[torch.arange(B, device=counts.device), tokens.long()] += 1
    keys.copy_(new_keys)
    return tokens


def compute_logprobs(
    logits: torch.Tensor,   # [B, V] f32 RAW model logits (pre-penalty)
    tokens: torch.Tensor,   # [B] int chosen tokens
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """OpenAI-style logprobs: the MODEL's log-softmax (before sampling
    transforms), for the chosen token plus the top-k alternatives.
    Returns (chosen_lp [B], top_ids [B, k] int32, top_lps [B, k])."""
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    chosen = logp.gather(1, tokens.long()[:, None])[:, 0]
    top_lps, top_ids = torch.topk(logp, k, dim=-1)
    return chosen, top_ids.int(), top_lps


def pack_logprobs(chosen: torch.Tensor, ids: torch.Tensor,
                  lps: torch.Tensor) -> torch.Tensor:
    """One f32 row [..., 1+2K] per step: chosen logprob, top ids (exact in
    f32: vocab << 2^24), top logprobs, so a round's logprobs come back in
    one copy."""
    return torch.cat([chosen[..., None], ids.float(), lps], dim=-1)
