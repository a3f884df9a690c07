"""Batched on-device sampling: greedy / temperature / top-k / top-p plus
frequency, presence and repetition penalties (port of the JAX package's
engine/sampling.py).

Randomness comes from one ``torch.Generator`` per decode slot, seeded from
the request's seed, so a seeded request reproduces its draws. The stream
differs from JAX's threefry stream for the same seed; greedy decoding
(with or without penalties) is identical across the two.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

NEG_INF = -1e30


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
    generators: Sequence[torch.Generator],  # one per row
) -> torch.Tensor:
    """Sample one token per slot; returns tokens [B] int32 and advances
    ``counts`` IN PLACE (the JAX version returns a new histogram)."""
    B = logits.shape[0]
    logits = apply_penalties(logits, counts, params)
    greedy = torch.argmax(logits, dim=-1)
    final, idxs = filter_logits(logits, params, max_top_k)
    probs = torch.softmax(final, dim=-1)
    choice = torch.cat([
        torch.multinomial(probs[b], 1, generator=generators[b])
        for b in range(B)
    ])
    sampled = idxs.gather(1, choice[:, None])[:, 0]
    tokens = torch.where(params.temperature <= 0.0, greedy, sampled).int()
    counts[torch.arange(B, device=counts.device), tokens.long()] += 1
    return tokens
