"""Attention over the contiguous per-slot decode context.

  - decode: ``ctx_decode_attention`` — the Hopper flash-decode kernel for
    CUDA tensors, its plain PyTorch version for CPU tensors
    (ops/flash_decode.py), over a dense or an int8 region;
  - prefill: ``flash_prefill_attention`` (batched prefill) — blocked
    running-softmax attention — and ``ctx_prefill_attention`` (a prefill
    of one request) — one dense causal attention over the slot's whole
    region — in plain PyTorch ops, the same functions as the JAX
    package's (prefill is a large matmul workload; the reference has no
    kernel for it either).
"""
from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.ops.flash_decode import flash_decode_attention

NEG_INF = -1e30


def ctx_decode_attention(
    q: torch.Tensor,          # [B, n_heads, hd] — one new token per slot
    ctx_k: torch.Tensor,      # [L, kvh, B(+1), S, hd]
    ctx_v: torch.Tensor,
    ring_k: torch.Tensor,     # [L, kvh, B, R, hd] current-round writes
    ring_v: torch.Tensor,
    layer: int,
    ctx_lens: torch.Tensor,   # [B] int32 — context length INCL. current token
    ring_base: torch.Tensor,  # [B] int32 — position held by ring slot 0
    ctx_k_scale: Optional[torch.Tensor] = None,  # f32 [L, B(+1), S//g]
    ctx_v_scale: Optional[torch.Tensor] = None,  # when ctx is int8
) -> torch.Tensor:
    """Decode attention over the two-tier context (ctx region below
    ring_base + ring above). The current token's KV must already be in the
    ring. Returns [B, n_heads, hd]. With scales the ctx region is int8
    and is dequantized inside the kernel."""
    return flash_decode_attention(
        q, ctx_k, ctx_v, ring_k, ring_v, layer, ctx_lens, ring_base,
        ctx_k_scale, ctx_v_scale)


def ctx_prefill_attention(
    q: torch.Tensor,        # [T, n_heads, hd] — new tokens (padded)
    k_ctx: torch.Tensor,    # [kvh, S, hd] — slot's PRIOR context (< q_start)
    v_ctx: torch.Tensor,
    k_new: torch.Tensor,    # [T, kvh, hd] — this chunk's keys
    v_new: torch.Tensor,
    q_start: int,           # tokens already in the region
    seq_len: int,           # total valid context length
) -> torch.Tensor:
    """Causal attention of T new tokens (positions q_start..q_start+T)
    against prior context [0, q_start) plus the chunk itself (causal), as
    one dense [T, S+T] softmax. Returns [T, n_heads, hd]. The chunk's KV
    is passed directly; the region is written once after every read."""
    T, n_heads, hd = q.shape
    kvh, S, _ = k_ctx.shape
    n_rep = n_heads // kvh
    dev = q.device
    k = torch.cat([k_ctx, k_new.transpose(0, 1).to(k_ctx.dtype)], dim=1)
    v = torch.cat([v_ctx, v_new.transpose(0, 1).to(v_ctx.dtype)], dim=1)
    k = k.repeat_interleave(n_rep, dim=0)               # [nh, S+T, hd]
    v = v.repeat_interleave(n_rep, dim=0)
    scale = 1.0 / (hd ** 0.5)
    qt = q.transpose(0, 1)                              # [nh, T, hd]
    scores = torch.einsum("nth,nsh->nts", qt.float(), k.float()) * scale
    q_pos = q_start + torch.arange(T, device=dev)[:, None]      # [T, 1]
    ctx_pos = torch.arange(S, device=dev)[None, :]              # [1, S]
    ctx_ok = ((ctx_pos < q_start) & (ctx_pos < seq_len)).expand(T, S)
    new_pos = q_start + torch.arange(T, device=dev)[None, :]    # [1, T]
    new_ok = (new_pos <= q_pos) & (new_pos < seq_len)           # causal
    mask = torch.cat([ctx_ok, new_ok], dim=1)                   # [T, S+T]
    scores = torch.where(mask[None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("nts,nsh->tnh", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_prefill_attention(
    q: torch.Tensor,        # [T, n_heads, hd] — new tokens (padded)
    k_ctx: Optional[torch.Tensor],  # [kvh, Sc, hd] prior context, or None
    v_ctx: Optional[torch.Tensor],
    k_new: torch.Tensor,    # [T, kvh, hd] — this chunk's keys
    v_new: torch.Tensor,
    q_start: int,           # tokens already in the region
    seq_len: int,           # total valid context length
    block: int = 256,
) -> torch.Tensor:
    """Blocked running-softmax prefill attention: T new tokens at
    positions q_start..q_start+T attend prior context [0, q_start) plus
    the chunk causally, bounded by seq_len. Scores never exceed
    [nh, T, block]. ``k_ctx=None`` is the fresh-prefill case (no context
    scan at all). Rows with no visible key (padding queries) emit zeros;
    NEG_INF is finite, as in the JAX version."""
    T, n_heads, hd = q.shape
    kvh = k_new.shape[1]
    n_rep = n_heads // kvh
    dev = q.device
    scale = 1.0 / (hd ** 0.5)
    qt = q.transpose(0, 1).float()                       # [nh, T, hd]
    q_pos = q_start + torch.arange(T, device=dev)        # [T]

    m = torch.full((n_heads, T), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((n_heads, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((n_heads, T, hd), dtype=torch.float32, device=dev)

    def blocked(k_src, v_src, mask_fn):
        # scan key blocks of k_src [kvh, S, hd]; mask_fn(key_pos) -> [T, blk]
        nonlocal m, l, acc
        S = k_src.shape[1]
        blk = min(block, S)
        for start in range(0, S, blk):
            k_blk = k_src[:, start:start + blk]
            v_blk = v_src[:, start:start + blk]
            k_rep = k_blk.repeat_interleave(n_rep, dim=0).float()
            v_rep = v_blk.repeat_interleave(n_rep, dim=0)
            s = torch.einsum("nth,nbh->ntb", qt, k_rep) * scale
            key_pos = start + torch.arange(k_blk.shape[1], device=dev)
            s = torch.where(mask_fn(key_pos)[None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "ntb,nbh->nth", p.to(v_rep.dtype).float(), v_rep.float())
            m = m_new

    if k_ctx is not None:
        # prior context: valid below q_start (q_start <= seq_len always)
        blocked(k_ctx, v_ctx, lambda kp: (
            ((kp < q_start) & (kp < seq_len))[None, :].expand(T, -1)))
    # the chunk itself: causal, bounded by seq_len
    blocked(
        k_new.transpose(0, 1).to(q.dtype), v_new.transpose(0, 1).to(q.dtype),
        lambda kp: (((q_start + kp)[None, :] <= q_pos[:, None])
                    & ((q_start + kp) < seq_len)[None, :]),
    )
    # fully masked rows: p = exp(NEG_INF - NEG_INF) = 1 per key, so l ends
    # at the key count, not 0 — gate on the running max never having seen
    # a real score and emit zeros explicitly
    out = acc / torch.clamp(l, min=1e-30)[..., None]     # [nh, T, hd]
    out = torch.where((m > NEG_INF / 2)[..., None], out, 0.0)
    return out.transpose(0, 1).to(q.dtype)
