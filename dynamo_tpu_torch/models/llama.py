"""Llama-family forward pass and serving-state programs (PyTorch port of
the JAX package's models/llama.py, dense weights only).

Layouts stay byte-identical to the reference:
  - parameters are a dict whose per-layer leaves are STACKED on a leading
    layer axis, matmul weights stored ``[in, out]`` (``params_from_jax``
    carries a JAX pytree across as numpy arrays);
  - the serving context is contiguous per slot, ``ctx [L, kvh, B+1, S,
    hd]``, with lane B the scratch lane for freed slots' garbage steps;
  - decode steps write a small per-slot ring ``[L, kvh, B, R, hd]`` that
    ``flush_ctx`` scatters into the region once per round;
  - the paged pool ``[L, kvh, P, ps, hd]`` is prefix-cache storage only
    (page 0 is scratch): ``seal_blocks`` copies ctx->pool,
    ``load_ctx_pages`` pool->ctx.

The JAX programs are pure and donate their state buffers so XLA updates
them in place. Here the state programs update the caller's tensors IN
PLACE explicitly (``index_put_`` / slice assignment) and return only what
is new (logits).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.attention import (
    ctx_decode_attention,
    flash_prefill_attention,
)
from dynamo_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_inv_freq

Params = dict[str, Any]
Cache = dict[str, torch.Tensor]

# the flash-decode kernel takes these two
_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


def _check_dense(config: ModelConfig) -> None:
    if config.moe is not None or config.quant is not None:
        raise NotImplementedError(
            "the PyTorch port serves dense Llama weights only (no MoE, "
            "no w8a16 quantization yet)")


# ---------------------------------------------------------------------------
# Parameters

def init_params(config: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> Params:
    """Random-init parameters in ``config.dtype``, drawn on the device from
    a ``torch.Generator`` seeded with ``seed`` (the same scales as the JAX
    init; the values themselves differ — use ``params_from_jax`` to share
    weights with the reference)."""
    _check_dense(config)
    c = config
    dtype = torch_dtype(c.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rnd(*shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1]))
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(scale)

    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size
    ones = dict(dtype=dtype, device=device)
    params: Params = {
        "embed": rnd(V, H, scale=0.02),
        "layers": {
            "ln1": torch.ones(L, H, **ones),
            "ln2": torch.ones(L, H, **ones),
            "wq": rnd(L, H, c.q_dim),
            "wk": rnd(L, H, c.kv_dim),
            "wv": rnd(L, H, c.kv_dim),
            "wo": rnd(L, c.q_dim, H),
            "wg": rnd(L, H, I),
            "wu": rnd(L, H, I),
            "wd": rnd(L, I, H),
        },
        "norm_f": torch.ones(H, **ones),
    }
    if not c.tie_word_embeddings:
        params["lm_head"] = rnd(H, V, scale=0.02)
    return params


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_params: Params,
                    device: str | torch.device = "cuda") -> Params:
    """Carry a JAX parameter pytree across, given as (nested dicts of)
    numpy arrays (``jax.tree.map(np.asarray, params)``). The layout is
    already ours: ``[in, out]`` weights stacked on a leading layer axis."""

    def conv(x):
        if isinstance(x, dict):
            if "q" in x and "s" in x:
                raise NotImplementedError("w8a16 weights are not ported yet")
            return {k: conv(v) for k, v in x.items()}
        return _tensor_from_numpy(x, device)

    if "adapters" in np_params:
        raise NotImplementedError("LoRA adapter banks are not ported yet")
    return conv(np_params)


# ---------------------------------------------------------------------------
# Serving state

def init_cache(config: ModelConfig, num_pages: int, page_size: int,
               dtype: torch.dtype, device="cuda") -> Cache:
    """Paged KV pool — prefix-cache STORAGE. Page 0 is the reserved
    scratch page for padded pool I/O."""
    c = config
    shape = (c.num_layers, c.num_kv_heads, num_pages, page_size, c.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_ctx(config: ModelConfig, batch: int, ctx_len: int,
             dtype: torch.dtype, device="cuda") -> Cache:
    """Contiguous per-slot serving context ``[L, kvh, batch+1, S, hd]``.
    Lane `batch` is the scratch lane for freed slots' garbage steps."""
    c = config
    shape = (c.num_layers, c.num_kv_heads, batch + 1, ctx_len, c.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_ring(config: ModelConfig, batch: int, ring_len: int,
              dtype: torch.dtype, device="cuda") -> Cache:
    """Per-slot decode write ring ``[L, kvh, B, R, hd]``: ring slot r of
    lane b holds the token at position ``ring_base[b] + r``."""
    c = config
    shape = (c.num_layers, c.num_kv_heads, batch, ring_len, c.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Forward pieces

def _layer(params: Params, l: int) -> Params:
    return {k: v[l] for k, v in params["layers"].items()}


_INV_FREQ: dict[tuple, torch.Tensor] = {}


def _inv_freq(config: ModelConfig, device) -> torch.Tensor:
    """RoPE inverse frequencies on ``device``, copied there once per
    (rope shape, device): a host->device copy in every decode step would
    synchronise the stream (the JAX version folds them into the compiled
    program as a constant)."""
    key = (config.head_dim, config.rope_theta, config.rope_scaling,
           str(torch.device(device)))
    t = _INV_FREQ.get(key)
    if t is None:
        t = _INV_FREQ[key] = torch.from_numpy(rope_inv_freq(
            config.head_dim, config.rope_theta, config.rope_scaling_dict,
        )).to(device)
    return t


def _embed_rows(params: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embed"][tokens].to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _mlp(h, wg, wu, wd):
    return (F.silu(h @ wg) * (h @ wu)) @ wd


def _layer_body(c: ModelConfig, lp: Params, h: torch.Tensor, cos, sin,
                write_kv: Callable, attend: Callable) -> torch.Tensor:
    """Shared decoder-layer body for prefill and decode. ``write_kv(k, v)``
    stores the new KV and returns what ``attend(q, kv)`` reads; h is
    [N, H] (N = padded tokens for prefill, batch slots for decode)."""
    N = h.shape[0]
    x = rms_norm(h, lp["ln1"], c.rms_norm_eps)
    q = (x @ lp["wq"]).view(N, c.num_heads, c.head_dim)
    k = (x @ lp["wk"]).view(N, c.num_kv_heads, c.head_dim)
    v = (x @ lp["wv"]).view(N, c.num_kv_heads, c.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, write_kv(k, v))
    h = h + attn.reshape(N, c.q_dim) @ lp["wo"]
    x2 = rms_norm(h, lp["ln2"], c.rms_norm_eps)
    return h + _mlp(x2, lp["wg"], lp["wu"], lp["wd"])


def _logits(config: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["norm_f"], config.rms_norm_eps)
    if config.tie_word_embeddings:
        w = params["embed"].t()
    else:
        w = params["lm_head"]
    # f32 result; a bf16 model's product is rounded to bf16 first (the
    # f32 copy of the [H, V] matrix an f32 product needs is 2 GB at 8B)
    return (h @ w).float()


# ---------------------------------------------------------------------------
# Prefill

def _batch_forward(
    config: ModelConfig,
    params: Params,
    ctx: Cache,
    tokens: torch.Tensor,  # [K, T] int, bucket-padded per request
    slots: list[int],
    q_starts: list[int],
    seq_lens: list[int],
    ctx_span: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Read-only layer stack of batch_prefill: K chunks through the model
    at once (the JAX version's vmap is the batch dimension here: matmuls
    see [K*T, H] rows, attention runs per request). Returns (ks, vs, h):
    per-layer KV [K, L, T, kvh, hd] and final hidden states [K, T, H]."""
    c = config
    K, T = tokens.shape
    dev = tokens.device
    # built on the device: a host list copied over would sync the stream
    positions = torch.cat([torch.arange(q, q + T, device=dev)
                           for q in q_starts])
    cos, sin = rope_cos_sin(positions, _inv_freq(c, dev))
    cdt = ctx["k"].dtype
    h = _embed_rows(params, tokens.reshape(-1), cdt)        # [K*T, H]
    new_ks: list[torch.Tensor] = []
    new_vs: list[torch.Tensor] = []
    for l in range(c.num_layers):
        def write_kv(k, v):
            new_ks.append(k)
            new_vs.append(v)
            return k, v

        def attend(q, kv, l=l):
            k_new, v_new = kv
            outs = []
            for i in range(K):
                rows = slice(i * T, (i + 1) * T)
                if ctx_span > 0:
                    k_ctx = ctx["k"][l, :, slots[i], :ctx_span]
                    v_ctx = ctx["v"][l, :, slots[i], :ctx_span]
                else:
                    k_ctx = v_ctx = None
                outs.append(flash_prefill_attention(
                    q[rows], k_ctx, v_ctx, k_new[rows], v_new[rows],
                    q_starts[i], seq_lens[i]))
            return torch.cat(outs)

        h = _layer_body(c, _layer(params, l), h, cos, sin, write_kv, attend)
    L, kvh, hd = c.num_layers, c.num_kv_heads, c.head_dim
    ks = torch.stack(new_ks).to(cdt).view(L, K, T, kvh, hd).transpose(0, 1)
    vs = torch.stack(new_vs).to(cdt).view(L, K, T, kvh, hd).transpose(0, 1)
    return ks, vs, h.view(K, T, -1)


def _write_chunks(ctx: Cache, ks: torch.Tensor, vs: torch.Tensor,
                  slots: list[int], q_starts: list[int]) -> None:
    """Tail pass, after every read: each chunk's KV [L, kvh, T, hd] lands
    at [q_start, q_start+T) of its slot's region, in place. The start is
    clamped into [0, S-T] as the JAX version's dynamic_update_slice
    clamps it."""
    S = ctx["k"].shape[3]
    T = ks.shape[2]
    for i in range(ks.shape[0]):
        st = min(max(q_starts[i], 0), S - T)
        ctx["k"][:, :, slots[i], st:st + T] = ks[i].transpose(1, 2)
        ctx["v"][:, :, slots[i], st:st + T] = vs[i].transpose(1, 2)


def batch_prefill(
    config: ModelConfig,
    params: Params,
    ctx: Cache,
    tokens: torch.Tensor,  # [K, T] int, bucket-padded per request
    slots: list[int],      # destination lanes (distinct; dummies -> B)
    q_starts: list[int],   # tokens already in each region
    seq_lens: list[int],   # total valid context per request (dummies 0)
    ctx_span: int = 0,     # prior-context window to attend (0 = fresh)
) -> torch.Tensor:
    """Batched multi-request prefill: K chunks through the model together,
    each chunk's KV written into its slot's region at [q_start,
    q_start+T) IN PLACE after the last read. Returns logits [K, V] (f32)
    of each row's last valid token. Padding lanes point at the scratch
    lane with seq_len 0."""
    _check_dense(config)
    ks, vs, h = _batch_forward(config, params, ctx, tokens, slots, q_starts,
                               seq_lens, ctx_span)
    _write_chunks(ctx, ks, vs, slots, q_starts)
    last = [max(s - q - 1, 0) for s, q in zip(seq_lens, q_starts)]
    h_last = torch.stack([h[i, t] for i, t in enumerate(last)])
    return _logits(config, params, h_last)


# ---------------------------------------------------------------------------
# Decode

def decode_step(
    config: ModelConfig,
    params: Params,
    ctx: Cache,                # [L, kvh, B+1, S, hd] — read-only here
    ring: Cache,               # [L, kvh, B, R, hd] — written IN PLACE
    tokens: torch.Tensor,      # [B] int — last sampled token per slot
    ctx_lens: torch.Tensor,    # [B] int32 — context INCLUDING this token
    ring_base: torch.Tensor,   # [B] int32 — position held by ring slot 0
    ring_pos: int,             # ring slot receiving this token
) -> torch.Tensor:
    """One decode step for all slots; returns logits [B, V] (f32). Each
    layer's new KV goes into ring slot ``ring_pos`` BEFORE attention (its
    position is ``ctx-1 == ring_base + ring_pos`` for live slots);
    attention reads the ctx region below ring_base plus the ring."""
    c = config
    positions = torch.clamp(ctx_lens - 1, min=0)
    cos, sin = rope_cos_sin(positions, _inv_freq(c, tokens.device))
    h = _embed_rows(params, tokens, ctx["k"].dtype)                # [B, H]
    for l in range(c.num_layers):
        def write_kv(k, v, l=l):
            # [B, kvh, hd] -> ring[l, :, :, ring_pos, :]
            ring["k"][l, :, :, ring_pos] = k.transpose(0, 1)
            ring["v"][l, :, :, ring_pos] = v.transpose(0, 1)
            return ring

        def attend(q, ring, l=l):
            return ctx_decode_attention(
                q, ctx["k"], ctx["v"], ring["k"], ring["v"], l,
                ctx_lens, ring_base)

        h = _layer_body(c, _layer(params, l), h, cos, sin, write_kv, attend)
    return _logits(c, params, h)


def flush_ctx(
    ctx: Cache,
    ring: Cache,
    dest: torch.Tensor,       # [B] int — live: own lane; freed: scratch B
    ring_base: torch.Tensor,  # [B] int
    valid_len: torch.Tensor,  # [B] int — real tokens in the ring per slot
) -> None:
    """Scatter a full ring into the ctx region IN PLACE (once per round,
    after all of the round's reads). Ring entry (b, r) holds position
    ring_base[b]+r and goes to lane dest[b]; entries beyond valid_len[b],
    beyond the region, or of freed slots are redirected to the scratch
    lane (position 0 there: garbage by contract)."""
    L, kvh, B, R, hd = ring["k"].shape
    S = ctx["k"].shape[3]
    scratch = ctx["k"].shape[2] - 1
    dev = dest.device
    r_idx = torch.arange(R, device=dev)[None, :]              # [1, R]
    pos = ring_base.long()[:, None] + r_idx                   # [B, R]
    valid = (r_idx < valid_len.long()[:, None]) & (pos < S)
    lane = torch.where(valid, dest.long()[:, None], scratch).reshape(-1)
    pos = torch.where(valid, pos, 0).reshape(-1)
    for name in ("k", "v"):
        # advanced indices on dims 2, 3: target [L, kvh, B*R, hd]
        ctx[name][:, :, lane, pos] = ring[name].reshape(L, kvh, B * R, hd)


# ---------------------------------------------------------------------------
# prefix-cache <-> context copies (admission / block seal)

def load_ctx_pages(
    ctx: Cache,
    cache: Cache,
    slot: int,                # destination lane
    page_ids: torch.Tensor,   # [n] int — pow2-padded; padding = scratch 0
) -> None:
    """Copy a matched prefix run of pool pages into the slot's context
    region at [0, n*ps), in place. The page list is pow2-padded by the
    caller, so n*ps can exceed the region: the load is clamped to the
    region (only padding can overflow)."""
    n = page_ids.shape[0]
    ps = cache["k"].shape[3]
    S = ctx["k"].shape[3]
    usable = min(n, S // ps)
    if usable <= 0:
        return
    page_ids = page_ids[:usable]
    for name in ("k", "v"):
        pages = cache[name][:, :, page_ids]   # [L, kvh, usable, ps, hd]
        L, kvh, _, _, hd = pages.shape
        ctx[name][:, :, slot, :usable * ps] = pages.reshape(
            L, kvh, usable * ps, hd).to(ctx[name].dtype)


def seal_blocks(
    cache: Cache,
    ctx: Cache,
    slots: torch.Tensor,   # [n] int — source lanes (pow2-padded)
    starts: torch.Tensor,  # [n] int — block start positions
    pages: torch.Tensor,   # [n] int — destination pool pages (pad -> 0)
    page_size: int,
) -> None:
    """Copy sealed blocks ctx->pool in place: entry i copies
    ctx[:, :, slots[i], starts[i]:+ps] into pool page pages[i] (one gather
    over the (lane, position)-flattened axis). Padding rows target scratch
    page 0."""
    ps = page_size
    for name in ("k", "v"):
        src = ctx[name]
        L, kvh, lanes, S, hd = src.shape
        flat = src.view(L, kvh, lanes * S, hd)
        idx = ((slots.long() * S + starts.long())[:, None]
               + torch.arange(ps, device=src.device)[None, :])
        cache[name][:, :, pages.long()] = flat[:, :, idx].to(cache[name].dtype)
