"""Llama-family forward pass and serving-state programs (PyTorch port of
the JAX package's models/llama.py: dense or w8a16 weights, no MoE).

Layouts stay byte-identical to the reference:
  - parameters are a dict whose per-layer leaves are STACKED on a leading
    layer axis, matmul weights stored ``[in, out]`` (``params_from_jax``
    carries a JAX pytree across as numpy arrays; ``load_hf_params`` and
    ``params_from_state_dict`` fill it from an HF checkpoint); with
    ``config.quant="int8"`` each matmul weight is the leaf pair ``{"q":
    int8 [..., in, out], "s": f32 [..., out]}`` (the embedding ``{"q":
    int8 [V, H], "s": f32 [V]}``) and every product goes through the w8a16
    kernel (``_mm``, ops/w8a16.py);
  - the serving context is contiguous per slot, ``ctx [L, kvh, B+1, S,
    hd]``, with lane B the scratch lane for freed slots' garbage steps;
  - decode steps write a small per-slot ring ``[L, kvh, B, R, hd]`` that
    ``flush_ctx`` scatters into the region once per round;
  - the paged pool ``[L, kvh, P, ps, hd]`` is prefix-cache storage only
    (page 0 is scratch): ``seal_blocks`` copies ctx->pool,
    ``load_ctx_pages`` pool->ctx;
  - with ``kv_quant="int8"`` the region and the pool are int8, with f32
    absmax scales ``[L, B+1, S/group]`` and ``[L, P]`` (group ==
    page_size, so ctx<->pool copies move raw pages and scales); writes
    quantize on store (``_quant_store_span``, ``_flush_ctx_quant``), the
    decode kernel dequantizes, and prefill dequantizes on read
    (``_ctx_slot_slab``). The ring stays in the compute dtype. A dense
    pool beside an int8 region (or the reverse) quantizes (dequantizes)
    in the copy;
  - ``gather_pages`` / ``scatter_pages`` (``_q`` for an int8 pool) move
    whole pages ``[2, L, kvh, n, ps, hd]`` for the offload tiers and page
    export/import;
  - a resident LoRA bank (tenancy/adapters.py) rides in
    ``params["adapters"]``, ``{site: {"a": [N, L, d_in, r], "b": [N, L,
    r, d_out]}}``: prefill takes one adapter id, batch_prefill one a row
    and decode_step one a slot, and each adapted product adds the rank-r
    delta ``(x @ A) @ B`` of its row's factors. Without a bank, or with
    every host-known id 0, the functions issue exactly the operations
    they issue without tenancy (adapter 0's delta is exactly 0.0).

The JAX programs are pure and donate their state buffers so XLA updates
them in place. Here the state programs update the caller's tensors IN
PLACE explicitly (``index_put_`` / slice assignment) and return only what
is new (logits).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.kv_quant import (
    SCALE_EPS,
    dequantize_groups,
    requantize_groups,
)
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops.attention import (
    ctx_decode_attention,
    ctx_prefill_attention,
    flash_prefill_attention,
)
from dynamo_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_inv_freq
from dynamo_tpu_torch.ops.w8a16 import w8a16_matmul

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


def _check_supported(config: ModelConfig) -> None:
    if config.moe is not None:
        raise NotImplementedError(
            "the PyTorch port serves dense Llama FFNs only (no MoE yet)")
    if config.quant not in (None, "int8"):
        raise ValueError(f"unsupported weight quantization {config.quant!r}")


# ---------------------------------------------------------------------------
# Parameters

def init_params(config: ModelConfig, seed: int = 0,
                device: str | torch.device = "cuda") -> Params:
    """Random-init parameters in ``config.dtype``, drawn on the device from
    a ``torch.Generator`` seeded with ``seed`` (the same scales as the JAX
    init; the values themselves differ — use ``params_from_jax`` to share
    weights with the reference). With ``config.quant="int8"`` the int8
    leaves are drawn directly, uniform in [-127, 127] with a constant
    per-channel scale that recovers the dense init's std, as the
    reference does: an 8B's dense weights are never made."""
    _check_supported(config)
    c = config
    dtype = torch_dtype(c.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    quant8 = c.quant == "int8"

    def rnd(*shape, scale=None, qaxis=-2):
        scale = scale or (1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1]))
        if quant8:
            q = torch.randint(-127, 128, shape, generator=gen, device=device,
                              dtype=torch.int8)
            s_shape = tuple(np.delete(shape, len(shape) + qaxis))
            # uniform[-127, 127] has std ~73.3; s recovers the dense std
            s = torch.full(s_shape, scale / 73.3, dtype=torch.float32,
                           device=device)
            return {"q": q, "s": s}
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype).mul_(scale)

    L, H, I, V = c.num_layers, c.hidden_size, c.intermediate_size, c.vocab_size
    ones = dict(dtype=dtype, device=device)
    params: Params = {
        "embed": rnd(V, H, scale=0.02, qaxis=-1),
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
    already ours: ``[in, out]`` weights stacked on a leading layer axis,
    a w8a16 weight as its ``{"q", "s"}`` pair, a LoRA bank as
    ``params["adapters"]`` (f32 factors, cast to the activation dtype at
    each delta as the reference casts them)."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor_from_numpy(x, device)

    return conv(np_params)


# ---------------------------------------------------------------------------
# Quantization (w8a16: per-output-channel symmetric int8 weights)
#
# A quantized weight is the leaf pair {"q": int8 [..., in, out], "s": f32
# [..., out]}; every matmul site routes through _mm/_embed_rows/_logits so
# dense and quantized params are interchangeable. The int8 tensor is what
# streams from device memory; the w8a16 kernel dequantizes on chip.

_QUANT_AXIS = {
    # reduction axis for the per-output-channel scale, per weight name
    # (all weights are stored [in, out]-style; embed is row-gathered)
    "wq": -2, "wk": -2, "wv": -2, "wo": -2,
    "wg": -2, "wu": -2, "wd": -2,
    "embed": -1, "lm_head": -2,
}


def _is_quant(w) -> bool:
    return isinstance(w, dict) and "q" in w


def quantize_tensor(w: torch.Tensor, axis: int) -> Params:
    """Symmetric per-channel int8: scale = amax/127 over ``axis`` (floored
    at 1e-10), q = clip(round(w / scale), -127, 127)."""
    wf = w.to(torch.float32, copy=True)  # rounded in place below
    s = torch.clamp(wf.abs().amax(dim=axis) / 127.0, min=1e-10)
    q = wf.div_(s.unsqueeze(axis)).round_().clamp_(-127, 127)
    return {"q": q.to(torch.int8), "s": s}


def quantize_params(params: Params) -> Params:
    """Dense params -> w8a16 (a post-load transform). Norms stay dense."""
    out = dict(params)
    layers = dict(params["layers"])
    for name, axis in _QUANT_AXIS.items():
        if name in layers:
            layers[name] = quantize_tensor(layers[name], axis)
    out["layers"] = layers
    out["embed"] = quantize_tensor(params["embed"], _QUANT_AXIS["embed"])
    if "lm_head" in params:
        out["lm_head"] = quantize_tensor(params["lm_head"],
                                         _QUANT_AXIS["lm_head"])
    return out


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """The dense leaves (weights and norms) in ``dtype``; a w8a16 pair
    ``{"q", "s"}`` stays as it is."""
    if _is_quant(params):
        return params
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype)


# ---------------------------------------------------------------------------
# Checkpoint loading (HF safetensors; gguf.py feeds the same assembly)

_HF_LAYER_MAP = {
    "input_layernorm.weight": ("ln1", False),
    "post_attention_layernorm.weight": ("ln2", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "mlp.gate_proj.weight": ("wg", True),
    "mlp.up_proj.weight": ("wu", True),
    "mlp.down_proj.weight": ("wd", True),
}


def _leaf_shapes(c: ModelConfig) -> dict[str, tuple]:
    """Each leaf's shape in our layout (a layer leaf without its layer
    axis)."""
    H, I = c.hidden_size, c.intermediate_size
    return {"ln1": (H,), "ln2": (H,), "wq": (H, c.q_dim),
            "wk": (H, c.kv_dim), "wv": (H, c.kv_dim), "wo": (c.q_dim, H),
            "wg": (H, I), "wu": (H, I), "wd": (I, H),
            "embed": (c.vocab_size, H), "norm_f": (H,),
            "lm_head": (H, c.vocab_size)}


def params_from_state_dict(config: ModelConfig,
                           raw: Mapping[str, Any], dtype=None,
                           device: str | torch.device = "cuda") -> Params:
    """Our parameter tree from HF-named tensors (``raw[name]``: a torch
    tensor or numpy array, read once each; the JAX package's
    ``params_from_state_dict``, with the same values).

    HF linear weights are ``[out, in]``; ours are ``[in, out]``, stacked on
    a leading layer axis. Every leaf is allocated once on ``device`` and
    filled one tensor at a time: a source tensor goes to the device as it
    is (its own dtype, one layer's matrix at most), is cast to ``dtype``
    (default ``config.dtype``) and transposed there, and is copied into
    its slot, so the device never holds a second whole copy of the model.
    With ``config.quant="int8"`` each matmul weight is quantized in its
    slot as it is filled (``quantize_tensor`` on the cast values, so the
    result is bit-equal to ``quantize_params`` of the dense tree), and the
    dense weights are never made whole. Tied embeddings
    (``config.tie_word_embeddings``) read no ``lm_head.weight``."""
    _check_supported(config)
    c = config
    dt = dtype if isinstance(dtype, torch.dtype) else torch_dtype(
        c.dtype if dtype is None else str(dtype))
    dev = torch.device(device)
    quant8 = c.quant == "int8"
    shapes = _leaf_shapes(c)
    L = c.num_layers

    def alloc(name: str, stacked: bool):
        shape = ((L,) if stacked else ()) + shapes[name]
        if quant8 and name in _QUANT_AXIS:
            axis = _QUANT_AXIS[name]
            s_shape = shape[:len(shape) + axis] + shape[len(shape) + axis + 1:]
            return {"q": torch.empty(shape, dtype=torch.int8, device=dev),
                    "s": torch.empty(s_shape, dtype=torch.float32,
                                     device=dev)}
        return torch.empty(shape, dtype=dt, device=dev)

    def fill(hf_name: str, name: str, transpose: bool, dst, l=None):
        if hf_name not in raw:
            raise KeyError(f"checkpoint has no tensor {hf_name!r}")
        src = raw[hf_name]
        if not isinstance(src, torch.Tensor):
            a = np.asarray(src)
            src = (torch.from_numpy(a) if a.flags.writeable
                   and a.dtype.name != "bfloat16"
                   else _tensor_from_numpy(a, "cpu"))
        want = shapes[name][::-1] if transpose else shapes[name]
        if tuple(src.shape) != want:
            raise ValueError(f"tensor {hf_name!r} has shape "
                             f"{tuple(src.shape)}, the config needs {want}")
        x = src.to(dev).to(dt)
        if transpose:
            x = x.T
        if isinstance(dst, dict):
            q = quantize_tensor(x, _QUANT_AXIS[name])
            for k in ("q", "s"):
                (dst[k] if l is None else dst[k][l]).copy_(q[k])
        else:
            (dst if l is None else dst[l]).copy_(x)

    layers = {}
    for suffix, (name, transpose) in _HF_LAYER_MAP.items():
        layers[name] = alloc(name, True)
        for l in range(L):
            fill(f"model.layers.{l}.{suffix}", name, transpose, layers[name],
                 l)
    params: Params = {"embed": alloc("embed", False), "layers": layers,
                      "norm_f": alloc("norm_f", False)}
    fill("model.embed_tokens.weight", "embed", False, params["embed"])
    fill("model.norm.weight", "norm_f", False, params["norm_f"])
    if not c.tie_word_embeddings:
        params["lm_head"] = alloc("lm_head", False)
        fill("lm_head.weight", "lm_head", True, params["lm_head"])
    return params


def load_hf_params(config: ModelConfig, model_dir: str, dtype=None,
                   device: str | torch.device = "cuda") -> Params:
    """Load Llama weights from an HF safetensors directory (the JAX
    package's ``load_hf_params``; sharded checkpoints through
    ``model.safetensors.index.json``) onto ``device``, quantized at load
    under ``config.quant="int8"`` (``params_from_state_dict``).

    At its peak the host holds the checkpoint's mapped pages (the page
    cache, shared and evictable: each tensor is a view of a private mmap,
    copied straight to the device) and no second copy; the device holds
    the parameter tree plus one source matrix in flight."""
    from dynamo_tpu_torch.safetensors_io import Checkpoint

    return params_from_state_dict(config, Checkpoint(model_dir), dtype,
                                  device)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a dense or quantized weight (a layer product: the result
    in x's dtype)."""
    if _is_quant(w):
        return w8a16_matmul(x, w, x.dtype)
    return x @ w


# ---------------------------------------------------------------------------
# Resident LoRA adapters (tenancy/adapters.py builds the bank)
#
# Adapter 0 is all zeros: its delta is exactly 0.0, so the base model's
# outputs are unchanged. An adapted site's ``ab`` is (a, b): 2-D factors
# ([d_in, r], [r, d_out]) shared by every row, or 3-D ones ([G, d_in, r],
# [G, r, d_out]), one pair a group of rows (a decode slot: one row; a
# batched-prefill chunk: its T rows).

def _lora_delta(x: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Rank-r LoRA delta for x [N, d_in], the factors cast to x's dtype
    as the reference casts them."""
    a = a.to(x.dtype)
    b = b.to(x.dtype)
    if a.dim() == 2:
        return (x @ a) @ b
    g = a.shape[0]
    t = torch.bmm(x.reshape(g, -1, x.shape[-1]), a)
    return torch.bmm(t, b).view(x.shape[0], -1)


def _mm_ad(x: torch.Tensor, w, ab) -> torch.Tensor:
    """x @ w plus the site's adapter delta (``ab`` = (a, b) or None)."""
    y = _mm(x, w)
    if ab is not None:
        y = y + _lora_delta(x, ab[0], ab[1])
    return y


def _index_tensor(ids: list[int], device) -> torch.Tensor:
    """Host ids as an index tensor on ``device`` without a stream sync
    (pinned staging on the card)."""
    t = torch.tensor(ids, dtype=torch.int64)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def gather_adapters(bank: Optional[Params],
                    ids) -> Optional[dict[str, tuple]]:
    """Each site's factor rows by adapter id (the reference's
    ``_gather_adapters``): an int yields per-site ([L, d_in, r], [L, r,
    d_out]) views; a host list or a device tensor of ids, [G, L, d_in,
    r] and [G, L, r, d_out] gathered copies. None without a bank or ids,
    and for host ids that are all 0 (the identity: no delta)."""
    if bank is None or ids is None:
        return None
    if isinstance(ids, int):
        if ids == 0:
            return None
        return {s: (ab["a"][ids], ab["b"][ids]) for s, ab in bank.items()}
    if not isinstance(ids, torch.Tensor):
        if not any(ids):
            return None
        ids = _index_tensor(list(ids), next(iter(bank.values()))["a"].device)
    return {s: (ab["a"].index_select(0, ids), ab["b"].index_select(0, ids))
            for s, ab in bank.items()}


def _adapter_layer(gathered: Optional[dict], l: int,
                   per_row: bool) -> Optional[dict]:
    """Layer-l (a, b) slices of a gathered bank, keyed by site: the ``ad``
    argument of _layer_body. None stays None."""
    if gathered is None:
        return None
    if per_row:
        return {s: (a[:, l], b[:, l]) for s, (a, b) in gathered.items()}
    return {s: (a[l], b[l]) for s, (a, b) in gathered.items()}


# ---------------------------------------------------------------------------
# Serving state

def init_cache(config: ModelConfig, num_pages: int, page_size: int,
               dtype: torch.dtype, device="cuda",
               kv_quant: str = "none") -> Cache:
    """Paged KV pool — prefix-cache STORAGE. Page 0 is the reserved
    scratch page for padded pool I/O. With ``kv_quant="int8"`` the pool
    holds int8 pages plus per-(layer, page) absmax scales
    ``k_scale``/``v_scale`` f32 [L, num_pages]."""
    c = config
    shape = (c.num_layers, c.num_kv_heads, num_pages, page_size, c.head_dim)
    if kv_quant == "int8":
        sc = (c.num_layers, num_pages)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sc, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sc, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_is_quantized(cache: Cache) -> bool:
    return "k_scale" in cache


def init_ctx(config: ModelConfig, batch: int, ctx_len: int,
             dtype: torch.dtype, device="cuda", kv_quant: str = "none",
             group: int = 128) -> Cache:
    """Contiguous per-slot serving context ``[L, kvh, batch+1, S, hd]``.
    Lane `batch` is the scratch lane for freed slots' garbage steps.

    With ``kv_quant="int8"`` the region is int8 plus per-(layer, lane,
    position-group) f32 absmax scales ``k_scale``/``v_scale``
    [L, batch+1, S/group]. ``group`` must be the engine's page_size so
    that pool<->ctx copies are raw int8 page moves; S is padded up to a
    multiple of it."""
    c = config
    shape = (c.num_layers, c.num_kv_heads, batch + 1, ctx_len, c.head_dim)
    if kv_quant == "int8":
        S = -(-ctx_len // group) * group
        shape = shape[:3] + (S,) + shape[4:]
        sc = (c.num_layers, batch + 1, S // group)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sc, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sc, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def ctx_is_quantized(ctx: Cache) -> bool:
    return "k_scale" in ctx


def ctx_group_size(ctx: Cache) -> int:
    """Position-group width of the int8 ctx scale grid."""
    return ctx["k"].shape[3] // ctx["k_scale"].shape[2]


def _ctx_compute_dtype(config: ModelConfig, ctx: Cache) -> torch.dtype:
    """Dtype activations and attention run in. A dense region doubles as
    the compute-dtype carrier; an int8 one cannot, so quantized mode
    computes in the model dtype."""
    if ctx_is_quantized(ctx):
        return torch_dtype(config.dtype)
    return ctx["k"].dtype


def _ctx_slot_slab(ctx: Cache, name: str, l: int, slot: int,
                   dtype: torch.dtype, span: int = 0) -> torch.Tensor:
    """One slot's [kvh, S, hd] ctx slab in the compute dtype, dequantized
    on read when the region is int8 (prefill reads; the decode kernel
    dequantizes itself)."""
    slab = ctx[name][l, :, slot]                       # [kvh, S, hd]
    if span > 0:
        slab = slab[:, :span]
    if not ctx_is_quantized(ctx):
        return slab
    sc = ctx[name + "_scale"][l, slot].repeat_interleave(
        ctx_group_size(ctx))                           # [S] per position
    if span > 0:
        sc = sc[:span]
    return (slab.float() * sc[None, :, None]).to(dtype)


def _quant_store_span(
    buf: torch.Tensor,     # int8 [L, kvh, lanes, S, hd] — updated IN PLACE
    scale: torch.Tensor,   # f32 [L, lanes, nG] — updated IN PLACE
    slot: int,
    start: int,            # span start position
    span: torch.Tensor,    # float [L, kvh, T, hd] — new KV rows
    group: int,
    valid_t=None,          # leading span rows that are REAL (the rest
                           # is bucket padding): an int, or a 0-d device
                           # tensor (a tree commit's n_out, never synced)
) -> None:
    """Quantize-on-store of a contiguous span into one slot's int8 ctx.

    Works on the minimal group-aligned window covering [start, start+T):
    gather window -> dequant -> overlay span -> requantize with fresh
    absmax scales for the overlapped groups (absmax over the request's
    own prefix + the span ONLY — stale suffix bytes from a previous
    occupant never feed a scale; kv_quant.requantize_groups). The span
    lands where the JAX version's dynamic_update_slice puts it (its
    offset clamped into the window)."""
    nG = scale.shape[2]
    T = span.shape[2]
    nW = min((T + group - 1) // group + 1, nG)
    W = nW * group
    g0 = min(max(start // group, 0), nG - nW)
    off = start - g0 * group
    lo = g0 * group
    dev = buf.device
    win = buf[:, :, slot, lo:lo + W][:, :, None]       # [L, kvh, 1, W, hd]
    sw = scale[:, slot:slot + 1, g0:g0 + nW]           # [L, 1, nW]
    wf = dequantize_groups(win, sw, group)
    at = min(max(off, 0), W - T)
    wf[:, :, 0, at:at + T] = span.float()
    if valid_t is None:
        vt = T
    elif isinstance(valid_t, torch.Tensor):
        vt = valid_t.clamp(0, T)
    else:
        vt = min(max(valid_t, 0), T)
    valid = (torch.arange(W, device=dev) < off + vt)[None]
    j = torch.arange(nW, device=dev)
    written = (((j + 1) * group > off) & (j * group < off + vt))[None]
    q, s_new = requantize_groups(wf, sw, valid, written, group)
    buf[:, :, slot, lo:lo + W] = q[:, :, 0]
    scale[:, slot, g0:g0 + nW] = s_new[:, 0]


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
    return {k: ({n: t[l] for n, t in v.items()} if _is_quant(v) else v[l])
            for k, v in params["layers"].items()}


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
    """Embedding gather for dense or quantized embed tables."""
    e = params["embed"]
    if _is_quant(e):
        return e["q"][tokens].to(dtype) * e["s"][tokens][..., None].to(dtype)
    return e[tokens].to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _mlp(h, wg, wu, wd, ad=None):
    ad = ad or {}
    gate = _mm_ad(h, wg, ad.get("wg"))
    up = _mm_ad(h, wu, ad.get("wu"))
    return _mm_ad(F.silu(gate) * up, wd, ad.get("wd"))


def _layer_body(c: ModelConfig, lp: Params, h: torch.Tensor, cos, sin,
                write_kv: Callable, attend: Callable,
                ad: Optional[dict] = None) -> torch.Tensor:
    """Shared decoder-layer body for prefill and decode. ``write_kv(k, v)``
    stores the new KV and returns what ``attend(q, kv)`` reads; h is
    [N, H] (N = padded tokens for prefill, batch slots for decode).
    ``ad`` is the layer's adapter factors (``_adapter_layer``) or None:
    each adapted product adds its rank-r delta."""
    N = h.shape[0]
    ad = ad or {}
    x = rms_norm(h, lp["ln1"], c.rms_norm_eps)
    q = _mm_ad(x, lp["wq"], ad.get("wq")).view(N, c.num_heads, c.head_dim)
    k = _mm_ad(x, lp["wk"], ad.get("wk")).view(N, c.num_kv_heads,
                                               c.head_dim)
    v = _mm_ad(x, lp["wv"], ad.get("wv")).view(N, c.num_kv_heads,
                                               c.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, write_kv(k, v))
    h = h + _mm_ad(attn.reshape(N, c.q_dim), lp["wo"], ad.get("wo"))
    x2 = rms_norm(h, lp["ln2"], c.rms_norm_eps)
    return h + _mlp(x2, lp["wg"], lp["wu"], lp["wd"], ad)


def matmul_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h [..., H] @ w [H, V]`` accumulated and returned in f32, never
    rounded to h's dtype (the reference's ``preferred_element_type=f32``).
    A bf16 product on the card is one cuBLAS call with an f32 output
    (``aten::mm.dtype``), so no f32 copy of the [H, V] matrix is made; the
    CPU, which lacks that overload, widens both operands."""
    if h.dtype == torch.float32 and w.dtype == torch.float32:
        return h @ w
    if not h.is_cuda:
        return h.float() @ w.float()
    y = torch.mm(h.reshape(-1, h.shape[-1]), w, out_dtype=torch.float32)
    return y.view(*h.shape[:-1], w.shape[-1])


def _logits(config: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """f32 logits ``[..., V]``: for a quantized weight through the w8a16
    kernel (the tied embedding table read as ``[V, H]``), for a dense one
    an f32-accumulated product."""
    h = rms_norm(h, params["norm_f"], config.rms_norm_eps)
    tied = config.tie_word_embeddings
    w = params["embed"] if tied else params["lm_head"]
    if _is_quant(w):
        return w8a16_matmul(h, w, torch.float32, "nk" if tied else "kn")
    return matmul_f32(h, w.t() if tied else w)


# ---------------------------------------------------------------------------
# Prefill

def prefill(
    config: ModelConfig,
    params: Params,
    ctx: Cache,
    tokens: torch.Tensor,  # [T] int, bucket-padded
    slot: int,             # destination slot lane
    q_start: int,          # tokens already in the region
    seq_len: int,          # total valid context length
    adapter_id: int = 0,   # resident LoRA bank row (0 = the base model)
) -> torch.Tensor:
    """Prefill of one request (the JAX version's ``prefill_impl``): T new
    tokens through the model, their KV written into the slot's region at
    [q_start, q_start+T) IN PLACE after the last read. Attention is one
    dense causal softmax over the slot's whole region plus the chunk
    (``ctx_prefill_attention``). Returns the logits [V] (f32) of the last
    valid token (position seq_len-1)."""
    _check_supported(config)
    c = config
    T = tokens.shape[0]
    dev = tokens.device
    positions = q_start + torch.arange(T, device=dev)
    cos, sin = rope_cos_sin(positions, _inv_freq(c, dev))
    cdt = _ctx_compute_dtype(c, ctx)
    h = _embed_rows(params, tokens, cdt)
    ag = gather_adapters(params.get("adapters"), int(adapter_id))
    new_ks: list[torch.Tensor] = []
    new_vs: list[torch.Tensor] = []
    for l in range(c.num_layers):
        def write_kv(k, v):
            new_ks.append(k)
            new_vs.append(v)
            return k, v

        def attend(q, kv, l=l):
            k_new, v_new = kv
            return ctx_prefill_attention(
                q, _ctx_slot_slab(ctx, "k", l, slot, cdt),
                _ctx_slot_slab(ctx, "v", l, slot, cdt),
                k_new, v_new, q_start, seq_len)

        h = _layer_body(c, _layer(params, l), h, cos, sin, write_kv, attend,
                        _adapter_layer(ag, l, per_row=False))
    # tail: one span write per buffer (all reads are done)
    upd_k = torch.stack(new_ks).transpose(1, 2)        # [L, kvh, T, hd]
    upd_v = torch.stack(new_vs).transpose(1, 2)
    if ctx_is_quantized(ctx):
        g = ctx_group_size(ctx)
        for name, upd in (("k", upd_k), ("v", upd_v)):
            _quant_store_span(ctx[name], ctx[name + "_scale"], slot, q_start,
                              upd, g, valid_t=seq_len - q_start)
    else:
        S = ctx["k"].shape[3]
        st = min(max(q_start, 0), S - T)
        for name, upd in (("k", upd_k), ("v", upd_v)):
            ctx[name][:, :, slot, st:st + T] = upd.to(ctx[name].dtype)
    return _logits(c, params, h[seq_len - q_start - 1])


def _batch_forward(
    config: ModelConfig,
    params: Params,
    ctx: Cache,
    tokens: torch.Tensor,  # [K, T] int, bucket-padded per request
    slots: list[int],
    q_starts: list[int],
    seq_lens: list[int],
    ctx_span: int,
    depths: Optional[torch.Tensor] = None,       # [K, T] tree depths
                           # (RoPE position q_start + depth; -1 padding)
    chunk_masks: Optional[torch.Tensor] = None,  # [K, T, T] bool tree-
                           # causal in-chunk visibility
    adapter_ids: Optional[list[int]] = None,     # [K] bank rows
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Read-only layer stack of batch_prefill: K chunks through the model
    at once (the JAX version's vmap is the batch dimension here: matmuls
    see [K*T, H] rows, attention runs per request). Returns (ks, vs, h):
    per-layer KV [K, L, T, kvh, hd] and final hidden states [K, T, H].

    Tree mode (``depths`` and ``chunk_masks``, always together): each
    chunk is a packed token tree, not a linear run. Node t sits at RoPE
    position q_start + depths[t] (siblings at one depth share it; a
    padding node, depth -1, pins to q_start) and attends the chunk by
    its row of ``chunk_masks`` instead of by index order. Tree chunks never
    carry adapters (speculation is confined to the base model)."""
    c = config
    K, T = tokens.shape
    dev = tokens.device
    # each row's factors, gathered once for every layer ([K, L, d, r])
    ag = gather_adapters(params.get("adapters"), adapter_ids)
    if depths is not None:
        assert ag is None, "tree chunks are base-model only"
    # built on the device: a host list copied over would sync the stream
    if depths is None:
        positions = torch.cat([torch.arange(q, q + T, device=dev)
                               for q in q_starts])
    else:
        positions = torch.cat([depths[i].clamp(min=0) + q
                               for i, q in enumerate(q_starts)])
    cos, sin = rope_cos_sin(positions, _inv_freq(c, dev))
    cdt = _ctx_compute_dtype(c, ctx)
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
                    k_ctx = _ctx_slot_slab(ctx, "k", l, slots[i], cdt,
                                           ctx_span)
                    v_ctx = _ctx_slot_slab(ctx, "v", l, slots[i], cdt,
                                           ctx_span)
                else:
                    k_ctx = v_ctx = None
                outs.append(flash_prefill_attention(
                    q[rows], k_ctx, v_ctx, k_new[rows], v_new[rows],
                    q_starts[i], seq_lens[i],
                    chunk_mask=(None if chunk_masks is None
                                else chunk_masks[i])))
            return torch.cat(outs)

        h = _layer_body(c, _layer(params, l), h, cos, sin, write_kv, attend,
                        _adapter_layer(ag, l, per_row=True))
    L, kvh, hd = c.num_layers, c.num_kv_heads, c.head_dim
    ks = torch.stack(new_ks).to(cdt).view(L, K, T, kvh, hd).transpose(0, 1)
    vs = torch.stack(new_vs).to(cdt).view(L, K, T, kvh, hd).transpose(0, 1)
    return ks, vs, h.view(K, T, -1)


def _write_chunks(ctx: Cache, ks: torch.Tensor, vs: torch.Tensor,
                  slots: list[int], q_starts: list[int],
                  seq_lens: Optional[list] = None) -> None:
    """Tail pass, after every read: each chunk's KV [L, kvh, T, hd] lands
    at [q_start, q_start+T) of its slot's region, in place. The start is
    clamped into [0, S-T] as the JAX version's dynamic_update_slice
    clamps it. An int8 region takes each span through the group
    requantize window instead, with only the rows below ``seq_lens``
    feeding its scales (ints, or 0-d device tensors: a tree commit's
    lengths, known only on the device)."""
    S = ctx["k"].shape[3]
    T = ks.shape[2]
    if ctx_is_quantized(ctx):
        g = ctx_group_size(ctx)
        for i in range(ks.shape[0]):
            vt = None if seq_lens is None else seq_lens[i] - q_starts[i]
            for name, kv in (("k", ks), ("v", vs)):
                _quant_store_span(ctx[name], ctx[name + "_scale"], slots[i],
                                  q_starts[i], kv[i].transpose(1, 2), g,
                                  valid_t=vt)
        return
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
    adapter_ids: Optional[list[int]] = None,  # [K] resident LoRA bank
                           # rows (0 = identity; dummies 0)
) -> torch.Tensor:
    """Batched multi-request prefill: K chunks through the model together,
    each chunk's KV written into its slot's region at [q_start,
    q_start+T) IN PLACE after the last read. Returns logits [K, V] (f32)
    of each row's last valid token. Padding lanes point at the scratch
    lane with seq_len 0."""
    _check_supported(config)
    ks, vs, h = _batch_forward(config, params, ctx, tokens, slots, q_starts,
                               seq_lens, ctx_span, adapter_ids=adapter_ids)
    _write_chunks(ctx, ks, vs, slots, q_starts, seq_lens)
    last = [max(s - q - 1, 0) for s, q in zip(seq_lens, q_starts)]
    h_last = torch.stack([h[i, t] for i, t in enumerate(last)])
    return _logits(config, params, h_last)


# the key block of flash_prefill_attention: spans cut on its boundaries
# leave every block that can hold a visible key as it was
SPAN_BLOCK = 256


def spec_span(max_q_start: int, max_context: int) -> int:
    """The prior-context window of a verify or draft forward: the longest
    q_start of the batch rounded up to the attention's key block, at most
    the region. The JAX version reads the whole region (``max_context``);
    keys at or past a row's q_start are masked, so the blocks left out
    would add exact zeros to the running softmax and the result is the
    same bit for bit."""
    return min(max_context, -(-max_q_start // SPAN_BLOCK) * SPAN_BLOCK)


def batch_score(
    config: ModelConfig,
    params: Params,
    ctx: Cache,
    tokens: torch.Tensor,  # [K, T] int — T = pending + proposed tokens
    slots: list[int],
    q_starts: list[int],   # tokens already in each region
    seq_lens: list[int],   # q_start + T
    ctx_span: int,         # prior-context window (> 0 here)
) -> torch.Tensor:
    """Speculative-verification scorer (the JAX version's
    ``batch_score_impl``): batch_prefill's forward and its optimistic KV
    tail write IN PLACE, returning logits for EVERY chunk row [K, T, V]
    (f32). Row t scores the token following tokens[:, t]. The rows
    written for tokens rejected later are dead weight past the committed
    length: attention masks by seq_len and the next write over the lane
    overwrites them, so rollback is pointer truncation."""
    _check_supported(config)
    ks, vs, h = _batch_forward(config, params, ctx, tokens, slots, q_starts,
                               seq_lens, ctx_span)
    _write_chunks(ctx, ks, vs, slots, q_starts, seq_lens)
    K, T, H = h.shape
    return _logits(config, params, h.reshape(K * T, H)).view(K, T, -1)


def batch_score_tree(
    config: ModelConfig,
    params: Params,
    ctx: Cache,
    tokens: torch.Tensor,       # [B, T] int packed tree (node 0 = pending)
    slots: list[int],
    q_starts: list[int],        # tokens already in each region
    seq_lens: list[int],        # q_start + T
    depths: torch.Tensor,       # [B, T] node depths (-1 = padding)
    chunk_masks: torch.Tensor,  # [B, T, T] bool ancestor-or-self
    ctx_span: int,              # prior-context window (> 0 here)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tree-verification scorer (the JAX version's
    ``batch_score_tree_impl``): one batched forward over a packed token
    tree a row, RoPE by node depth and in-chunk attention by the ancestor
    mask, returning (ks, vs, logits): the chunk's KV [B, L, T, kvh, hd]
    and logits for every node [B, T, V] (f32). Row t scores the token
    following node t's root-to-node path.

    It writes nothing into the region: siblings share a RoPE position, so
    a linear tail write would land sibling KV in rows the accepted path
    must own. The caller accepts on the device and commits the path's
    rows with commit_tree_path."""
    _check_supported(config)
    ks, vs, h = _batch_forward(config, params, ctx, tokens, slots, q_starts,
                               seq_lens, ctx_span, depths, chunk_masks)
    K, T, H = h.shape
    return ks, vs, _logits(config, params, h.reshape(K * T, H)).view(K, T, -1)


def commit_tree_path(
    ctx: Cache,
    ks: torch.Tensor,          # [B, L, T, kvh, hd] from batch_score_tree
    vs: torch.Tensor,
    path: torch.Tensor,        # [B, T] accepted node index per output
                               # position (path[:, 0] == 0, the pending
                               # token; entries past n_out are dead)
    slots: list[int],
    q_starts: list[int],
    commit_lens: list,         # q_start + n_out a row (0-d device tensors)
) -> None:
    """Commit only the accepted root-to-leaf path's KV rows, IN PLACE:
    the chunk's KV reordered by the path's node indices (sibling rows are
    never gathered) and span-written at [q_start, q_start+T). Rows past
    n_out gather clamped garbage but stay dead: attention masks by
    sequence length, an int8 region's scales take only the rows below
    ``commit_lens``, and the next round writes from there. So a tree's
    rollback stays pointer truncation."""
    B, L, T, kvh, hd = ks.shape
    idx = path.clamp(0, T - 1)[:, None, :, None, None].expand(
        B, L, T, kvh, hd)
    _write_chunks(ctx, ks.gather(2, idx), vs.gather(2, idx), slots,
                  q_starts, commit_lens)


def _top_m(logits: torch.Tensor, m: int) -> torch.Tensor:
    """[B, m] vocab ids of each row's m largest logits in ``jax.lax.top_k``'s
    order: value descending, the lower index first among equal values,
    also where a tie straddles the m-th place (``torch.topk`` promises no
    order among ties, so a stable sort of the whole row). Column 0 is the
    argmax, the linear draft's token."""
    return torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[:, :m]


def batch_draft(
    config: ModelConfig,
    params: Params,
    ctx: Cache,
    tokens: torch.Tensor,  # [B, T] int — each slot's history catch-up chunk
    slots: list[int],
    q_starts: list[int],   # draft KV already in each region
    seq_lens: list[int],   # q_start + the chunk's real length
    ctx_span: int,         # prior-context window, covering every step
    k: int,                # draft depth
    m: int = 1,            # branches a level (comb tree; 1 = the chain)
) -> torch.Tensor:
    """Draft ``k`` greedy tokens for every row (the JAX version's
    ``batch_draft_impl``): the catch-up chunk runs as a batch_prefill
    forward, then k-1 batched single-token steps with argmax feedback,
    all queued on the device with no host sync between them. Returns
    drafted [B, k] (int64, on the device).

    KV bookkeeping: the chunk lands at [q_start, seq_len), step s writes
    at seq_len + s, and the last drafted token's KV is never computed (it
    is never fed back).

    ``m > 1`` drafts a comb tree: every level records its top-m tokens,
    but only the top-1 spine feeds back (and owns the KV written at
    seq_len + s). Returns [B, k*m] in level-major node order: level s in
    columns [s*m, s*m + m), column s*m the spine (spec/proposer.py
    comb_parents gives the parent pointers)."""
    _check_supported(config)

    def pick(logits):
        if m == 1:
            return torch.argmax(logits, dim=-1)[:, None]
        return _top_m(logits, m)

    ks, vs, h = _batch_forward(config, params, ctx, tokens, slots, q_starts,
                               seq_lens, ctx_span)
    _write_chunks(ctx, ks, vs, slots, q_starts, seq_lens)
    last = [max(s - q - 1, 0) for s, q in zip(seq_lens, q_starts)]
    h_last = torch.stack([h[i, t] for i, t in enumerate(last)])
    drafted = [pick(_logits(config, params, h_last))]
    for s in range(k - 1):
        pos = [sl + s for sl in seq_lens]
        sl = [p + 1 for p in pos]
        # level s's spine (column 0 of its m) is fed back
        ks, vs, h = _batch_forward(config, params, ctx, drafted[-1][:, :1],
                                   slots, pos, sl, ctx_span)
        _write_chunks(ctx, ks, vs, slots, pos, sl)
        drafted.append(pick(_logits(config, params, h[:, 0])))
    return torch.cat(drafted, dim=1)


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
    adapter_ids: Optional[torch.Tensor] = None,  # [B] per-slot resident
                               # LoRA bank rows (0 = identity)
    gathered: Optional[dict] = None,  # gather_adapters(bank, adapter_ids),
                               # made once by the caller for a round
) -> torch.Tensor:
    """One decode step for all slots; returns logits [B, V] (f32). Each
    layer's new KV goes into ring slot ``ring_pos`` BEFORE attention (its
    position is ``ctx-1 == ring_base + ring_pos`` for live slots);
    attention reads the ctx region below ring_base plus the ring (an int8
    region through the kernel's int8 mode). With a bank, each slot's
    products add its adapter's delta: mixed ids run in one step, the rows
    gathered by the device ids (``gathered``, else here)."""
    c = config
    ag = gathered
    if ag is None:
        ag = gather_adapters(params.get("adapters"), adapter_ids)
    positions = torch.clamp(ctx_lens - 1, min=0)
    cos, sin = rope_cos_sin(positions, _inv_freq(c, tokens.device))
    h = _embed_rows(params, tokens, _ctx_compute_dtype(c, ctx))    # [B, H]
    quant = ctx_is_quantized(ctx)
    for l in range(c.num_layers):
        def write_kv(k, v, l=l):
            # [B, kvh, hd] -> ring[l, :, :, ring_pos, :]
            ring["k"][l, :, :, ring_pos] = k.transpose(0, 1)
            ring["v"][l, :, :, ring_pos] = v.transpose(0, 1)
            return ring

        def attend(q, ring, l=l):
            return ctx_decode_attention(
                q, ctx["k"], ctx["v"], ring["k"], ring["v"], l,
                ctx_lens, ring_base,
                ctx["k_scale"] if quant else None,
                ctx["v_scale"] if quant else None)

        h = _layer_body(c, _layer(params, l), h, cos, sin, write_kv, attend,
                        _adapter_layer(ag, l, per_row=True))
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
    lane (position 0 there: garbage by contract). An int8 region is
    requantized window by window instead (``_flush_ctx_quant``)."""
    L, kvh, B, R, hd = ring["k"].shape
    S = ctx["k"].shape[3]
    scratch = ctx["k"].shape[2] - 1
    dev = dest.device
    r_idx = torch.arange(R, device=dev)[None, :]              # [1, R]
    pos = ring_base.long()[:, None] + r_idx                   # [B, R]
    valid = (r_idx < valid_len.long()[:, None]) & (pos < S)
    if ctx_is_quantized(ctx):
        _flush_ctx_quant(ctx, ring, dest, ring_base, valid_len, valid)
        return
    lane = torch.where(valid, dest.long()[:, None], scratch).reshape(-1)
    pos = torch.where(valid, pos, 0).reshape(-1)
    for name in ("k", "v"):
        # advanced indices on dims 2, 3: target [L, kvh, B*R, hd]
        ctx[name][:, :, lane, pos] = ring[name].reshape(L, kvh, B * R, hd)


def _flush_ctx_quant(
    ctx: Cache,
    ring: Cache,
    dest: torch.Tensor,       # [B] int (freed slots -> scratch lane)
    ring_base: torch.Tensor,  # [B] int
    valid_len: torch.Tensor,  # [B] int
    valid: torch.Tensor,      # [B, R] bool — precomputed entry validity
) -> None:
    """Ring flush into an int8 ctx region, IN PLACE: each lane's minimal
    group-aligned window around its ring span is gathered, dequantized,
    overlaid with the valid ring entries (invalid ones are DROPPED, not
    redirected), requantized with fresh absmax scales for the groups the
    span overlaps (over the lane's own prefix + the new entries, never
    stale suffix bytes) and scattered back with its scales. Vacated lanes
    all alias the scratch lane, so their windows overlap and write
    garbage over garbage (scratch is garbage by contract; which of the
    duplicate writes lands is unspecified on CUDA)."""
    L, kvh, B, R, hd = ring["k"].shape
    lanes, S = ctx["k"].shape[2], ctx["k"].shape[3]
    g = ctx_group_size(ctx)
    nG = S // g
    dev = dest.device
    # window: enough group slots to hold a ring span at any alignment
    nW = min(-(-R // g) + 1, nG)
    W = nW * g
    base = torch.clamp(ring_base.long(), 0, S)
    g0 = torch.clamp(base // g, 0, nG - nW)                    # [B]
    lane = torch.clamp(dest.long(), 0, lanes - 1)              # [B]
    off = base - g0 * g                                        # [B]
    # the ring entry each window position takes, if any: position w of
    # lane b holds ring entry w - off[b] (distinct per w, so a gather and
    # a select do what the JAX version's dropping scatter does)
    w_idx = torch.arange(W, device=dev)[None, :]               # [1, W]
    r_of_w = w_idx - off[:, None]                              # [B, W]
    r_c = torch.clamp(r_of_w, 0, R - 1)
    take = (r_of_w >= 0) & (r_of_w < R) & valid.gather(1, r_c)
    # absmax inputs: the lane's own prefix + the new valid entries
    span_end = off + torch.clamp(valid_len.long(), 0, R)
    valid_w = w_idx < span_end[:, None]                        # [B, W]
    j = torch.arange(nW, device=dev)[None, :]
    written = (((j + 1) * g > off[:, None]) & (j * g < span_end[:, None])
               & (valid_len > 0)[:, None])                     # [B, nW]
    widx = ((lane * S + g0 * g)[:, None] + w_idx).reshape(-1)  # [B*W]
    gidx = g0[:, None] + j                                     # [B, nW]
    r_gather = r_c[None, None, :, :, None].expand(L, kvh, B, W, hd)
    for name in ("k", "v"):
        flat = ctx[name].view(L, kvh, lanes * S, hd)
        win = flat[:, :, widx].reshape(L, kvh, B, W, hd)
        sw = ctx[name + "_scale"][:, lane[:, None], gidx]      # [L, B, nW]
        wf = dequantize_groups(win, sw, g)
        overlay = ring[name].float().gather(3, r_gather)       # [L,kvh,B,W,hd]
        wf = torch.where(take[None, None, :, :, None], overlay, wf)
        q, s_new = requantize_groups(wf, sw, valid_w, written, g)
        flat[:, :, widx] = q.reshape(L, kvh, B * W, hd)
        ctx[name + "_scale"][:, lane[:, None], gidx] = s_new


# ---------------------------------------------------------------------------
# prefix-cache <-> context copies (admission / block seal)

def _check_group(ctx: Cache, page_size: int) -> None:
    g = ctx_group_size(ctx)
    assert g == page_size, (
        f"int8 ctx group ({g}) must equal pool page_size ({page_size}) — "
        "init_ctx(group=page_size) is the engine contract")


def _quantize_pages_dev(pages: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(layer, page) absmax int8 of dense pages [L, kvh, n, ps, hd]:
    (int8 pages, f32 scales [L, n]), the reference's pool grid."""
    pf = pages.float()
    s = torch.clamp(pf.abs().amax(dim=(1, 3, 4)) / 127.0, min=SCALE_EPS)
    q = torch.clamp(torch.round(pf / s[:, None, :, None, None]),
                    -127, 127).to(torch.int8)
    return q, s


def load_ctx_pages(
    ctx: Cache,
    cache: Cache,
    slot: int,                # destination lane
    page_ids: torch.Tensor,   # [n] int — pow2-padded; padding = scratch 0
) -> None:
    """Copy a matched prefix run of pool pages into the slot's context
    region at [0, n*ps), in place. The page list is pow2-padded by the
    caller, so n*ps can exceed the region: the load is clamped to the
    region (only padding can overflow). An int8 pool into an int8 region
    is a raw page copy plus a scale copy (the scale grids coincide); a
    dense pool into an int8 region quantizes per page on the way in, and
    an int8 pool into a dense region dequantizes."""
    n = page_ids.shape[0]
    ps = cache["k"].shape[3]
    S = ctx["k"].shape[3]
    usable = min(n, S // ps)
    if usable <= 0:
        return
    page_ids = page_ids[:usable]
    pool_q = cache_is_quantized(cache)
    if ctx_is_quantized(ctx):
        _check_group(ctx, ps)
        for name in ("k", "v"):
            pages = cache[name][:, :, page_ids]   # [L, kvh, usable, ps, hd]
            if pool_q:
                q, sc = pages, cache[name + "_scale"][:, page_ids]
            else:
                q, sc = _quantize_pages_dev(pages)
            L, kvh, _, _, hd = q.shape
            ctx[name][:, :, slot, :usable * ps] = q.reshape(
                L, kvh, usable * ps, hd)
            ctx[name + "_scale"][:, slot, :usable] = sc
        return
    for name in ("k", "v"):
        pages = cache[name][:, :, page_ids]   # [L, kvh, usable, ps, hd]
        if pool_q:
            # dequantize in the same copy: int8 pages x per-(layer, page)
            # scale
            sc = cache[name + "_scale"][:, page_ids]          # [L, usable]
            pages = pages.float() * sc[:, None, :, None, None]
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
    page 0. An int8 region into an int8 pool moves the blocks and their
    scales verbatim (starts are block starts and group == page_size); an
    int8 region into a dense pool dequantizes them, and a dense region
    into an int8 pool quantizes each block with a per-(layer, page)
    absmax scale."""
    ps = page_size
    pool_q = cache_is_quantized(cache)
    ctx_q = ctx_is_quantized(ctx)
    if ctx_q:
        _check_group(ctx, ps)
    dst = pages.long()
    for name in ("k", "v"):
        src = ctx[name]
        L, kvh, lanes, S, hd = src.shape
        flat = src.view(L, kvh, lanes * S, hd)
        idx = ((slots.long() * S + starts.long())[:, None]
               + torch.arange(ps, device=src.device)[None, :])
        blocks = flat[:, :, idx]                  # [L, kvh, n, ps, hd]
        if ctx_q:
            sc = ctx[name + "_scale"][:, slots.long(), starts.long() // ps]
            if pool_q:
                cache[name][:, :, dst] = blocks
                cache[name + "_scale"][:, dst] = sc
            else:
                cache[name][:, :, dst] = (
                    blocks.float() * sc[:, None, :, None, None]
                ).to(cache[name].dtype)
        elif pool_q:
            q, sc = _quantize_pages_dev(blocks)
            cache[name][:, :, dst] = q
            cache[name + "_scale"][:, dst] = sc
        else:
            cache[name][:, :, dst] = blocks.to(cache[name].dtype)


# ---------------------------------------------------------------------------
# KV page export/import (the page-transfer plane's device ops; the pool
# is written IN PLACE: the round graphs captured its storage)

def gather_pages(cache: Cache, page_ids: torch.Tensor) -> torch.Tensor:
    """Whole pool pages, [2, L, kvh, n, ps, hd] (k then v)."""
    return torch.stack([cache["k"][:, :, page_ids],
                        cache["v"][:, :, page_ids]])


def scatter_pages(cache: Cache, page_ids: torch.Tensor,
                  data: torch.Tensor) -> None:
    """Write whole pages into the pool, in place (the inverse of
    gather_pages). Padding entries must point at scratch page 0."""
    cache["k"][:, :, page_ids] = data[0].to(cache["k"].dtype)
    cache["v"][:, :, page_ids] = data[1].to(cache["v"].dtype)


def gather_pages_q(cache: Cache, page_ids: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """gather_pages of an int8 pool: (int8 pages [2, L, kvh, n, ps, hd],
    scales [2, L, n])."""
    return gather_pages(cache, page_ids), torch.stack(
        [cache["k_scale"][:, page_ids], cache["v_scale"][:, page_ids]])


def scatter_pages_q(cache: Cache, page_ids: torch.Tensor,
                    data: torch.Tensor, scales: torch.Tensor) -> None:
    """The inverse of gather_pages_q, in place."""
    cache["k"][:, :, page_ids] = data[0]
    cache["v"][:, :, page_ids] = data[1]
    cache["k_scale"][:, page_ids] = scales[0]
    cache["v_scale"][:, page_ids] = scales[1]
