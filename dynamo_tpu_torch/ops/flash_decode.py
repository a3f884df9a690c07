"""Flash decode attention over the contiguous per-slot context plus the
per-round write ring.

Position semantics (as in the JAX package's ops/flash_decode.py):
``ctx_k[l, :, b, p]`` holds position p of slot b, valid while
``p < min(ring_base[b], ctx_lens[b])``; ``ring_k[l, :, b, r]`` holds
position ``ring_base[b] + r``, valid while ``< ctx_lens[b]`` (the current
token INCLUDED: the decode step writes its KV to the ring before it
attends).

Int8 mode (``ctx_k_scale``/``ctx_v_scale`` given): ctx K/V are int8 with
f32 absmax scales per (layer, lane, position group) ``[L, B(+1),
S/group]``; element p of a row is ``k_i8 * scale[l, b, p // group]``
computed in f32 and rounded to q's dtype before the products, as the JAX
kernel dequantizes each chunk in VMEM. The ring stays in q's dtype.

``flash_decode_attention`` launches the hand-written Hopper kernel in
``csrc/flash_decode.cu`` for CUDA tensors and runs the plain PyTorch
version for CPU tensors. In bf16 either mode is one launch whose
splits merge in a thread-block cluster (``cluster_splits``) and rounds
the probabilities to bf16 before P.V as the TPU kernel does; in f32
(the tiny model) either mode is a split launch and a combine launch
(``pick_splits``) over f32 scratch. ``launches`` counts dense-mode calls
that launched, ``launches_int8`` int8-mode ones; a launch replayed from
a CUDA graph passes no wrapper, and ``executed`` reads the count the
kernel keeps on the card, which sees it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30

# kernel launches since import (or since a caller reset them to 0)
launches = 0
launches_int8 = 0

# rows per tile: csrc Layout::kTile (bf16), kSplitTile (f32)
_TILE_ROWS = {torch.bfloat16: 64, torch.float32: 32}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernel is built for, per dtype (f32 hd 16 is the tiny model)
_HEAD_DIMS = {torch.bfloat16: (64, 128), torch.float32: (16, 64, 128)}
_MAX_G = 8
_SM_TARGET = 4 * 132  # split blocks to aim for: four per H100 SM
MAX_CLUSTER = 8  # portable thread-block cluster size (csrc kMaxCluster)


def flash_decode_attention_plain(
    q: torch.Tensor,          # [B, n_heads, hd]
    ctx_k: torch.Tensor,      # [L, kvh, B(+1), S, hd]
    ctx_v: torch.Tensor,
    ring_k: torch.Tensor,     # [L, kvh, B, R, hd]
    ring_v: torch.Tensor,
    layer: int,
    ctx_lens: torch.Tensor,   # [B] int32, INCLUDING the current token
    ring_base: torch.Tensor,  # [B] int32, position of ring slot 0
    ctx_k_scale: Optional[torch.Tensor] = None,  # f32 [L, B(+1), S//group]
    ctx_v_scale: Optional[torch.Tensor] = None,  # (int8 ctx_k/ctx_v)
    p_round: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version: a copy of the JAX package's
    ``flash_decode_attention_reference``. With scales, the int8 ctx is
    dequantized in f32 and rounded to q's dtype first. The reference
    rounds the normalized probabilities to V's dtype before P.V. With
    ``p_round``, the probabilities are rounded as the TPU kernel rounds
    them (dynamo_tpu/ops/flash_decode.py:154-161, over one chunk):
    exp(s - max) rounded to ``p_round`` before P.V, the f32 sum of the
    unrounded ones dividing after it."""
    B, n_heads, hd = q.shape
    S = ctx_k.shape[3]
    R = ring_k.shape[3]
    n_rep = n_heads // ctx_k.shape[1]
    kl, vl = ctx_k[layer][:, :B], ctx_v[layer][:, :B]   # [nkv, B, S, hd]
    if ctx_k_scale is not None:
        g = S // ctx_k_scale.shape[2]
        ks = ctx_k_scale[layer][:B].repeat_interleave(g, dim=1)  # [B, S]
        vs = ctx_v_scale[layer][:B].repeat_interleave(g, dim=1)
        kl = (kl.float() * ks[None, :, :, None]).to(q.dtype)
        vl = (vl.float() * vs[None, :, :, None]).to(q.dtype)
    k = kl.repeat_interleave(n_rep, dim=0)              # [nh, B, S, hd]
    v = vl.repeat_interleave(n_rep, dim=0)
    rk = ring_k[layer].repeat_interleave(n_rep, dim=0)  # [nh, B, R, hd]
    rv = ring_v[layer].repeat_interleave(n_rep, dim=0)
    k = torch.cat([k, rk], dim=2)                       # [nh, B, S+R, hd]
    v = torch.cat([v, rv], dim=2)
    scores = torch.einsum(
        "bnh,nbsh->bns", q.float(), k.float()) / (hd ** 0.5)
    dev = q.device
    ctx_pos = torch.arange(S, device=dev)[None, :]
    ctx_ok = ctx_pos < torch.minimum(ring_base, ctx_lens)[:, None]
    ring_pos = ring_base[:, None] + torch.arange(R, device=dev)[None, :]
    ring_ok = ring_pos < ctx_lens[:, None]
    mask = torch.cat([ctx_ok, ring_ok], dim=1)          # [B, S+R]
    scores = torch.where(mask[:, None, :], scores, NEG_INF)
    if p_round is None:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum(
            "bns,nbsh->bnh", probs.to(v.dtype).float(), v.float())
    else:
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        out = torch.einsum(
            "bns,nbsh->bnh", e.to(p_round).float(), v.float()
        ) / e.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def pick_splits(batch: int, kv_heads: int, S: int, tile: int) -> int:
    """Context splits per (slot, KV head): enough blocks to cover the SMs
    several times over, never more splits than tiles in the region."""
    want = -(-_SM_TARGET // max(1, batch * kv_heads))
    return max(1, min(want, -(-S // tile)))


def cluster_splits(batch: int, kv_heads: int, S: int, tile: int,
                   resident: Optional[dict] = None) -> int:
    """Context splits per (slot, KV head) for the bf16 kernel, whose
    splits and ring block form one thread-block cluster: ``pick_splits``
    capped so that splits + 1 stays within the portable cluster size.
    Given ``resident`` (cluster size -> clusters the card holds at once),
    the splits drop until all batch * kv_heads clusters fit at once: a
    cluster left for a second wave doubles the call."""
    n = min(pick_splits(batch, kv_heads, S, tile), MAX_CLUSTER - 1)
    while resident and n > 1 and resident.get(n + 1, 0) < batch * kv_heads:
        n -= 1
    return n


# (device, int8 mode, head_dim) -> {cluster size: clusters held}
_resident: dict = {}


def _cluster_residency(lib, device: torch.device, quant: bool,
                       hd: int) -> dict:
    """How many clusters of each size of the bf16 kernel of this mode and
    head dim the card holds at once (cudaOccupancyMaxActiveClusters),
    asked once: the modes' blocks differ in shared memory."""
    key = (device.index, bool(quant), hd)
    if key not in _resident:
        fn = lib.flash_decode_max_active_clusters
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            got = {n: fn(int(quant), hd, n)
                   for n in range(2, MAX_CLUSTER + 1)}
        if min(got.values()) < 0:
            raise RuntimeError(
                "flash_decode: the card's cluster occupancy query failed")
        _resident[key] = got
    return _resident[key]


def context_splits(dtype: torch.dtype, batch: int, kv_heads: int, S: int,
                   hd: int, quant: bool, device: torch.device) -> int:
    """Context splits per (slot, KV head) of a launch at these shapes on
    ``device`` (a card): the bf16 kernel's ``cluster_splits`` under the
    card's cluster residency, the f32 kernel's ``pick_splits``."""
    tile = _TILE_ROWS[dtype]
    if dtype != torch.bfloat16:
        return pick_splits(batch, kv_heads, S, tile)
    from dynamo_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_decode")
    return cluster_splits(batch, kv_heads, S, tile,
                          _cluster_residency(lib, device, quant, hd))


def _check(q, ctx_k, ctx_v, ring_k, ring_v, layer, ctx_lens, ring_base,
           ctx_k_scale=None, ctx_v_scale=None):
    B, n_heads, hd = q.shape
    L, nkv, lanes, S, hd_k = ctx_k.shape
    kv_dtype = q.dtype if ctx_k_scale is None else torch.int8
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_decode: unsupported dtype {q.dtype}")
    if hd not in _HEAD_DIMS[q.dtype] or hd_k != hd:
        raise ValueError(
            f"flash_decode: unsupported head_dim {hd}/{hd_k} in {q.dtype}")
    if n_heads % nkv or n_heads // nkv > _MAX_G:
        raise ValueError(
            f"flash_decode: {n_heads} heads over {nkv} KV heads unsupported")
    if lanes < B or ring_k.shape != (L, nkv, B, ring_k.shape[3], hd):
        raise ValueError("flash_decode: ctx/ring shapes do not match q")
    if not 0 <= int(layer) < L:
        raise ValueError(f"flash_decode: layer {layer} out of range")
    for name, t, dt in (("q", q, q.dtype), ("ctx_k", ctx_k, kv_dtype),
                        ("ctx_v", ctx_v, kv_dtype), ("ring_k", ring_k, q.dtype),
                        ("ring_v", ring_v, q.dtype)):
        if t.dtype != dt or not t.is_cuda or not t.is_contiguous():
            raise ValueError(
                f"flash_decode: {name} must be a contiguous CUDA {dt}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} is not 16-byte aligned")
    if ctx_v.shape != ctx_k.shape or ring_v.shape != ring_k.shape:
        raise ValueError("flash_decode: K and V shapes differ")
    for name, t in (("ctx_lens", ctx_lens), ("ring_base", ring_base)):
        if (t.dtype != torch.int32 or not t.is_cuda or t.shape != (B,)
                or not t.is_contiguous()):
            raise ValueError(
                f"flash_decode: {name} must be contiguous CUDA int32 [B]")
    if ctx_k_scale is None:
        return 0
    if ctx_v_scale is None:
        raise ValueError("flash_decode: int8 mode needs both scales")
    n_groups = ctx_k_scale.shape[-1]
    if n_groups <= 0 or S % n_groups:
        raise ValueError(
            f"flash_decode: {n_groups} scale groups do not tile S={S}")
    for name, t in (("ctx_k_scale", ctx_k_scale),
                    ("ctx_v_scale", ctx_v_scale)):
        if (t.dtype != torch.float32 or not t.is_cuda
                or not t.is_contiguous() or t.shape != (L, lanes, n_groups)):
            raise ValueError(
                f"flash_decode: {name} must be a contiguous CUDA float32 "
                f"[{L}, {lanes}, S/group]")
    return S // n_groups


def _launch(q, ctx_k, ctx_v, ring_k, ring_v, layer, ctx_lens, ring_base,
            ctx_k_scale=None, ctx_v_scale=None):
    global launches, launches_int8
    from dynamo_tpu_torch.ops import cuda_build

    group = _check(q, ctx_k, ctx_v, ring_k, ring_v, layer, ctx_lens,
                   ring_base, ctx_k_scale, ctx_v_scale)
    lib = cuda_build.load("flash_decode")
    quant = ctx_k_scale is not None
    fn = lib.flash_decode_int8_launch if quant else lib.flash_decode_launch
    n_ptr = 13 if quant else 11
    n_int = 11 if quant else 10
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr
            + [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    B, n_heads, hd = q.shape
    _, nkv, lanes, S, _ = ctx_k.shape
    R = ring_k.shape[3]
    G = n_heads // nkv
    out = torch.empty_like(q)
    n_split = context_splits(q.dtype, B, nkv, S, hd, quant, q.device)
    if q.dtype == torch.bfloat16:
        # one launch in either mode: the splits merge in a thread-block
        # cluster, no scratch
        scratch = []
    else:
        f32 = dict(dtype=torch.float32, device=q.device)
        scratch = [torch.empty(B, nkv, n_split + 1, G, *extra, **f32)
                   for extra in ((), (), (hd,))]  # partial m, l, acc
    parts = [t.data_ptr() for t in scratch] or [None] * 3
    kv = [ctx_k.data_ptr(), ctx_v.data_ptr()]
    if quant:
        kv += [ctx_k_scale.data_ptr(), ctx_v_scale.data_ptr()]
    dims = [_DTYPE_CODE[q.dtype], B, n_heads, nkv, hd, lanes, S, R,
            int(layer), n_split] + ([group] if quant else [])
    err = fn(
        q.data_ptr(), *kv, ring_k.data_ptr(), ring_v.data_ptr(),
        ctx_lens.data_ptr(), ring_base.data_ptr(), out.data_ptr(), *parts,
        *dims, 1.0 / hd ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {err}")
    if quant:
        launches_int8 += 1
    else:
        launches += 1
    return out


def executed(device: torch.device, reset: bool = False) -> tuple[int, int]:
    """(dense, int8): the attention kernel's executions on ``device``
    since the library loaded or the last reset, graph replays included
    (block (0, 0, 0) of every launch counts itself). Synchronises the
    device; with ``reset`` both counts go back to 0."""
    from dynamo_tpu_torch.ops import cuda_build

    fn = cuda_build.load("flash_decode").flash_decode_executed
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    got = (ctypes.c_ulonglong * 2)()
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        err = fn(got, int(reset))
    if err != 0:
        raise RuntimeError(f"flash_decode: reading the execution count "
                           f"failed: cudaError {err}")
    return int(got[0]), int(got[1])


def flash_decode_attention(
    q: torch.Tensor,          # [B, n_heads, hd]
    ctx_k: torch.Tensor,      # [L, kvh, B(+1), S, hd] contiguous per-slot KV
    ctx_v: torch.Tensor,
    ring_k: torch.Tensor,     # [L, kvh, B, R, hd] current-round writes
    ring_v: torch.Tensor,
    layer: int,
    ctx_lens: torch.Tensor,   # [B] int32, context INCLUDING the current token
    ring_base: torch.Tensor,  # [B] int32, position held by ring slot 0
    ctx_k_scale: Optional[torch.Tensor] = None,  # f32 [L, B(+1), S//group]
    ctx_v_scale: Optional[torch.Tensor] = None,  # (int8 ctx_k/ctx_v)
) -> torch.Tensor:
    """Decode attention over contiguous KV + ring; returns [B, n_heads,
    hd] in q's dtype. With scales the ctx K/V are int8 (int8 mode). CUDA
    tensors go to the Hopper kernel (or raise); CPU tensors take the
    plain version."""
    if q.is_cuda:
        return _launch(q, ctx_k, ctx_v, ring_k, ring_v, layer, ctx_lens,
                       ring_base, ctx_k_scale, ctx_v_scale)
    return flash_decode_attention_plain(
        q, ctx_k, ctx_v, ring_k, ring_v, layer, ctx_lens, ring_base,
        ctx_k_scale, ctx_v_scale)
