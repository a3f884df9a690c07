"""Weight-only int8 matrix products (w8a16): ``x @ q`` with a symmetric
per-output-channel scale ``s``, the int8 weight dequantized on chip.

A quantized weight is ``{"q": int8, "s": f32 [N]}``, as the JAX package
stores it (dynamo_tpu/models/llama.py:395-413). ``layout="kn"`` takes
``q`` as ``[K, N]`` (every layer weight and an untied lm_head, stored
``[in, out]``), ``layout="nk"`` as ``[N, K]`` (the tied embedding table
``[V, H]`` read as the logits weight, with no transposed copy).

The output dtype picks the reference's rounding:
  - ``out_dtype == x.dtype`` (a layer product, ``_mm`` at :409):
    ``(x @ q.astype(x.dtype)) * s.astype(x.dtype)``; for bf16 x the
    product is rounded to bf16 and then multiplied by the bf16 scale;
  - ``out_dtype == float32`` (the logits, ``_logits`` at :612-621): the
    product accumulated in f32 (``preferred_element_type=f32``), then
    ``* s`` in f32.

``w8a16_matmul`` launches the hand-written Hopper kernel in
``csrc/w8a16_gemm.cu`` for CUDA tensors (or raises) and runs the plain
PyTorch version for CPU tensors. ``launches`` counts the calls that
launched; a launch replayed from a CUDA graph passes no wrapper, and
``executed`` reads the count the kernel keeps on the card, which sees it.
"""
from __future__ import annotations

import ctypes

import torch

# kernel launches since import (or since a caller reset it to 0)
launches = 0

_BN = 128         # output channels per block (csrc kBN)
_BK = 64          # k per pipeline stage (csrc kBK)
_MAX_SPLITS = 8   # K splits merged in one thread-block cluster (csrc kMaxSplits)
_BLOCKS_WANTED = 2 * 132  # two blocks per H100 SM
_X_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUTS = {"kn": 0, "nk": 1}


def _dims(q: torch.Tensor, layout: str) -> tuple[int, int]:
    """(K, N) of ``q`` in ``layout``."""
    if layout not in _LAYOUTS:
        raise ValueError(f"w8a16: unknown layout {layout!r}")
    return tuple(q.shape) if layout == "kn" else tuple(q.shape[::-1])


def w8a16_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       out_dtype: torch.dtype,
                       layout: str = "kn") -> torch.Tensor:
    """Plain PyTorch version: the reference's formula. ``x [..., K]``;
    returns ``[..., N]`` in ``out_dtype``."""
    w = q if layout == "kn" else q.t()
    if out_dtype == x.dtype:
        return (x @ w.to(x.dtype)) * s.to(x.dtype)
    if out_dtype != torch.float32:
        raise ValueError(f"w8a16: unsupported out_dtype {out_dtype}")
    # bf16 products are exact in f32, so an f32 product of the widened
    # operands is the f32-accumulated product
    return (x.float() @ w.float()) * s.float()


def plan(M: int, N: int, K: int) -> tuple[int, int]:
    """(bm, splits) for the bf16 kernel: BM activation rows a block (8,
    32 or 64) and the K splits of one cluster, enough blocks to fill the
    card twice over when the output tiles alone cannot."""
    bm = 8 if M <= 8 else 32 if M <= 32 else 64
    tiles = -(-N // _BN) * -(-M // bm)
    k_tiles = -(-K // _BK)
    splits = 1
    if tiles < _BLOCKS_WANTED:
        splits = max(1, min(_MAX_SPLITS, -(-_BLOCKS_WANTED // tiles), k_tiles))
        splits = -(-k_tiles // -(-k_tiles // splits))  # no empty split
    return bm, splits


def smem_bytes(bm: int) -> int:
    """Dynamic shared memory of a bf16 kernel block with BM = ``bm``: 4
    stages of an int8 tile (64 x 128) and ``bm`` padded x rows (csrc
    Smem<BM>)."""
    return 4 * (_BK * _BN + bm * (2 * _BK + 32))


def _check(x2, q, s, out_dtype, layout, K, N):
    if x2.dtype not in _X_DTYPE:
        raise ValueError(f"w8a16: unsupported activation dtype {x2.dtype}")
    if out_dtype not in (x2.dtype, torch.float32):
        raise ValueError(f"w8a16: out_dtype {out_dtype} with {x2.dtype} x")
    if q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError(f"w8a16: q must be a 2-D int8 tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if x2.shape[1] != K:
        raise ValueError(f"w8a16: x has {x2.shape[1]} columns, the weight "
                         f"({layout}) {K} rows")
    if K % 16 or N % 16:
        raise ValueError(f"w8a16: K={K} and N={N} must be multiples of 16")
    if s.dtype != torch.float32 or tuple(s.shape) != (N,):
        raise ValueError(f"w8a16: s must be float32 [{N}]")
    for name, t in (("x", x2), ("q", q), ("s", s)):
        if not t.is_cuda or not t.is_contiguous() or t.device != x2.device:
            raise ValueError(f"w8a16: {name} must be a contiguous tensor on "
                             f"{x2.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"w8a16: {name} is not 16-byte aligned")


def _launch(x, q, s, out_dtype, layout):
    global launches
    from dynamo_tpu_torch.ops import cuda_build

    K, N = _dims(q, layout)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    _check(x2, q, s, out_dtype, layout, K, N)
    M = x2.shape[0]
    y = torch.empty(M, N, dtype=out_dtype, device=x.device)
    if M == 0:
        return y.view(*lead, N)
    fn = cuda_build.load("w8a16_gemm").w8a16_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    bm, splits = plan(M, N, K)
    err = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
             _X_DTYPE[x2.dtype], int(out_dtype == torch.bfloat16),
             _LAYOUTS[layout], M, N, K, bm, splits,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16_gemm kernel launch failed: cudaError {err}")
    launches += 1
    return y.view(*lead, N)


def executed(device: torch.device, reset: bool = False) -> int:
    """The kernel's executions on ``device`` since the library loaded or
    the last reset, graph replays included (block (0, 0, 0) of every
    launch counts itself). Synchronises the device; with ``reset`` the
    count goes back to 0."""
    from dynamo_tpu_torch.ops import cuda_build

    fn = cuda_build.load("w8a16_gemm").w8a16_gemm_executed
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    got = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        err = fn(ctypes.byref(got), int(reset))
    if err != 0:
        raise RuntimeError(f"w8a16_gemm: reading the execution count failed: "
                           f"cudaError {err}")
    return int(got.value)


def w8a16_matmul(x: torch.Tensor, w: dict, out_dtype: torch.dtype,
                 layout: str = "kn") -> torch.Tensor:
    """``x [..., K]`` times the quantized weight ``w`` (``{"q", "s"}``),
    ``[..., N]`` in ``out_dtype`` (``x.dtype`` for a layer product,
    float32 for the logits). CUDA tensors go to the Hopper kernel (or
    raise); CPU tensors take the plain version."""
    if x.is_cuda:
        return _launch(x, w["q"], w["s"], out_dtype, layout)
    return w8a16_matmul_plain(x, w["q"], w["s"], out_dtype, layout)
