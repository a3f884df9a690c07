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

``w8a16_matmul`` launches a hand-written Hopper kernel in
``csrc/w8a16_gemm.cu`` for CUDA tensors (or raises) and runs the plain
PyTorch version for CPU tensors. ``route`` picks the kernel: the layer
products of prefill (bf16 x, layout "kn", bf16 out, ``M >= WGMMA_MIN_M``)
run the TMA-fed ``wgmma`` kernel, everything else the ``mma.sync`` kernel
(bf16 x) or the FMA kernel (f32 x). ``launches`` counts the calls that
launched, ``launches_wgmma`` those of them that took the ``wgmma``
kernel; a launch replayed from a CUDA graph passes no wrapper, and
``executed`` reads the count the kernels keep on the card, which sees it.
"""
from __future__ import annotations

import ctypes

import torch

# kernel launches since import (or since a caller reset it to 0), and
# those of them that ran the wgmma kernel
launches = 0
launches_wgmma = 0

_BN = 128         # output channels per block (csrc kBN)
_BK = 64          # k per pipeline stage (csrc kBK)
_MAX_SPLITS = 8   # K splits merged in one thread-block cluster (csrc kMaxSplits)
_BLOCKS_WANTED = 2 * 132  # two blocks per H100 SM
_X_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
# the wgmma kernel (csrc w8a16_gemm_wgmma_kernel): 128 output channels and
# BR = 128 or 256 activation rows a block, 64 k a stage, one block an SM
_WG_BN = 128
_WG_BK = 64
_SMEM_PER_BLOCK = 232448  # 227 KB
# the smallest M whose bf16 layer products take the wgmma kernel: at M = 48
# it beats the mma kernel on every 8B layer shape, at M = 32 the mma kernel
# wins a layer's 7 products (tools/torch_w8a16_sweep.py); from 33 to 64
# both pad to one tile (64 rows for mma, 128 for wgmma), so M = 48 stands
# for the range
WGMMA_MIN_M = 33
# K splits the wgmma plan considers, and how many clusters of each size an
# H100 SXM runs at once with one block an SM (cudaOccupancyMaxActiveClusters
# on an H100 80GB HBM3, tools/torch_w8a16_sweep.py); on the card the
# wrapper asks the card itself (``max_clusters``)
WGMMA_SPLITS = (1, 2, 3, 4, 6, 8)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 6: 17, 8: 15}
# the plan's cost model, microseconds on an H100 80GB HBM3 at 700 W, fit
# to tools/torch_w8a16_sweep.py's times and --timeline stamps: a block's
# start, first stage and epilogue; one k tile of the main loop; the merge
# of a split tile
_WG_FIXED_US = {128: 3.9, 256: 6.0}
_WG_TILE_US = {128: 0.44, 256: 0.66}
_WG_MERGE_US = {128: 4.2, 256: 5.7}
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


def wgmma_plan(M: int, N: int, K: int,
               clusters: dict[int, int] | None = None) -> tuple[int, int]:
    """(br, splits) for the wgmma kernel: BR activation rows a block (128
    or 256) and the K splits of one cluster (``WGMMA_SPLITS``), the plan
    of least modelled time. ``clusters`` maps a split count to the
    clusters of that size the card runs at once (``max_clusters``; the
    H100's by default): blocks beyond them wait for a second wave. A
    block costs ``_WG_FIXED_US`` plus ``_WG_TILE_US`` a k tile, and the
    merge of a split tile ``_WG_MERGE_US`` (tools/torch_w8a16_sweep.py
    measured all three and the clusters)."""
    clusters = clusters or H100_CLUSTERS
    k_tiles = -(-K // _WG_BK)
    best = None
    for br in (128, 256):
        tiles = -(-M // br) * -(-N // _WG_BN)
        for splits in WGMMA_SPLITS:
            per = -(-k_tiles // splits)
            if splits > 1 and -(-k_tiles // per) != splits:
                continue  # a split would be empty
            if clusters.get(splits, 0) < 1:
                continue  # the card cannot run a cluster of this size
            waves = -(-tiles // clusters[splits])
            us = waves * (_WG_FIXED_US[br] + per * _WG_TILE_US[br]
                          + (splits > 1) * _WG_MERGE_US[br])
            if best is None or us < best[0]:
                best = (us, br, splits)
    return best[1], best[2]


def wgmma_smem_bytes(br: int) -> tuple[int, int]:
    """(dynamic shared memory bytes, stages) of a wgmma kernel block with
    BR = ``br`` (csrc WgSmem<BR>): as many stages of a bf16 x tile [BR, 64]
    and an int8 weight tile [64, 128] as fit in 227 KB (up to 8), the
    f32 output tile reusing them, two mbarriers a stage and 1024 bytes to
    align the stages to the swizzle's period."""
    stage = br * _WG_BK * 2 + _WG_BK * _WG_BN
    stages = min(8, (_SMEM_PER_BLOCK - 1024 - 16 * 8) // stage)
    red = br * (_WG_BN + 4) * 4
    return 1024 + max(stages * stage, red) + 16 * stages, stages


def route(M: int, N: int, K: int, layout: str, x_dtype: torch.dtype,
          out_dtype: torch.dtype,
          clusters: dict[int, int] | None = None) -> tuple[str, tuple[int, int]]:
    """Which kernel a CUDA call runs, and its plan: ("wgmma", (br,
    splits)) for a layer product of prefill (bf16 x, layout "kn", bf16
    out, ``M >= WGMMA_MIN_M``; ``clusters`` as for ``wgmma_plan``);
    ("mma", (bm, splits)) for the other bf16 products (decode, the f32
    logits, layout "nk"); ("fma", (0, 1)) for f32 x."""
    if layout not in _LAYOUTS:
        raise ValueError(f"w8a16: unknown layout {layout!r}")
    if x_dtype == torch.float32:
        return "fma", (0, 1)
    if (layout == "kn" and x_dtype == torch.bfloat16
            and out_dtype == torch.bfloat16 and M >= WGMMA_MIN_M):
        return "wgmma", wgmma_plan(M, N, K, clusters)
    return "mma", plan(M, N, K)


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


_fns: dict[str, object] = {}
# route() per call shape and device: the prefill runs each shape 32 times
# a call, and the host, not the card, bounds an eager prefill
_routes: dict[tuple, tuple[str, tuple[int, int]]] = {}
_WGMMA_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_MMA_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _fn(name, argtypes):
    fn = _fns.get(name)
    if fn is None:
        from dynamo_tpu_torch.ops import cuda_build

        fn = getattr(cuda_build.load("w8a16_gemm"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(x, q, s, out_dtype, layout, kernel=None):
    """Launch the kernel that ``route`` picks (``kernel``, a (name, plan)
    pair, overrides it: the card check times the mma kernel at large M
    beside the wgmma one; serving never passes it)."""
    global launches, launches_wgmma
    K, N = _dims(q, layout)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    _check(x2, q, s, out_dtype, layout, K, N)
    M = x2.shape[0]
    y = torch.empty(M, N, dtype=out_dtype, device=x.device)
    if M == 0:
        return y.view(*lead, N)
    if kernel is None:
        key = (M, N, K, layout, x2.dtype, out_dtype, x.device)
        kernel = _routes.get(key)
        if kernel is None:
            kernel = _routes[key] = route(M, N, K, layout, x2.dtype,
                                          out_dtype, card_clusters(x.device))
    name, (a, splits) = kernel
    # the device index, not the device: a third of the host time
    stream = torch.cuda.current_stream(x.get_device()).cuda_stream
    if name == "wgmma":
        err = _fn("w8a16_gemm_wgmma_launch", _WGMMA_ARGS)(
            x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
            M, N, K, a, splits, stream)
    else:
        err = _fn("w8a16_gemm_launch", _MMA_ARGS)(
            x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
            _X_DTYPE[x2.dtype], int(out_dtype == torch.bfloat16),
            _LAYOUTS[layout], M, N, K, a, splits, stream)
    if err != 0:
        raise RuntimeError(f"w8a16_gemm {name} kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_wgmma += name == "wgmma"
    return y.view(*lead, N)


def kernel_smem(br: int) -> tuple[int, int]:
    """(bytes, stages) of a wgmma kernel block as the built library
    reports them (``wgmma_smem_bytes`` is the same from Python)."""
    stages = ctypes.c_int(0)
    nbytes = _fn("w8a16_gemm_wgmma_smem",
                 [ctypes.c_int, ctypes.c_void_p])(br, ctypes.byref(stages))
    return nbytes, stages.value


def executed(device: torch.device, reset: bool = False) -> int:
    """The kernels' executions (both tensor-core kernels and the FMA one)
    on ``device`` since the library loaded or the last reset, graph
    replays included (block (0, 0, 0) of every launch counts itself). Synchronises the device; with ``reset`` the
    count goes back to 0."""
    fn = _fn("w8a16_gemm_executed", [ctypes.c_void_p, ctypes.c_int])
    got = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        err = fn(ctypes.byref(got), int(reset))
    if err != 0:
        raise RuntimeError(f"w8a16_gemm: reading the execution count failed: "
                           f"cudaError {err}")
    return int(got.value)


_clusters: dict[int, dict[int, int]] = {}


def card_clusters(device: torch.device) -> dict[int, int]:
    """``clusters`` for ``wgmma_plan`` as ``device`` reports them (asked
    once per device; BR does not change them: one block an SM either
    way)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    got = _clusters.get(idx)
    if got is None:
        with torch.cuda.device(idx):
            got = {sp: max_clusters(256, sp) for sp in WGMMA_SPLITS}
        _clusters[idx] = got
    return got


def max_clusters(br: int, splits: int) -> int:
    """How many clusters of ``splits`` wgmma blocks with BR = ``br`` the
    current CUDA device runs at once."""
    got = ctypes.c_int(0)
    err = _fn("w8a16_gemm_wgmma_max_clusters",
              [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])(
                  br, splits, ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"w8a16_gemm: max active clusters failed: "
                           f"cudaError {err}")
    return got.value


def w8a16_matmul(x: torch.Tensor, w: dict, out_dtype: torch.dtype,
                 layout: str = "kn") -> torch.Tensor:
    """``x [..., K]`` times the quantized weight ``w`` (``{"q", "s"}``),
    ``[..., N]`` in ``out_dtype`` (``x.dtype`` for a layer product,
    float32 for the logits). CUDA tensors go to the Hopper kernel that
    ``route`` picks (or raise); CPU tensors take the plain version."""
    if x.is_cuda:
        return _launch(x, w["q"], w["s"], out_dtype, layout)
    return w8a16_matmul_plain(x, w["q"], w["s"], out_dtype, layout)
