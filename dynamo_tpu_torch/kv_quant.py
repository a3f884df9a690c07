"""Int8 KV: the device-side group quantization shared by the int8 ctx
region's writes (models/llama.py) and the int8 flash-decode plain version
and the host page bundle of the offload tiers (port of the JAX package's
kv_quant.py).

With ``EngineConfig.kv_quant="int8"`` the serving ctx region and the paged
prefix pool hold int8 K/V with f32 absmax scales per (layer, lane,
position group) in the region and per (layer, page) in the pool, with
group == page_size so that ctx<->pool copies move raw int8 pages and
their scales. The decode kernel dequantizes in shared memory, so the live
context streams half the bytes of a bf16 region.

Determinism rule: a write's scale depends ONLY on the request's own data.
``written`` marks the groups a write overlaps (their scale is recomputed);
``valid`` masks which window positions feed the absmax (the request's own
prefix + the new span, never the stale suffix a previous slot occupant
left). Untouched groups keep their scale bit for bit, and dequant ->
requant with an unchanged scale is exact after rounding (|q| <= 127 in
f32), so they never drift. ``torch.round`` rounds half to even as
``jnp.round`` does, so the int8 bytes equal the JAX package's on the same
inputs.

The host half serves the offload tiers and page export/import: the page
bundle ``QuantizedPages`` (int8 pages and their f32 scales, torch CPU
tensors), host quantize/dequantize at a mode boundary (dense pages into
an int8 pool, or the reverse), and the ``dynamo_kv_quant_*`` families
that /metrics renders, and the wire form of the scales
(``attach_wire_scales``, ``from_wire``): a JSON float list in the frame
header of the transfer plane (kv_transfer.py), as the JAX package sends
it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import torch

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

# scale floor: a block of exact zeros must not divide by zero, and the
# floor must be far below any real bf16 activation scale
SCALE_EPS = 1e-8

FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_kv_quant_pages_total", "counter",
     "KV pages quantized to int8 at a pool/transfer boundary"),
    ("dynamo_kv_quant_dequant_pages_total", "counter",
     "int8 KV pages dequantized back to the compute dtype"),
    ("dynamo_kv_quant_scale_bytes_total", "counter",
     "bytes of per-block scale sidecars shipped alongside int8 pages"),
    ("dynamo_kv_pool_capacity_blocks", "gauge",
     "paged prefix-pool capacity in blocks (usable pages; int8 pools "
     "fit ~2x the blocks of a bf16 pool in the same HBM)"),
    ("dynamo_kv_quant_ctx_seal_raw_pages_total", "counter",
     "pages sealed ctx->pool as raw int8 copies (group size == page "
     "size, so no requantize pass at the seal boundary)"),
    ("dynamo_kv_quant_ctx_admit_raw_pages_total", "counter",
     "pages admitted pool->ctx as raw int8 copies (no dequantize pass "
     "at admission — the kernel dequantizes in VMEM per chunk)"),
    ("dynamo_kv_quant_ctx_flush_groups_total", "counter",
     "ctx scale groups covered by ring-flush requantize windows "
     "(lanes x window groups, once per decode round)"),
)

_HISTOGRAMS: tuple[tuple[str, str], ...] = (
    ("dynamo_kv_quant_dequant_seconds",
     "wall time of one host-side dequantize (tier/mode boundary "
     "conversions; the pool->ctx dequant is fused on device)"),
)

KV_QUANT = CounterRegistry(FAMILIES, _HISTOGRAMS, label="kv-quant")


@dataclass
class QuantizedPages:
    """Host bundle of int8 KV pages and their per-(k/v, layer, page)
    scales: ``data`` int8 ``[2, L, kvh, n, ps, hd]`` (llama.gather_pages'
    axis order), ``scales`` f32 ``[2, L, n]``."""

    data: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scales.numel() * self.scales.element_size())

    @property
    def n_pages(self) -> int:
        return int(self.data.shape[3])

    def slice_pages(self, lo: int, hi: int) -> "QuantizedPages":
        return QuantizedPages(self.data[:, :, :, lo:hi],
                              self.scales[:, :, lo:hi])

    def page(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(page [2, L, kvh, ps, hd], scale [2, L]) for one page."""
        return self.data[:, :, :, i], self.scales[:, :, i]

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        """Back to dense pages in ``dtype`` (a tier or mode boundary; the
        pool->ctx path dequantizes on the device)."""
        t0 = time.monotonic()
        out = (self.data.float()
               * self.scales[:, :, None, :, None, None]).to(dtype)
        KV_QUANT.observe("dynamo_kv_quant_dequant_seconds",
                         time.monotonic() - t0)
        KV_QUANT.inc("dynamo_kv_quant_dequant_pages_total", self.n_pages)
        return out


def quantize_pages(data: torch.Tensor) -> QuantizedPages:
    """Symmetric int8 quantize of dense pages ``[2, L, kvh, n, ps, hd]``
    with per-(k/v, layer, page) absmax scales: the mode boundary for
    dense pages entering an int8 pool. ``torch.round`` rounds half to
    even as ``np.rint`` does, so the bytes equal the JAX package's."""
    f = data.float()
    s = torch.clamp(f.abs().amax(dim=(2, 4, 5)) / 127.0, min=SCALE_EPS)
    q = torch.clamp(torch.round(f / s[:, :, None, :, None, None]),
                    -127, 127).to(torch.int8)
    KV_QUANT.inc("dynamo_kv_quant_pages_total", q.shape[3])
    return QuantizedPages(q, s)


def is_quantized(data: Any) -> bool:
    return isinstance(data, QuantizedPages)


def to_pool_dtype(data: Any, quantized_pool: bool,
                  dtype: torch.dtype) -> Any:
    """An incoming page payload as the local pool stores it: a bundle for
    an int8 pool (quantizing dense pages), dense ``dtype`` pages
    otherwise (dequantizing a bundle). Unchanged when it already
    matches."""
    if quantized_pool:
        return data if is_quantized(data) else quantize_pages(data)
    if is_quantized(data):
        return data.dequantize(dtype)
    return data


# wire form: int8 payload + scales in the frame header (kv_transfer.py
# two-part frames). The scale sidecar is small enough for the JSON header:
# [2, L, n] f32 beside a [2, L, kvh, n, ps, hd] int8 payload

def attach_wire_scales(header: dict, qp: QuantizedPages) -> None:
    """Add the scale sidecar to an outgoing frame header, as a JSON float
    list and its shape (the frame's shape/dtype describe ``qp.data``, the
    payload)."""
    header["kv_scales"] = qp.scales.reshape(-1).tolist()
    header["kv_scales_shape"] = list(qp.scales.shape)
    KV_QUANT.inc("dynamo_kv_quant_scale_bytes_total",
                 qp.scales.numel() * qp.scales.element_size())


def from_wire(arr: torch.Tensor, header: dict) -> Any:
    """The receive-side value: a QuantizedPages when the frame carried
    scales, the plain tensor otherwise."""
    if "kv_scales" not in header:
        return arr
    scales = torch.tensor(header["kv_scales"], dtype=torch.float32).reshape(
        [int(d) for d in header["kv_scales_shape"]])
    return QuantizedPages(arr, scales)


def dequantize_groups(
    q: torch.Tensor,        # int8 [L, kvh, N, W, hd]
    scales: torch.Tensor,   # f32 [L, N, W//group]
    group: int,
) -> torch.Tensor:
    """Per-group dequantize of N windows back to f32."""
    L, kvh, N, W, hd = q.shape
    g = q.reshape(L, kvh, N, W // group, group, hd).float()
    out = g * scales[:, None, :, :, None, None]
    return out.reshape(L, kvh, N, W, hd)


def requantize_groups(
    wf: torch.Tensor,         # f32 [L, kvh, N, W, hd] — dequantized windows
                              # with the new span already overlaid
    old_scale: torch.Tensor,  # f32 [L, N, W//group]
    valid: torch.Tensor,      # bool [N, W] — positions feeding the absmax
    written: torch.Tensor,    # bool [N, W//group] — groups whose scale is
                              # recomputed (overlap the write)
    group: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Requantize N windows: written groups get a fresh absmax scale over
    their valid positions; untouched groups round-trip exactly through
    their old scale. Returns (int8 windows, new scales)."""
    L, kvh, N, W, hd = wf.shape
    nW = W // group
    gw = wf.reshape(L, kvh, N, nW, group, hd)
    vm = valid.reshape(N, nW, group)
    am = torch.where(vm[None, None, :, :, :, None], gw.abs(),
                     0.0).amax(dim=(1, 4, 5))                  # [L, N, nW]
    fresh = torch.clamp(am / 127.0, min=SCALE_EPS)
    new_scale = torch.where(written[None], fresh, old_scale)
    div = torch.clamp(new_scale, min=SCALE_EPS)[:, None, :, :, None, None]
    q = torch.clamp(torch.round(gw / div), -127, 127).to(torch.int8)
    return q.reshape(L, kvh, N, W, hd), new_scale
