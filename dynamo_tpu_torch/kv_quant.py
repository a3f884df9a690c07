"""Int8 KV: the device-side group quantization shared by the int8 ctx
region's writes (models/llama.py) and the int8 flash-decode plain version
(port of the JAX package's kv_quant.py, device helpers only).

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

The host page bundle, the wire/tier helpers and the metric families wait
for the transfer, offload and telemetry planes (ROADMAP).
"""
from __future__ import annotations

import torch

# scale floor: a block of exact zeros must not divide by zero, and the
# floor must be far below any real bf16 activation scale
SCALE_EPS = 1e-8


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
