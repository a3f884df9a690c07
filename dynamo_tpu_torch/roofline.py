"""Per-step decode byte accounting and roofline attribution (a copy of
the JAX package's roofline.py for the card).

``decode_byte_accounting`` decomposes the HBM bytes one fused decode
step moves into its streams -- the weights, the live context KV (from
the lanes' actual context lengths, the rows the kernel reads), the int8
scale sidecar, the write ring and the logits row -- so the
profile and benchmark lines can emit

  kv_bytes_per_step    KV-plane bytes a fused step (ctx + scales + ring)
  attn_roofline_frac   steps/s x total bytes a step / the card's peak
                       bandwidth (the share of its bandwidth the
                       measured rate moves)

and the int8 KV claim becomes a reported ratio (``kv_ctx_bytes_vs_bf16``).

The values are derived from the configuration and the context lengths,
not read from counters: exact for the streams the fused round moves
(every weight byte, every live context row the kernel reads) and
leaving out second-order traffic (activations, sampler temporaries).
The one difference from the JAX package: the TPU kernel reads whole
chunks, so the JAX package rounds a lane's live rows up to its chunk;
the port's kernel (csrc/flash_decode.cu) copies only the live rows of a
tile and zero-fills the rest in shared memory, so a lane counts its live
rows exactly, and in int8 mode the scale groups that hold them.

The peak table holds the cards whose published peaks are known. On the
CPU, or on a card not in it, ``chip_info`` gives no peak, and the
fraction is null: a device without a known peak has nothing to
attribute against.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# torch.cuda.get_device_name() (a substring of it) -> (dense bf16 FLOP/s,
# HBM bytes/s): NVIDIA's data sheet, SXM part, at its 700 W limit
CHIP_PEAKS = {
    "H100 80GB HBM3": (989e12, 3.35e12),
}


def chip_info(device=None):
    """(device name, (peak bf16 FLOP/s, peak bytes/s) or None, on a
    card). ``device`` defaults to the card when there is one."""
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return "cpu", None, False
    kind = torch.cuda.get_device_name(dev)
    for name, peak in CHIP_PEAKS.items():
        if name.lower() in kind.lower():
            return kind, peak, True
    return kind, None, True


def params_nbytes(params) -> int:
    """Bytes of every tensor in a (nested) parameter tree: int8 weights
    and their scales for a w8a16 model."""
    if isinstance(params, torch.Tensor):
        return params.nbytes
    if isinstance(params, dict):
        return sum(params_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_nbytes(v) for v in params)
    return 0


def decode_byte_accounting(
    config,                      # models.config.ModelConfig
    ecfg,                        # engine.config.EngineConfig
    ctx_lens: Sequence[int],     # each lane's live rows in the ctx region
    param_bytes: int,
    steps_per_s: Optional[float] = None,
    peak_bw: Optional[float] = None,
) -> dict:
    """The fused decode round's HBM bytes a step, by stream.

    Returns the breakdown (``bytes_per_step_breakdown``), the aggregates
    (``kv_bytes_per_step``, ``total_bytes_per_step``), the quantization
    ratio (``kv_ctx_bytes_vs_bf16``: live ctx and scale bytes over the
    same rows in bf16) and, given ``steps_per_s`` and ``peak_bw``,
    ``attn_roofline_frac`` (else None)."""
    from dynamo_tpu_torch.models.llama import torch_dtype

    c, e = config, ecfg
    L, kvh, hd = c.num_layers, c.num_kv_heads, c.head_dim
    B, R = e.max_decode_slots, e.flush_every
    quant = e.kv_quant == "int8"
    dtype = torch_dtype(e.cache_dtype)
    compute_bytes = dtype.itemsize
    kv_elem = 1 if quant else compute_bytes
    group = max(1, e.page_size)
    S = -(-e.max_context // group) * group if quant else e.max_context

    # live ctx stream: each lane's live rows (never past the region)
    lens = np.clip(np.asarray(list(ctx_lens), np.int64), 0, S)
    kv_ctx = int(2 * L * kvh * hd * lens.sum()) * kv_elem
    # int8 scale sidecar: the groups that hold the live rows, f32 per
    # (layer, group), no head axis
    kv_ctx_scales = (
        int(2 * L * (-(-lens // group)).sum()) * 4 if quant else 0)
    # write ring: read in full by every step's attention, one new row
    # written a lane a step; it stays in the compute dtype
    ring_elems = 2 * L * kvh * B * R * hd
    kv_ring = (ring_elems + 2 * L * kvh * B * hd) * compute_bytes
    # the logits row the sampler reads (f32)
    logits = B * c.vocab_size * 4

    bf16_equiv = int(2 * L * kvh * hd * lens.sum()) * 2
    kv_bytes = kv_ctx + kv_ctx_scales + kv_ring
    total = param_bytes + kv_bytes + logits
    return {
        "bytes_per_step_breakdown": {
            "weights": param_bytes,
            "kv_ctx": kv_ctx,
            "kv_ctx_scales": kv_ctx_scales,
            "kv_ring": kv_ring,
            "logits": logits,
        },
        "kv_bytes_per_step": kv_bytes,
        "total_bytes_per_step": total,
        "kv_ctx_bytes_vs_bf16": (
            (kv_ctx + kv_ctx_scales) / bf16_equiv if bf16_equiv else None),
        "attn_roofline_frac": (
            steps_per_s * total / peak_bw
            if steps_per_s and peak_bw else None),
    }
