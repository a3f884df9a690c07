"""Rotary position embeddings (HF llama "rotate-half" convention, incl.
llama3 frequency scaling), computed in f32."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def rope_inv_freq(
    head_dim: int,
    theta: float,
    scaling: Optional[dict[str, Any]] = None,
) -> np.ndarray:
    """Inverse frequencies [head_dim/2], with optional llama3 NTK scaling."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if scaling and scaling.get("rope_type", scaling.get("type")) == "llama3":
        factor = scaling["factor"]
        low = scaling["low_freq_factor"]
        high = scaling["high_freq_factor"]
        orig = scaling["original_max_position_embeddings"]
        wavelen = 2 * np.pi / inv_freq
        low_wavelen = orig / low
        high_wavelen = orig / high
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = (orig / wavelen - low) / (high - low)
        mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = np.where(is_mid, mid, scaled)
    return inv_freq.astype(np.float32)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """cos/sin tables for given positions. positions [...] -> [..., head_dim]."""
    freqs = positions[..., None].float() * inv_freq  # [..., hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., n_heads, head_dim]; cos/sin: [..., head_dim] (broadcast over heads)."""
    c = cos[..., None, :]
    s = sin[..., None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * c + rotated.float() * s).to(x.dtype)
