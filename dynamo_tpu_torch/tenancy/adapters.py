"""Resident LoRA adapter banks: many fine-tune variants, one engine (a
copy of the JAX package's tenancy/adapters.py on torch tensors).

The bank is a per-site stack of low-rank A/B factor pairs --
``{site: {"a": [N, L, d_in, r], "b": [N, L, r, d_out]}}`` -- resident on
the engine's device beside the base weights, in ``params["adapters"]``.
The model functions look it up with ``params.get("adapters")``, so an
engine without a bank issues exactly the operations it issued before
tenancy.

Adapter 0 is the all-zeros identity, the base model exactly: the rank-r
delta ``(x @ A) @ B`` is exactly 0.0 for zero factors, so adapter_id=0
requests are greedy token-identical to an engine with no bank at all.
Per-slot adapter ids live in the device state (``dev["adapter"]``),
gathered inside the decode round (a CUDA graph on the card) as a row
gather + rank-r batched product per site and layer, so mixed adapter ids
in one decode batch cost no extra dispatch.

The bank is stored in the engine's compute dtype: the reference stores
f32 factors but casts them to the activation dtype before the delta, so
storing them rounded gives the same products and half the bytes a round
reads. One GPU: there is no ``replicate_bank``.

``AdapterRegistry`` maps servable variant model names to
``(base_model, adapter_id)``.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

# weight sites carrying an adapter pair (a MoE model's expert stacks take
# none: only its attention sites are adapted)
ATTN_SITES = ("wq", "wk", "wv", "wo")
MLP_SITES = ("wg", "wu", "wd")


def adapter_site_dims(config: Any) -> dict[str, tuple[int, int]]:
    """site -> (d_in, d_out) for the model's adaptable matmuls."""
    c = config
    dims = {
        "wq": (c.hidden_size, c.q_dim),
        "wk": (c.hidden_size, c.kv_dim),
        "wv": (c.hidden_size, c.kv_dim),
        "wo": (c.q_dim, c.hidden_size),
    }
    if c.moe is None:
        dims.update({
            "wg": (c.hidden_size, c.intermediate_size),
            "wu": (c.hidden_size, c.intermediate_size),
            "wd": (c.intermediate_size, c.hidden_size),
        })
    return dims


def init_adapter_bank(config: Any, n_adapters: int, rank: int,
                      dtype: torch.dtype = torch.float32,
                      device: str | torch.device = "cuda") -> dict:
    """Zero-initialized resident bank for ``n_adapters`` slots (id 0 =
    identity base model) at LoRA rank ``rank``, in ``dtype`` on
    ``device``."""
    c = config
    n = max(1, int(n_adapters))
    r = max(1, int(rank))
    return {
        site: {
            "a": torch.zeros(n, c.num_layers, d_in, r, dtype=dtype,
                             device=device),
            "b": torch.zeros(n, c.num_layers, r, d_out, dtype=dtype,
                             device=device),
        }
        for site, (d_in, d_out) in adapter_site_dims(c).items()
    }


def set_adapter(bank: dict, adapter_id: int, weights: dict) -> dict:
    """Install one adapter's factors into the bank IN PLACE (the rows
    keep their addresses, so captured CUDA graphs read the new factors).

    ``weights`` maps site -> {"a": [L, d_in, r], "b": [L, r, d_out]}
    (numpy arrays or tensors); sites absent from ``weights`` keep their
    rows. Returns the bank. Adapter 0 is the identity by contract:
    refusing to overwrite it keeps the base model addressable."""
    aid = int(adapter_id)
    if aid == 0:
        raise ValueError("adapter 0 is the identity base model")
    if not 0 < aid < next(iter(bank.values()))["a"].shape[0]:
        raise ValueError(f"adapter id {aid} is outside the bank")
    for site, ab in bank.items():
        w = weights.get(site)
        if w is None:
            continue
        a = torch.as_tensor(np.asarray(w["a"], np.float32))
        b = torch.as_tensor(np.asarray(w["b"], np.float32))
        if a.shape != ab["a"].shape[1:] or b.shape != ab["b"].shape[1:]:
            raise ValueError(
                f"adapter factors for site {site!r} have shape "
                f"{tuple(a.shape)}/{tuple(b.shape)}, bank rows are "
                f"{tuple(ab['a'].shape[1:])}/{tuple(ab['b'].shape[1:])}")
        ab["a"][aid].copy_(a)
        ab["b"][aid].copy_(b)
    return bank


def random_adapter(config: Any, rank: int, seed: int = 0,
                   scale: float = 0.05) -> dict:
    """Small random factors for every site (numpy, drawn as the JAX
    package draws them, so both packages install the same variant)."""
    rng = np.random.default_rng(seed)
    c = config
    out = {}
    for site, (d_in, d_out) in adapter_site_dims(c).items():
        out[site] = {
            "a": rng.standard_normal(
                (c.num_layers, d_in, rank)).astype(np.float32) * scale,
            "b": rng.standard_normal(
                (c.num_layers, rank, d_out)).astype(np.float32) * scale,
        }
    return out


class AdapterRegistry:
    """Servable variant names -> (base model, adapter id). Thread-safe:
    a watcher registers from asyncio while handlers resolve."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._variants: dict[str, tuple[str, int]] = {}

    def register(self, name: str, base: str, adapter_id: int) -> None:
        if int(adapter_id) <= 0:
            raise ValueError(
                "variant adapter ids start at 1 (0 is the base model)")
        with self._lock:
            self._variants[name] = (base, int(adapter_id))

    def unregister(self, name: str) -> None:
        with self._lock:
            self._variants.pop(name, None)

    def resolve(self, name: str) -> Optional[tuple[str, int]]:
        with self._lock:
            return self._variants.get(name)

    def variants(self) -> dict[str, tuple[str, int]]:
        with self._lock:
            return dict(self._variants)
