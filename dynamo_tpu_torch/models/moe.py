"""Mixture-of-Experts layer (the port's copy of the JAX package's
models/moe.py) at world size 1.

The JAX package shards tokens over an ``ep`` mesh axis: each device
routes its tokens top-k, packs them into a capacity-bounded dispatch
tensor [E, C, H], exchanges slices with ``all_to_all``, runs its local
experts and sends the results home for the weighted combine. Overflow
beyond an expert's capacity is dropped (GShard semantics). On one device
the exchange is the identity, so ``moe_layer`` routes, packs, runs every
expert and combines here; ``ep > 1`` raises (expert parallelism comes
with multi-GPU serving, ROADMAP item 13). The reference's
``moe_params_shardings`` has no counterpart: there is no mesh to place
experts on.

The dispatch is index writes and gathers, not one-hot einsums: each kept
(token, pick) has its own slot, so a one-hot sum of one term and an index
write give the same values.

Shapes (n = ep = 1):
  h:    [T, H]      tokens
  wr:   [H, E]      router
  wg/wu:[E, H, I]   experts' gate/up
  wd:   [E, I, H]   experts' down
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class MoEConfig:
    hidden_size: int
    intermediate_size: int
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25

    def capacity(self, tokens_per_shard: int) -> int:
        """Per-expert, per-source-shard token slots. capacity_factor <= 0
        means DROPLESS: every (token, pick) gets a slot (C = T*K). That is
        the serving default: capacity drops make a token's activations
        depend on what it was co-batched with, which breaks prefix-cache
        reproducibility (a resend recomputing a chunk alone would get
        different KV than the original). Capacity-bounded mode is for
        throughput-oriented deployments that accept the approximation."""
        if self.capacity_factor <= 0:
            return max(tokens_per_shard * self.top_k, 1)
        c = math.ceil(
            tokens_per_shard * self.top_k * self.capacity_factor
            / self.num_experts
        )
        return max(c, 1)


def init_moe_params(cfg: MoEConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cpu") -> dict:
    """Random router and expert weights, drawn from a ``torch.Generator``
    seeded with ``seed`` at the reference's scales (1/sqrt(fan-in); the
    values differ from the JAX draw)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    E, H, I = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size

    def rnd(*s):
        return (torch.randn(s, generator=gen, device=device,
                            dtype=torch.float32) / math.sqrt(s[-2])).to(dtype)

    return {"wr": rnd(H, E), "wg": rnd(E, H, I), "wu": rnd(E, H, I),
            "wd": rnd(E, I, H)}


def _expert_ffn(x, wg, wu, wd):
    # x [E, S, H]; one batched product a projection: E lanes
    g = torch.bmm(x, wg)
    u = torch.bmm(x, wu)
    return torch.bmm(F.silu(g) * u, wd)


def _route(h, wr, top_k):
    """Top-k gate weights (renormalized, floored at 1e-9) and expert ids,
    both [T, K], from f32 router logits."""
    logits = (h @ wr).float()
    gates = torch.softmax(logits, dim=-1)
    gate_w, sel = torch.topk(gates, top_k, dim=-1)
    return gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9), sel


def moe_layer(h: torch.Tensor, params: dict, cfg: MoEConfig,
              ep: int = 1) -> torch.Tensor:
    """Top-k routed MoE FFN over a capacity-bounded dispatch [E, C, H]
    (the reference's ``moe_layer`` on a group of ``ep`` devices; only
    ``ep == 1`` runs here). Returns [T, H] in h's dtype."""
    T = h.shape[0]
    if T % ep:
        raise ValueError(f"tokens {T} not divisible by ep={ep}")
    if cfg.num_experts % ep:
        raise ValueError(
            f"experts {cfg.num_experts} not divisible by ep={ep}")
    if ep != 1:
        raise NotImplementedError(
            "expert parallelism (ep > 1) comes with multi-GPU serving "
            "(ROADMAP item 13)")
    E, K, C, H = cfg.num_experts, cfg.top_k, cfg.capacity(T), h.shape[1]
    gate_w, sel = _route(h, params["wr"], K)

    # ---- pack into the capacity-bounded dispatch tensor ----
    sel_f = sel.reshape(-1)                              # [T*K]
    onehot = F.one_hot(sel_f, E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    keep = pos < C                                       # arrival order
    # dropped picks go to a spare slot C, sliced away before the experts
    slot = torch.where(keep, pos, C)
    disp = h.new_zeros(E, C + 1, H)
    disp[sel_f, slot] = h.repeat_interleave(K, dim=0)

    # ---- the experts, one batched product a projection ----
    y = _expert_ffn(disp[:, :C], params["wg"], params["wu"], params["wd"])

    # ---- weighted combine ----
    picked = y[sel_f, slot.clamp(max=C - 1)]             # [T*K, H]
    picked = torch.where(keep[:, None], picked, 0).view(T, K, H)
    return torch.einsum("tk,tkh->th", gate_w.to(picked.dtype),
                        picked).to(h.dtype)


def moe_reference(h: torch.Tensor, params: dict,
                  cfg: MoEConfig) -> torch.Tensor:
    """Single-device dense reference (every expert on every token, no
    capacity drops) for testing."""
    gate_w, sel = _route(h, params["wr"], cfg.top_k)
    outs = _expert_ffn(
        h.expand(cfg.num_experts, *h.shape),
        params["wg"], params["wu"], params["wd"],
    )                                                    # [E, T, H]
    picked = outs[sel.T, torch.arange(h.shape[0], device=h.device)[None]]
    return torch.einsum("tk,kth->th", gate_w.to(picked.dtype),
                        picked).to(h.dtype)
