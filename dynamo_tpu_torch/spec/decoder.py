"""SpecDecoder: the engine-facing facade of speculation (port of the JAX
package's spec/decoder.py).

Owns the proposer (n-gram or draft model), the acceptance counters, the
acceptance-adaptive K controller, the acceptance gate and the verify
dispatch. The engine loop calls:

  eligible(req)           may this request speculate? (logprobs need the
                          fused round's logprob step)
  k_for(slot)/round_k()   the slot's effective K and the bucketed round
                          width covering a batch of slots
  m_for(slot)/round_m()   the same for the branch fan of a tree
  propose(slot, hist, k)  K candidate tokens: a host list (n-gram) or a
                          device tensor (draft model, per-slot path)
  propose_batch(...)      one batched draft for every speculating slot
  propose_tree(...)       an n-gram trie (tree speculation)
  propose_batch_tree(...) one batched comb draft
  verify(...)             the score + accept program of a batch
  verify_tree(...)        the tree score + accept + path commit
  on_result(...)          counters, the adaptive-K rate, the gate, and
                          the draft KV rolled back to the accepted length
  on_result_tree(...)     the same for a tree, with the branch histogram
  should_despec(slot)     has this slot's acceptance collapsed?
  should_gate(slot)       has it sat under the gate for a full window?
  release(slot)           slot freed or de-speculated: drop its state
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, pow2_cover
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.spec.proposer import DraftModelProposer, NGramProposer
from dynamo_tpu_torch.spec.verifier import spec_verify, spec_verify_tree


class AdaptiveKController:
    """Per-slot acceptance-adaptive speculation depth.

    Each verify result updates an EWMA of the slot's per-step acceptance
    fraction (accepted / k_used). The effective K walks one step at a
    time, +1 above ``grow_at`` and -1 below ``shrink_at``, within [k_min,
    k_max]; between the thresholds it holds. A slot whose rate stays at or
    below ``despec_at`` after ``min_obs`` observations should go back to
    the fused decode round: every verify there is a full forward for
    about one token.

    Under tree speculation the branch fan m walks the other way, within
    [1, m_max]: narrower when acceptance is high (the spine is reliable),
    wider when it is low (siblings catch a divergence at the first
    level)."""

    def __init__(self, k_max: int, k_min: int, *, grow_at: float,
                 shrink_at: float, despec_at: float, ewma: float,
                 min_obs: int, m_max: int = 1):
        if not 1 <= k_min <= k_max:
            raise ValueError("need 1 <= spec_min_k <= num_speculative_tokens")
        if not 0.0 <= despec_at <= shrink_at <= grow_at <= 1.0:
            raise ValueError(
                "need 0 <= despec_at <= shrink_at <= grow_at <= 1")
        if m_max < 1:
            raise ValueError("spec_branches must be >= 1")
        self.k_max = k_max
        self.k_min = k_min
        self.m_max = m_max
        self.grow_at = grow_at
        self.shrink_at = shrink_at
        self.despec_at = despec_at
        self.ewma = ewma
        self.min_obs = min_obs
        # slot-indexed state, grown on demand; NaN rate = never observed
        self._k = np.full(8, k_max, np.int32)
        self._m = np.full(8, m_max, np.int32)
        self._rate = np.full(8, np.nan, np.float64)
        self._obs = np.zeros(8, np.int32)
        self.grow_total = 0
        self.shrink_total = 0
        self.branch_grow_total = 0
        self.branch_shrink_total = 0

    def _ensure(self, slot: int) -> None:
        n = len(self._k)
        if slot < n:
            return
        grow = max(slot + 1, 2 * n)
        self._k = np.concatenate(
            [self._k, np.full(grow - n, self.k_max, np.int32)])
        self._m = np.concatenate(
            [self._m, np.full(grow - n, self.m_max, np.int32)])
        self._rate = np.concatenate(
            [self._rate, np.full(grow - n, np.nan, np.float64)])
        self._obs = np.concatenate([self._obs, np.zeros(grow - n, np.int32)])

    def k_for(self, slot: int) -> int:
        # optimistic start at k_max: static-K behaviour until evidence
        if slot >= len(self._k):
            return self.k_max
        return int(self._k[slot])

    def k_for_slots(self, slots) -> np.ndarray:
        slots = np.asarray(slots, np.int64)
        out = np.full(len(slots), self.k_max, np.int32)
        mask = slots < len(self._k)
        out[mask] = self._k[slots[mask]]
        return out

    def m_for(self, slot: int) -> int:
        # a fresh stream starts at m_max: it hedges wide until evidence
        if slot >= len(self._m):
            return self.m_max
        return int(self._m[slot])

    def rate_for(self, slot: int) -> Optional[float]:
        if slot >= len(self._rate) or np.isnan(self._rate[slot]):
            return None
        return float(self._rate[slot])

    def observe(self, slot: int, accepted: int, k_used: int) -> None:
        self._ensure(slot)
        step = accepted / max(k_used, 1)
        prev = float(self._rate[slot])
        rate = step if np.isnan(prev) else (
            self.ewma * prev + (1.0 - self.ewma) * step)
        self._rate[slot] = rate
        self._obs[slot] += 1
        k = int(self._k[slot])
        m = int(self._m[slot])
        if rate >= self.grow_at:
            # accepting well: deeper and narrower
            if k < self.k_max:
                self._k[slot] = k + 1
                self.grow_total += 1
            if m > 1:
                self._m[slot] = m - 1
                self.branch_shrink_total += 1
        elif rate <= self.shrink_at:
            # rejecting early: shallower, and hedged wider
            if k > self.k_min:
                self._k[slot] = k - 1
                self.shrink_total += 1
            if m < self.m_max:
                self._m[slot] = m + 1
                self.branch_grow_total += 1

    def should_despec(self, slot: int) -> bool:
        # a NaN rate (never observed) compares False: unknown is healthy
        return (slot < len(self._obs)
                and int(self._obs[slot]) >= self.min_obs
                and bool(self._rate[slot] <= self.despec_at))

    def release(self, slot: int) -> None:
        if slot < len(self._k):
            self._k[slot] = self.k_max
            self._m[slot] = self.m_max
            self._rate[slot] = np.nan
            self._obs[slot] = 0


class SpecDecoder:
    def __init__(
        self,
        config: ModelConfig,
        ecfg: EngineConfig,
        *,
        device: Union[str, torch.device] = "cuda",
        draft_config: Optional[ModelConfig] = None,
        draft_params: Any = None,
        rng_seed: int = 0,
    ):
        mode = ecfg.speculative
        if mode not in ("ngram", "draft"):
            raise ValueError(f"unknown speculative mode {mode!r}")
        if ecfg.num_speculative_tokens < 1:
            raise ValueError("num_speculative_tokens must be >= 1")
        self.mode = mode
        self.k = ecfg.num_speculative_tokens
        self.config = config
        self.ecfg = ecfg
        self.device = torch.device(device)
        # tree speculation: up to ``branches`` candidates at a divergence
        # point, verified under one tree-causal mask; the budget bounds
        # the packed node count (root included), 0 = the full comb
        self.tree = bool(ecfg.spec_tree)
        self.branches = max(int(ecfg.spec_branches), 1)
        self.tree_budget = (int(ecfg.spec_tree_budget)
                            or 1 + self.k * self.branches)
        if self.tree and self.tree_budget < 1 + self.k:
            raise ValueError(
                "spec_tree_budget must cover the root plus one full-"
                f"depth chain (need >= {1 + self.k})")
        self.adaptive: Optional[AdaptiveKController] = None
        if ecfg.spec_adaptive:
            self.adaptive = AdaptiveKController(
                self.k, min(ecfg.spec_min_k, self.k),
                grow_at=ecfg.spec_grow_threshold,
                shrink_at=ecfg.spec_shrink_threshold,
                despec_at=ecfg.spec_despec_threshold,
                ewma=ecfg.spec_rate_ewma,
                min_obs=ecfg.spec_min_observations,
                m_max=self.branches if self.tree else 1,
            )
        self.ngram: Optional[NGramProposer] = None
        self.draft: Optional[DraftModelProposer] = None
        if mode == "ngram":
            self.ngram = NGramProposer(self.k, ecfg.spec_ngram_max,
                                       ecfg.spec_ngram_min)
        else:
            if draft_config is None:
                raise ValueError("speculative=draft needs a draft_config")
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    "draft model must share the target tokenizer "
                    f"(vocab {draft_config.vocab_size} != "
                    f"{config.vocab_size})")
            self.draft = DraftModelProposer(
                draft_config, ecfg, device=self.device, params=draft_params,
                rng_seed=rng_seed + 1)
        # acceptance statistics (engine lifetime)
        self.proposed_total = 0
        self.accepted_total = 0
        self.verify_steps = 0
        self.reject_events = 0   # verify steps with a rejection
        self.despec_total = 0    # slots handed back to the fused round
        # program dispatches: batched drafting grows draft_dispatch_total
        # once a round, the per-slot path k times a slot
        self.draft_dispatch_total = 0
        self.verify_dispatch_total = 0
        # tree statistics
        self.tree_nodes_total = 0        # tree nodes scored (root excluded)
        self.tree_path_len_total = 0     # accepted path tokens
        self.tree_verify_steps = 0
        # accepted nodes by branch ordinal (position among same-parent
        # siblings, index order; 0 is the spine or the best candidate)
        self.branch_accept_hist = np.zeros(self.branches, np.int64)
        # acceptance gate: a stream whose acceptance EWMA sits below
        # spec_gate_acceptance for spec_gate_window consecutive verify
        # steps de-speculates; the engine may re-arm it later
        self.gate_at = float(ecfg.spec_gate_acceptance)
        self.gate_window = max(int(ecfg.spec_gate_window), 1)
        self.gated_despec_total = 0
        self.rearm_total = 0
        self._gate_rate: dict[int, float] = {}
        self._gate_low: dict[int, int] = {}

    # ------------------------------------------------------------------

    def eligible(self, req: Any) -> bool:
        """Logprob requests stay on the fused round (its logprob step).
        Penalized requests speculate: accept_tokens_penalized advances
        their counts histogram per accepted token."""
        return req.output_options.logprobs is None

    @staticmethod
    def penalized(req: Any) -> bool:
        so = req.sampling_options
        return ((so.frequency_penalty or 0.0) != 0.0
                or (so.presence_penalty or 0.0) != 0.0
                or (so.repetition_penalty or 1.0) != 1.0)

    # ---- adaptive K ----

    def k_for(self, slot: int) -> int:
        if self.adaptive is None:
            return self.k
        return self.adaptive.k_for(slot)

    def round_k(self, ks: list[int]) -> int:
        """The round's draft and verify width: the participants' largest
        effective K, bucketed up to a power of two (a bounded set of
        shapes) and clamped to the configured K."""
        return min(pow2_cover(max(ks)), self.k)

    def should_despec(self, slot: int) -> bool:
        return self.adaptive is not None and self.adaptive.should_despec(slot)

    def m_for(self, slot: int) -> int:
        """The slot's effective branch fan (1 without a tree)."""
        if not self.tree:
            return 1
        if self.adaptive is None:
            return self.branches
        return self.adaptive.m_for(slot)

    def round_m(self, ms: list[int]) -> int:
        """The round's branch fan: the largest effective m, bucketed up
        to a power of two and clamped to the configured fan, as round_k."""
        return min(pow2_cover(max(ms)), self.branches)

    # ---- acceptance gate ----

    def observe_gate(self, slot: int, accepted: int, k_used: int) -> None:
        if self.gate_at <= 0.0:
            return
        step = accepted / max(k_used, 1)
        prev = self._gate_rate.get(slot)
        ew = self.ecfg.spec_rate_ewma
        rate = step if prev is None else ew * prev + (1.0 - ew) * step
        self._gate_rate[slot] = rate
        if rate < self.gate_at:
            self._gate_low[slot] = self._gate_low.get(slot, 0) + 1
        else:
            self._gate_low[slot] = 0

    def should_gate(self, slot: int) -> bool:
        return (self.gate_at > 0.0
                and self._gate_low.get(slot, 0) >= self.gate_window)

    def on_gated_despec(self, slot: int) -> None:
        self.gated_despec_total += 1
        self.on_despec(slot)

    def on_rearm(self, slot: int) -> None:
        self.rearm_total += 1

    # ---- proposing and verifying ----

    def propose(self, slot: int, history: list[int],
                k: int) -> Union[list[int], torch.Tensor]:
        """Per-slot proposal: the n-gram lookup, or the per-slot draft
        path of ``spec_batch_draft=False`` (1 catch-up + k-1 programs)."""
        if self.ngram is not None:
            return self.ngram.propose(history, k)
        self.draft_dispatch_total += k
        return self.draft.propose(slot, history, k)

    def propose_batch(self, rows: list[tuple[int, list[int]]],
                      k: int) -> torch.Tensor:
        """One batched draft for every speculating slot."""
        self.draft_dispatch_total += 1
        return self.draft.propose_batch(rows, k)

    def propose_tree(self, history: list[int], depth: int,
                     branches: int) -> tuple[list[int], list[int]]:
        """An n-gram trie: (tokens, parents) without the root, at most
        tree_budget - 1 nodes (NGramProposer.propose_tree)."""
        return self.ngram.propose_tree(history, depth, branches,
                                       self.tree_budget)

    def propose_batch_tree(self, rows: list[tuple[int, list[int]]], k: int,
                           m: int) -> torch.Tensor:
        """One batched comb draft for every speculating slot: [n, k*m],
        whose parents are proposer.comb_parents(k, m)."""
        self.draft_dispatch_total += 1
        return self.draft.propose_batch(rows, k, branches=m)

    def verify(self, params: Any, ctx: Any, tokens: torch.Tensor,
               draft: Optional[torch.Tensor], slots: list[int],
               q_starts: list[int], seq_lens: list[int], keys: torch.Tensor,
               temps: torch.Tensor, top_ks: torch.Tensor,
               top_ps: torch.Tensor, penalties=None) -> torch.Tensor:
        """The score + accept program (verifier.spec_verify) on device
        tensors; ``penalties`` is None when no row carries any, else
        (counts [B, V], freq [B], pres [B], rep [B]). Returns the packed
        [B, K+4] result."""
        self.verify_dispatch_total += 1
        return spec_verify(
            self.config, params, ctx, tokens, draft, slots, q_starts,
            seq_lens, keys, temps, top_ks, top_ps, self.ecfg.max_top_k,
            llama.spec_span(max(q_starts), self.ecfg.max_context),
            penalties)

    def verify_tree(self, params: Any, ctx: Any, tokens: torch.Tensor,
                    draft: Optional[torch.Tensor], parents: torch.Tensor,
                    slots: list[int], q_starts: list[int],
                    seq_lens: list[int], keys: torch.Tensor,
                    temps: torch.Tensor, top_ks: torch.Tensor,
                    top_ps: torch.Tensor, d_max: int,
                    penalties=None) -> torch.Tensor:
        """The tree score + accept + path commit
        (verifier.spec_verify_tree) on device tensors. Returns the packed
        [B, 2*d_max + 4] result."""
        self.verify_dispatch_total += 1
        return spec_verify_tree(
            self.config, params, ctx, tokens, draft, parents, slots,
            q_starts, seq_lens, keys, temps, top_ks, top_ps,
            self.ecfg.max_top_k,
            llama.spec_span(max(q_starts), self.ecfg.max_context), d_max,
            penalties)

    # ---- results ----

    def on_result(self, slot: int, hist_len: int, accepted: int,
                  k_used: int) -> None:
        """One verify step landed: ``accepted`` of the round's ``k_used``
        proposals matched; the slot's true sequence is hist_len +
        accepted + 1 tokens (the bonus is pending, its KV unwritten)."""
        self.proposed_total += k_used
        self.accepted_total += accepted
        self.verify_steps += 1
        if accepted < k_used:
            self.reject_events += 1
        if self.adaptive is not None:
            self.adaptive.observe(slot, accepted, k_used)
        self.observe_gate(slot, accepted, k_used)
        if self.draft is not None:
            self.draft.truncate(slot, hist_len + accepted)

    def on_result_tree(self, slot: int, hist_len: int, accepted: int,
                       d_used: int, m_used: int, nodes: int,
                       path_nodes: list[int], parents: list[int]) -> None:
        """One tree verify landed: ``accepted`` path tokens of a
        depth-``d_used`` tree of ``nodes`` proposal nodes; ``path_nodes``
        is the accepted node chain (depth 1..) and ``parents`` the row's
        whole parent list (root at 0). The rate stays tokens per depth
        (accepted / d_used), the currency of the linear path and of the
        controller's thresholds."""
        self.proposed_total += d_used
        self.accepted_total += accepted
        self.verify_steps += 1
        self.tree_verify_steps += 1
        self.tree_nodes_total += nodes
        self.tree_path_len_total += accepted
        if accepted < d_used:
            self.reject_events += 1
        # each accepted node's ordinal among its same-parent siblings
        for node in path_nodes[:accepted]:
            par = parents[node]
            ordinal = sum(1 for j in range(1, node) if parents[j] == par)
            if ordinal < len(self.branch_accept_hist):
                self.branch_accept_hist[ordinal] += 1
        if self.adaptive is not None:
            self.adaptive.observe(slot, accepted, d_used)
        self.observe_gate(slot, accepted, d_used)
        if self.draft is not None:
            # only the comb's spine has KV in the draft region: the valid
            # draft prefix is the accepted path's run along it (the spine
            # node at depth t+1 is 1 + t*m)
            spine = 0
            for t, node in enumerate(path_nodes[:accepted]):
                if node != 1 + t * m_used:
                    break
                spine += 1
            self.draft.truncate(slot, hist_len + spine)

    def on_despec(self, slot: int) -> None:
        self.despec_total += 1
        self.release(slot)

    def release(self, slot: int) -> None:
        if self.draft is not None:
            self.draft.release(slot)
        if self.adaptive is not None:
            self.adaptive.release(slot)
        self._gate_rate.pop(slot, None)
        self._gate_low.pop(slot, None)

    def acceptance_rate(self) -> float:
        return self.accepted_total / max(self.proposed_total, 1)

    def effective_k_mean(self, slots) -> float:
        """Mean effective K over the given speculating slots; 0 when none
        speculates."""
        return self.effective_k_dist(slots)[0]

    def effective_k_dist(self, slots) -> tuple[float, float, float]:
        """(mean, p50, p95) of the effective K over the given speculating
        slots: one hot stream at the cap hides in a mean pulled down by
        many collapsed ones."""
        if len(slots) == 0:
            return 0.0, 0.0, 0.0
        if self.adaptive is None:
            k = float(self.k)
            return k, k, k
        ks = self.adaptive.k_for_slots(slots).astype(np.float64)
        return (float(ks.mean()), float(np.percentile(ks, 50)),
                float(np.percentile(ks, 95)))

    def tree_mean_path_len(self) -> float:
        return self.tree_path_len_total / max(self.tree_verify_steps, 1)

    def stats(self) -> dict[str, Any]:
        out = {
            "mode": self.mode,
            "k": self.k,
            "spec_proposed_total": self.proposed_total,
            "spec_accepted_total": self.accepted_total,
            "spec_verify_steps": self.verify_steps,
            "spec_reject_events": self.reject_events,
            "spec_despec_total": self.despec_total,
            "spec_acceptance_rate": self.acceptance_rate(),
            "spec_draft_dispatch_total": self.draft_dispatch_total,
            "spec_verify_dispatch_total": self.verify_dispatch_total,
            "spec_adaptive": self.adaptive is not None,
            "spec_tree": self.tree,
            "spec_branches": self.branches,
            "spec_tree_budget": self.tree_budget,
            "spec_tree_nodes_total": self.tree_nodes_total,
            "spec_tree_accepted_path_len_total": self.tree_path_len_total,
            "spec_tree_verify_steps": self.tree_verify_steps,
            "spec_tree_mean_path_len": self.tree_mean_path_len(),
            "spec_branch_accept_hist": self.branch_accept_hist.tolist(),
            "spec_gated_despec_total": self.gated_despec_total,
            "spec_rearm_total": self.rearm_total,
        }
        if self.adaptive is not None:
            out["spec_k_grow_total"] = self.adaptive.grow_total
            out["spec_k_shrink_total"] = self.adaptive.shrink_total
            out["spec_branch_grow_total"] = self.adaptive.branch_grow_total
            out["spec_branch_shrink_total"] = (
                self.adaptive.branch_shrink_total)
        return out
