"""Speculative-token proposers (port of the JAX package's
spec/proposer.py).

Two strategies behind one contract, ``history`` being the request's
full committed sequence (prompt + emitted output, the pending token
last):

  - NGramProposer: model-free prompt-lookup decoding. Matches the tail
    n-gram of the history against an earlier occurrence and proposes the
    tokens that followed it. Host code, deterministic, no device cost.
  - DraftModelProposer: a small model sharing the target's vocabulary,
    run through the port's forward with a private ctx region per slot:
    one catch-up chunk syncs the region with the slot's history, then
    greedy single-token steps. The argmax chain stays on the device and
    feeds the verifier without a host round trip.

Under tree speculation the n-gram proposer merges its top-M
continuations into a token trie (``propose_tree``), and the draft model
emits a comb, M candidates at every depth off its greedy spine, from the
same batched draft (``comb_parents`` gives its parent pointers).

Acceptance treats every proposal as a point-mass draft, so how tokens
are proposed never biases the output distribution: a bad proposer only
lowers the acceptance rate.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, pow2_cover
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a stream sync (pinned staging,
    a non-blocking copy)."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class NGramProposer:
    """Prompt-lookup proposer: the continuation of the most recent
    earlier occurrence of the history's tail n-gram.

    Tries n = max_n .. min_n; for each n, scans for the rightmost earlier
    match within a bounded lookback window (the scan runs on the engine
    loop once per verify step). With no match it proposes zeros, which
    verify like any other draft and are simply rejected unless the target
    agrees."""

    def __init__(self, k: int, max_n: int = 3, min_n: int = 1,
                 max_lookback: int = 1024):
        if k < 1:
            raise ValueError("num_speculative_tokens must be >= 1")
        if min_n < 1 or max_n < min_n:
            raise ValueError("need 1 <= min_n <= max_n")
        self.k = k
        self.max_n = max_n
        self.min_n = min_n
        self.max_lookback = max_lookback

    def propose(self, history: list[int], k: int = 0) -> list[int]:
        """Propose ``k`` tokens (0 = the constructor's K); callers with
        adaptive K pass the round's width."""
        k = k or self.k
        hist = history[-self.max_lookback:]
        L = len(hist)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            tail = hist[-n:]
            for j in range(L - n - 1, -1, -1):
                if hist[j: j + n] == tail:
                    cont = hist[j + n: j + n + k]
                    return cont + [0] * (k - len(cont))
        return [0] * k

    def propose_tree(self, history: list[int], depth: int, branches: int,
                     budget: int) -> tuple[list[int], list[int]]:
        """Up to ``branches`` distinct continuations of the tail n-gram
        (longest n first, most recent first: propose's order), merged
        into one token trie: a shared prefix is one node, so continuations
        fork where they diverge.

        Returns (tokens, parents) without the root: parent 0 is the
        pending token, any other the 1-based index of an earlier returned
        node, ready to pack behind the verifier's node 0. At most
        ``budget - 1`` nodes (the root takes one); with no match, the
        linear path's zero chain."""
        hist = history[-self.max_lookback:]
        L = len(hist)
        conts: list[list[int]] = []
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            tail = hist[-n:]
            for j in range(L - n - 1, -1, -1):
                if hist[j: j + n] == tail:
                    cont = hist[j + n: j + n + depth]
                    if cont and cont not in conts:
                        conts.append(cont)
                        if len(conts) >= branches:
                            break
            if len(conts) >= branches:
                break
        if not conts:
            conts = [[0] * depth]
        tokens: list[int] = []
        parents: list[int] = []
        children: dict[tuple[int, int], int] = {}  # (parent, tok) -> node
        for cont in conts:
            parent = 0  # the pending-token root
            for tok in cont:
                node = children.get((parent, tok))
                if node is None:
                    if len(tokens) >= budget - 1:
                        break
                    tokens.append(tok)
                    parents.append(parent)
                    node = len(tokens)  # 1-based: 0 is the root
                    children[(parent, tok)] = node
                parent = node
        return tokens, parents


def comb_parents(k: int, m: int) -> list[int]:
    """Parent pointers of the comb llama.batch_draft emits for m > 1:
    depth k, m candidates at every level, only the spine extended. Node
    order is the drafted [B, k*m] columns': level s holds nodes 1 + s*m
    .. s*m + m, the first of them the spine. Returns the whole [1 + k*m]
    list, the root's -1 included (pad with -2 up to a tree budget)."""
    parents = [-1]
    for s in range(k):
        parents.extend([0 if s == 0 else 1 + (s - 1) * m] * m)
    return parents


class DraftModelProposer:
    """Draft-model proposer with a private contiguous ctx region (dense,
    ``ecfg.cache_dtype``) of one lane per engine slot.

    ``pos[slot]`` is how many tokens of the slot's true history the
    region holds at [0, pos): the rollback pointer. ``truncate`` after a
    verify lowers it to the accepted length; the dead rows beyond it are
    overwritten by the next catch-up chunk (attention masks by seq_len,
    so they are never read meanwhile)."""

    def __init__(self, config: ModelConfig, ecfg: EngineConfig, *,
                 device: torch.device, params: Any = None,
                 rng_seed: int = 0):
        self.config = config
        self.ecfg = ecfg
        self.device = device
        if params is None:
            params = llama.init_params(config, rng_seed, device)
        self.params = params
        self.ctx = llama.init_ctx(config, ecfg.max_decode_slots,
                                  ecfg.max_context,
                                  llama.torch_dtype(ecfg.cache_dtype),
                                  device)
        self.pos = np.zeros(ecfg.max_decode_slots, np.int64)

    def propose(self, slot: int, history: list[int],
                k: int) -> torch.Tensor:
        """Draft k tokens for ``history`` one program at a time (the
        per-slot path of ``spec_batch_draft=False``): 1 catch-up prefill
        and k-1 single-token prefills. Returns a device [k] tensor."""
        start = int(self.pos[slot])
        chunk = history[start:]
        assert chunk, "history must extend past the draft position"
        # the padded width never overflows the region (the engine
        # de-speculates before the history can outgrow it)
        w = min(pow2_cover(len(chunk), 8), self.ecfg.max_context - start)
        toks = np.zeros(w, np.int32)
        toks[: len(chunk)] = chunk
        logits = llama.prefill(self.config, self.params, self.ctx,
                               _upload(toks, self.device), slot, start,
                               len(history))
        drafted = [torch.argmax(logits)]
        pos = len(history)
        for _ in range(k - 1):
            logits = llama.prefill(self.config, self.params, self.ctx,
                                   drafted[-1][None], slot, pos, pos + 1)
            drafted.append(torch.argmax(logits))
            pos += 1
        # KV written: history plus drafted[:-1]
        self.pos[slot] = len(history) + k - 1
        return torch.stack(drafted)

    def propose_batch(self, rows: list[tuple[int, list[int]]], k: int,
                      branches: int = 1) -> torch.Tensor:
        """Draft k tokens for every ``(slot, history)`` row in one queued
        batch (llama.batch_draft): the per-row catch-up chunks as one [n,
        T] forward, then k-1 batched single-token steps. Returns [n, k] on
        the device, row-aligned with the verify batch. The JAX version
        pads to the engine's slot count with scratch-lane rows; here only
        the live rows run. ``branches > 1`` drafts the comb (see
        comb_parents) at the same cost: [n, k * branches], level-major;
        only the spine's KV lands in the region, so the rollback pointer
        below is the same."""
        S = self.ecfg.max_context
        chunks: list[tuple[int, list[int], int]] = []
        max_len = 1
        for slot, hist in rows:
            start = int(self.pos[slot])
            assert len(hist) > start, \
                "history must extend past the draft position"
            chunks.append((slot, hist, start))
            max_len = max(max_len, len(hist) - start)
        # one shared pow2 width clamped to the region: a row whose start +
        # T would overflow re-feeds a little history instead (recomputing
        # identical KV)
        T = min(pow2_cover(max_len, 8), S)
        toks = np.zeros((len(chunks), T), np.int32)
        slots, q_starts, seq_lens = [], [], []
        for j, (slot, hist, start) in enumerate(chunks):
            start_eff = min(start, S - T)
            chunk = hist[start_eff:]
            toks[j, : len(chunk)] = chunk
            slots.append(slot)
            q_starts.append(start_eff)
            seq_lens.append(len(hist))
        # the last step attends positions below max(seq_lens) + k - 2
        span = llama.spec_span(max(max(q_starts), max(seq_lens) + k - 2), S)
        drafted = llama.batch_draft(self.config, self.params, self.ctx,
                                    _upload(toks, self.device), slots,
                                    q_starts, seq_lens, span, k, branches)
        for slot, hist, _ in chunks:
            self.pos[slot] = len(hist) + k - 1
        return drafted

    def truncate(self, slot: int, n_valid: int) -> None:
        """Rollback after a verify: only the first ``n_valid`` tokens of
        the slot's draft KV match the true sequence."""
        self.pos[slot] = min(int(self.pos[slot]), n_valid)

    def release(self, slot: int) -> None:
        """Slot freed or de-speculated: its region restarts from 0."""
        self.pos[slot] = 0
