"""Speculative verification on the device (port of the JAX package's
spec/verifier.py, the linear chain).

``spec_verify`` scores the pending token plus the K proposed tokens of
every speculating slot in one batched forward (``llama.batch_score``, the
batch_prefill shape with logits for every row), then runs acceptance on
the device. Only the packed result, accepted tokens [B, K+1], counts [B]
and the advanced PRNG keys [B, 2], goes back to the host; the logits
stay on the device.

Acceptance semantics (toks[:, 0] is the pending token, toks[:, 1:] the
proposals; logits row t scores the token following toks[:, t]):

  greedy (temp<=0)   longest-prefix match against the argmax of the
                     (penalty-adjusted) logits; the bonus token is the
                     argmax of the first mismatching row, what
                     non-speculative greedy decoding would have produced.
  sampled (temp>0)   rejection sampling against the target distribution
                     (the masking order of sampling.sample_step). Each
                     proposal is a point-mass draft: accept d with
                     probability p(d); on rejection, resample from p with
                     d masked out. Draws consume the slot's PRNG key
                     stream exactly as the JAX version does: new_key, sub
                     = split(key); subs = split(sub, K+1); proposal i
                     draws uniform(subs[i]); the bonus draws
                     categorical(subs[K]). So a seeded request draws the
                     reference's tokens.

Penalties: ``accept_tokens_penalized`` advances the slot's output-token
counts histogram along the accepted prefix, row by row, as the fused
round advances it token by token; it consumes the same key stream.

Left out here: tree verification (``tree_meta``, ``accept_tree``,
``accept_tree_penalized``, ``spec_verify_tree``), ROADMAP item 7b.
"""
from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.sampling import NEG_INF
from dynamo_tpu_torch.models import llama


def _target_dist(logits: torch.Tensor, temp: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor, max_top_k: int):
    """(top-k lane ids, scaled values, final mask, p) of ``logits`` [B, ...,
    V] under each row's knobs ([B]): the masking order of sample_step
    (top-k lanes, temperature scale, nucleus mask)."""
    extra = (1,) * (logits.dim() - 1)
    temps = torch.clamp(temp, min=1e-6).view(-1, *extra)
    vals, idxs = torch.topk(logits, max_top_k, dim=-1)
    scaled = vals / temps
    pos = torch.arange(max_top_k, device=logits.device)
    k_eff = torch.where(top_k <= 0, max_top_k, top_k)
    mask_k = pos < torch.clamp(k_eff, max=max_top_k).view(-1, *extra)
    probs = torch.softmax(torch.where(mask_k, scaled, NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    mask_p = (cum - probs) < top_p.view(-1, *extra)
    final_mask = mask_k & mask_p
    p = torch.softmax(torch.where(final_mask, scaled, NEG_INF), dim=-1)
    return idxs, scaled, final_mask, p


def _emit(proposed: torch.Tensor, a: torch.Tensor,
          bonus: torch.Tensor) -> torch.Tensor:
    """[B, K+1]: the first ``a`` proposals, the bonus at ``a``, zeros
    after."""
    B, K = proposed.shape
    idx = torch.arange(K + 1, device=proposed.device)[None, :]
    pad = torch.cat([proposed, proposed.new_zeros(B, 1)], dim=1)
    return torch.where(idx < a[:, None], pad,
                       torch.where(idx == a[:, None], bonus[:, None], 0)
                       ).to(torch.int32)


def accept_tokens(
    logits: torch.Tensor,   # [B, K+1, V] f32 raw target logits
    toks: torch.Tensor,     # [B, K+1] int — pending token, then K proposals
    keys: torch.Tensor,     # [B, 2] int64 threefry keys (uint32 words)
    temp: torch.Tensor,     # [B] f32; <=0 greedy
    top_k: torch.Tensor,    # [B] int; 0 disables
    top_p: torch.Tensor,    # [B] f32; 1.0 disables
    max_top_k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Acceptance for every row (the JAX version vmaps a per-slot
    function). Returns (out [B, K+1] int32, n_out [B] int64, new_keys
    [B, 2]): out[:n_out] are the emitted tokens, the accepted proposal
    prefix plus one bonus."""
    B, T, _ = logits.shape
    K = T - 1
    dev = logits.device
    toks = toks.long()
    proposed = toks[:, 1:]                                    # [B, K]
    greedy = torch.argmax(logits, dim=-1)                     # [B, T]
    match_g = proposed == greedy[:, :K]
    idxs, scaled, final_mask, p = _target_dist(logits, temp, top_k, top_p,
                                               max_top_k)
    new_keys, sub = sampling.split_keys(keys)
    subs = sampling.split_keys_n(sub, T)                      # [B, T, 2]
    # accept proposal i with probability p_i(proposed_i); a proposal
    # outside the masked support has p=0 and always rejects
    lane_hit = (idxs[:, :K] == proposed[..., None]) & final_mask[:, :K]
    p_prop = torch.where(lane_hit, p[:, :K], 0.0).sum(dim=-1)  # [B, K]
    u = sampling.uniform(subs[:, :K].reshape(-1, 2)).view(B, K)
    match = torch.where((temp <= 0.0)[:, None], match_g, u < p_prop)
    a = torch.cumprod(match.long(), dim=-1).sum(dim=-1)       # [B] 0..K

    # bonus from row a: greedy argmax, or the leftover resample (row a's
    # distribution with the rejected proposal masked; when a == K
    # nothing was rejected and the -1 pad masks no lane)
    rows = torch.arange(B, device=dev)
    prop_pad = torch.cat([proposed, proposed.new_full((B, 1), -1)], dim=1)
    row_scaled = torch.where(final_mask, scaled, NEG_INF)[rows, a]
    row_idxs = idxs[rows, a]                                  # [B, Kt]
    row_final = torch.where(row_idxs == prop_pad[rows, a][:, None],
                            NEG_INF, row_scaled)
    choice = sampling.categorical(subs[:, K], row_final)
    bonus_s = row_idxs.gather(1, choice[:, None])[:, 0]
    bonus = torch.where(temp <= 0.0, greedy[rows, a], bonus_s)
    return _emit(proposed, a, bonus), a + 1, new_keys


def accept_tokens_penalized(
    logits: torch.Tensor,   # [B, K+1, V] f32 raw target logits
    toks: torch.Tensor,     # [B, K+1] int
    keys: torch.Tensor,     # [B, 2] int64
    temp: torch.Tensor,     # [B] f32
    top_k: torch.Tensor,    # [B] int
    top_p: torch.Tensor,    # [B] f32
    counts: torch.Tensor,   # [B, V] int32 output-token histogram so far
    freq: torch.Tensor,     # [B] f32 frequency penalty
    pres: torch.Tensor,     # [B] f32 presence penalty
    rep: torch.Tensor,      # [B] f32 repetition penalty (1.0 disables)
    max_top_k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Penalty-aware acceptance: row t's logits are penalized with the
    counts as of the accepted chain through row t-1 (the JAX version's
    lax.scan is the loop over rows here), so greedy output under
    penalties is token-identical to the fused round's. Consumes the PRNG
    stream of accept_tokens lane for lane. ``counts`` is not modified."""
    B, T, _ = logits.shape
    K = T - 1
    dev = logits.device
    toks = toks.long()
    proposed = toks[:, 1:]
    prop_pad = torch.cat([proposed, proposed.new_full((B, 1), -1)], dim=1)
    new_keys, sub = sampling.split_keys(keys)
    subs = sampling.split_keys_n(sub, T)
    bonus_key = subs[:, K]
    rows = torch.arange(B, device=dev)
    counts_t = counts.clone()
    still = torch.ones(B, dtype=torch.bool, device=dev)
    greedy_rows = temp <= 0.0
    accepts, bonuses = [], []
    for t in range(T):
        # penalties at this position (sampling.apply_penalties, one row)
        seen = counts_t > 0
        lr = logits[:, t] - freq[:, None] * counts_t.float()
        lr = lr - pres[:, None] * seen.float()
        pen = torch.where(lr > 0, lr / rep[:, None], lr * rep[:, None])
        lr = torch.where(seen, pen, lr)
        greedy_t = torch.argmax(lr, dim=-1)
        idxs, scaled, final_mask, p = _target_dist(lr, temp, top_k, top_p,
                                                   max_top_k)
        prop_t = prop_pad[:, t]
        lane_hit = (idxs == prop_t[:, None]) & final_mask
        p_prop = torch.where(lane_hit, p, 0.0).sum(dim=-1)
        u = sampling.uniform(subs[:, t])
        match_t = torch.where(greedy_rows, prop_t == greedy_t, u < p_prop)
        accept_t = still & match_t
        # the bonus candidate of this row (used only when it is the first
        # mismatch): the leftover resample, the proposal masked
        row_final = torch.where(idxs == prop_t[:, None], NEG_INF,
                                torch.where(final_mask, scaled, NEG_INF))
        choice = sampling.categorical(bonus_key, row_final)
        bonuses.append(torch.where(
            greedy_rows, greedy_t, idxs.gather(1, choice[:, None])[:, 0]))
        # the histogram advances only along the still-accepted chain
        delta = (accept_t & (prop_t >= 0)).to(counts_t.dtype)
        counts_t[rows, torch.clamp(prop_t, min=0)] += delta
        accepts.append(accept_t)
        still = accept_t
    a = torch.stack(accepts[:K], dim=1).long().sum(dim=-1)   # [B] 0..K
    bonus = torch.stack(bonuses, dim=1)[rows, a]
    return _emit(proposed, a, bonus), a + 1, new_keys


def spec_verify(
    config,
    params,
    ctx: llama.Cache,
    tokens: torch.Tensor,   # [B, K+1] int on the device — col 0 pending
    draft: Optional[torch.Tensor],  # [B, K] device draft tokens, or None:
                            # spliced into cols 1: on the device (a batched
                            # draft feeds the verify with no host trip)
    slots: list[int],
    q_starts: list[int],    # region KV length per slot
    seq_lens: list[int],    # q_start + K + 1
    keys: torch.Tensor,     # [B, 2] int64
    temps: torch.Tensor,    # [B] f32
    top_ks: torch.Tensor,   # [B] int32
    top_ps: torch.Tensor,   # [B] f32
    max_top_k: int,
    ctx_span: int,          # prior-context window (llama.spec_span)
    penalties=None,         # None, or (counts [B, V], freq, pres, rep [B])
) -> torch.Tensor:
    """Score + accept for every speculating row, ON the device. The
    forward writes all K+1 KV rows of each slot at [q_start, q_start+K+1)
    IN PLACE; the host commits the first n_out (rollback is pointer
    truncation, see llama.batch_score). Returns one packed int64 tensor
    [B, K+4]: out [:, :K+1], n_out [:, K+1], new keys [:, K+2:], so the
    round's result comes back in one copy."""
    if draft is not None:
        tokens = tokens.clone()
        tokens[:, 1:] = draft
    logits = llama.batch_score(config, params, ctx, tokens, slots, q_starts,
                               seq_lens, ctx_span)
    if penalties is None:
        out, n_out, new_keys = accept_tokens(
            logits, tokens, keys, temps, top_ks, top_ps, max_top_k)
    else:
        out, n_out, new_keys = accept_tokens_penalized(
            logits, tokens, keys, temps, top_ks, top_ps, *penalties,
            max_top_k=max_top_k)
    return torch.cat([out.long(), n_out[:, None].long(), new_keys], dim=1)
