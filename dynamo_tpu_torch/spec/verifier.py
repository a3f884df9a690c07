"""Speculative verification on the device (port of the JAX package's
spec/verifier.py).

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

Tree verification (``spec_verify_tree``): the proposals form a packed
token tree a row, flat tokens [T] and parent pointers [T] (node 0 the
pending token with parent -1, a proposal node pointing at a lower index,
padding -2). ``tree_meta`` derives node depths and the ancestor-or-self
visibility matrix on the device; ``llama.batch_score_tree`` scores every
node under that tree-causal mask in one forward; acceptance walks the
tree level by level, picking the deepest root-to-leaf path that matches
(greedy) or survives sequential multi-draft rejection sampling
(sampled); only that path's KV rows are committed
(``llama.commit_tree_path``), so rollback stays pointer truncation. One
packed [B, 2*d_max + 4] tensor returns to the host.

The tree's key stream (its own, not the chain's): new_key, sub =
split(key); subs = split(sub, T); node j draws uniform(subs[j]) whether
or not it is tried; the bonus draws categorical(subs[0]) (node 0, the
root, is never a candidate). The penalized walk consumes the same
stream, so a row with zero counts and identity penalties draws the same
on either.
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


def _penalize(row: torch.Tensor, counts: torch.Tensor, freq: torch.Tensor,
              pres: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """sampling.apply_penalties of one row a slot ([B, V])."""
    seen = counts > 0
    lr = row - freq[:, None] * counts.float()
    lr = lr - pres[:, None] * seen.float()
    pen = torch.where(lr > 0, lr / rep[:, None], lr * rep[:, None])
    return torch.where(seen, pen, lr)


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
        # penalties at this position
        lr = _penalize(logits[:, t], counts_t, freq, pres, rep)
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


# ---------------------------------------------------------------------------
# tree speculation


def tree_meta(parents: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(depth [B, T] int64, anc [B, T, T] bool, valid [B, T] bool) of
    parent pointers [B, T] (-1 root, -2 padding, else a lower index), by
    T-1 steps of a simultaneous pointer walk on the device. A padding
    node has depth -1 and an empty anc row (it sees no chunk key);
    anc[i, j] is ancestor-or-self, the tree-causal in-chunk visibility."""
    parents = parents.long()
    B, T = parents.shape
    idx = torch.arange(T, device=parents.device)
    valid = parents >= -1
    anc = (idx[:, None] == idx[None, :])[None] & valid[..., None]
    depth = torch.where(valid, 0, -1)
    cur = parents
    for _ in range(T - 1):
        # cur[i]: i's current ancestor pointer; negative once the walk ends
        anc = anc | (cur[..., None] == idx)
        depth = depth + (cur >= 0).long()
        cur = torch.where(cur >= 0, parents.gather(1, cur.clamp(min=0)), cur)
    return depth, anc, valid


def _accept_tree_walk(
    logits: torch.Tensor,   # [B, T, V] f32; row t scores the token AFTER
                            # node t
    toks: torch.Tensor,     # [B, T] node tokens (node 0 = pending)
    parents: torch.Tensor,  # [B, T]
    valid: torch.Tensor,    # [B, T] bool
    keys: torch.Tensor,     # [B, 2] int64
    temp: torch.Tensor,     # [B] f32
    top_k: torch.Tensor,    # [B] int
    top_p: torch.Tensor,    # [B] f32
    pen,                    # None, or (counts [B, V], freq, pres, rep [B])
    max_top_k: int,
    d_max: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tree acceptance for every row (the JAX version vmaps a per-slot
    walk). From the root, at each level the current node's children are
    tried in index order: greedy takes the lowest-index child carrying
    the row's argmax; sampled runs sequential multi-draft rejection (a
    child with token d accepts iff u_d * (1 - mass of siblings rejected
    so far at this node) < p(d), a duplicate-token sibling seeing p = 0),
    which keeps every emitted token an exact sample of the target. The
    walk stops at the first level with no accepted child; the bonus is
    that node's argmax, or a resample of its residual (the rejected
    siblings' tokens masked). Under ``pen`` the counts advance along the
    accepted path, so each row is penalized as the fused round would.

    Returns (out [B, d_max+1] emitted tokens, path [B, d_max+1] node
    indices with path[:, 0] = 0, n_out [B], new keys [B, 2])."""
    B, T, _ = logits.shape
    dev = logits.device
    toks = toks.long()
    parents = parents.long()
    idx = torch.arange(T, device=dev)
    rows = torch.arange(B, device=dev)
    greedy_rows = temp <= 0.0
    new_keys, sub = sampling.split_keys(keys)
    subs = sampling.split_keys_n(sub, T)                     # [B, T, 2]
    u = sampling.uniform(subs.reshape(-1, 2)).view(B, T)     # u[:, j]: node j
    bonus_key = subs[:, 0]
    counts = pen[0].clone() if pen is not None else None

    def row_dist(cur):
        """(argmax, top-k lane ids, scaled values, final mask, p) of node
        ``cur``'s (penalized) row, float for float as accept_tokens'."""
        row = logits[rows, cur]                              # [B, V]
        if pen is not None:
            row = _penalize(row, counts, *pen[1:])
        idxs, scaled, final_mask, p = _target_dist(row, temp, top_k, top_p,
                                                   max_top_k)
        return torch.argmax(row, dim=-1), idxs, scaled, final_mask, p

    cur = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(B, dtype=torch.long, device=dev)
    path = torch.zeros(B, d_max + 1, dtype=torch.long, device=dev)
    rej_lanes = torch.zeros(B, max_top_k, dtype=torch.bool, device=dev)
    depth_idx = torch.arange(d_max + 1, device=dev)
    for _ in range(d_max):
        greedy_t, idxs, _, final_mask, p = row_dist(cur)
        is_child = (parents == cur[:, None]) & valid          # [B, T]
        # greedy: the lowest-index child carrying the row's argmax
        match_g = is_child & (toks == greedy_t[:, None])
        j_g = torch.where(match_g, idx, T).amin(dim=-1)
        # sampled: siblings in index order under one rejection mass
        j_s = torch.full((B,), T, dtype=torch.long, device=dev)
        rl = torch.zeros(B, max_top_k, dtype=torch.bool, device=dev)
        rmass = torch.zeros(B, dtype=torch.float32, device=dev)
        lvl_done = torch.zeros(B, dtype=torch.bool, device=dev)
        for j in range(T):
            lane_tok = idxs == toks[:, j:j + 1]               # [B, Kt]
            p_eff = torch.where(lane_tok & final_mask & ~rl, p,
                                0.0).sum(dim=-1)
            ok = u[:, j] * torch.clamp(1.0 - rmass, min=1e-9) < p_eff
            live_c = is_child[:, j] & ~lvl_done
            j_s = torch.where(live_c & ok, j, j_s)
            rejected = live_c & ~ok
            rl = rl | (rejected[:, None] & lane_tok)
            rmass = rmass + torch.where(rejected, p_eff, 0.0)
            lvl_done = lvl_done | (live_c & ok)
        j = torch.where(greedy_rows, j_g, j_s)
        found = (j < T) & ~done
        cur_n = torch.where(found, j.clamp(max=T - 1), cur)
        n_acc_n = n_acc + found.long()
        path = torch.where((depth_idx == n_acc_n[:, None]) & found[:, None],
                           cur_n[:, None], path)
        if counts is not None:
            tok_j = toks[rows, cur_n]
            counts[rows, tok_j.clamp(min=0)] += found.to(counts.dtype)
        # a level's rejections matter only where the walk stops (the
        # bonus resamples that node's residual); descending resets them
        rej_lanes = torch.where(done[:, None], rej_lanes,
                                torch.where(found[:, None], False, rl))
        cur, done, n_acc = cur_n, done | ~found, n_acc_n
    greedy_t, idxs, scaled, final_mask, _ = row_dist(cur)
    row_final = torch.where(rej_lanes, NEG_INF,
                            torch.where(final_mask, scaled, NEG_INF))
    choice = sampling.categorical(bonus_key, row_final)
    bonus = torch.where(greedy_rows, greedy_t,
                        idxs.gather(1, choice[:, None])[:, 0])
    # out[l] for l < n_acc is the token at path depth l+1 (path[:, 0] is
    # the pending token, emitted last round); out[n_acc] is the bonus
    nxt = torch.cat([path[:, 1:], path.new_zeros(B, 1)], dim=1)
    path_toks = toks.gather(1, nxt.clamp(0, T - 1))
    out = torch.where(depth_idx < n_acc[:, None], path_toks,
                      torch.where(depth_idx == n_acc[:, None],
                                  bonus[:, None], 0))
    return out.to(torch.int32), path, n_acc + 1, new_keys


def accept_tree(logits, toks, parents, valid, keys, temp, top_k, top_p,
                max_top_k: int, d_max: int):
    """Tree acceptance without penalties (see _accept_tree_walk)."""
    return _accept_tree_walk(logits, toks, parents, valid, keys, temp, top_k,
                             top_p, None, max_top_k, d_max)


def accept_tree_penalized(logits, toks, parents, valid, keys, temp, top_k,
                          top_p, counts, freq, pres, rep, max_top_k: int,
                          d_max: int):
    """Penalty-aware tree acceptance: the counts histogram advances as
    the walk descends, so each accepted path token penalizes every deeper
    row, as the fused round's per-token advance does. It consumes
    accept_tree's key stream: zero counts and identity penalties draw the
    same. ``counts`` is not modified."""
    return _accept_tree_walk(logits, toks, parents, valid, keys, temp, top_k,
                             top_p, (counts, freq, pres, rep), max_top_k,
                             d_max)


def spec_verify_tree(
    config,
    params,
    ctx: llama.Cache,
    tokens: torch.Tensor,   # [B, T] int on the device — col 0 pending
    draft: Optional[torch.Tensor],  # [B, T-1] comb draft (level-major)
                            # spliced into cols 1: on the device, or None
    parents: torch.Tensor,  # [B, T] int on the device: -1 root, -2 padding
    slots: list[int],
    q_starts: list[int],    # region KV length per slot
    seq_lens: list[int],    # q_start + T
    keys: torch.Tensor,     # [B, 2] int64
    temps: torch.Tensor,    # [B] f32
    top_ks: torch.Tensor,   # [B] int32
    top_ps: torch.Tensor,   # [B] f32
    max_top_k: int,
    ctx_span: int,          # prior-context window (llama.spec_span)
    d_max: int,             # deepest root-to-leaf path (the round's K)
    penalties=None,         # None, or (counts [B, V], freq, pres, rep [B])
) -> torch.Tensor:
    """Tree score + accept + path commit, ON the device. Depths and the
    ancestor mask come from the parent pointers (tree_meta); every node
    is scored under the tree-causal mask (llama.batch_score_tree, which
    writes nothing); acceptance walks each row; then only the accepted
    path's KV rows are committed (llama.commit_tree_path), so the host's
    rollback is unchanged: the region's length becomes q_start + n_out.

    Returns one packed int64 tensor [B, 2*d_max + 4]:
      cols [0, d_max]              emitted tokens (n_out valid)
      cols [d_max+1, 2*d_max]      accepted node index at depth 1..d_max
                                   (the draft spine's rollback probe)
      col  2*d_max+1               n_out
      cols [2*d_max+2, 2*d_max+3]  the advanced key (uint32 words)
    """
    if draft is not None:
        tokens = tokens.clone()
        tokens[:, 1:] = draft
    depths, ancs, valids = tree_meta(parents)
    ks, vs, logits = llama.batch_score_tree(
        config, params, ctx, tokens, slots, q_starts, seq_lens, depths, ancs,
        ctx_span)
    if penalties is None:
        out, path, n_out, new_keys = accept_tree(
            logits, tokens, parents, valids, keys, temps, top_ks, top_ps,
            max_top_k, d_max)
    else:
        out, path, n_out, new_keys = accept_tree_penalized(
            logits, tokens, parents, valids, keys, temps, top_ks, top_ps,
            *penalties, max_top_k=max_top_k, d_max=d_max)
    B, T = tokens.shape
    # the whole-T path for the commit's gather: entries past n_out are
    # dead rows (a clamped gather, cut by the committed length)
    path_full = path.new_zeros(B, T)
    path_full[:, :d_max + 1] = path
    llama.commit_tree_path(ctx, ks, vs, path_full, slots, q_starts,
                           [q + n_out[i] for i, q in enumerate(q_starts)])
    return torch.cat([out.long(), path[:, 1:], n_out[:, None], new_keys],
                     dim=1)
