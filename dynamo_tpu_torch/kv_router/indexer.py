"""Global KV-cache index: which worker holds which blocks (the port's copy
of the JAX package's kv_router/indexer.py).

Parity: reference kv_router/indexer.rs — RadixTree (:187), KvIndexer (:518),
OverlapScores (:410), and ApproxKvIndexer (approx.rs:157).

The reference builds a radix tree of (parent, local-block-hash) nodes. Our
block hashes are CHAINED (dynamo_tpu_torch.tokens: each hash commits to the
whole prefix), so a flat ``hash -> workers`` map walks exactly like the
radix tree: following a request's chained-hash list in order IS the
root-to-leaf path, and a worker holding chain hash h_i necessarily stored
it with the full prefix chain. Same scoring semantics, O(1) per level, no
tree maintenance.

Access heat is an EWMA, not a raw counter: each touch adds 1 and the value
halves every ``freq_halflife_s`` seconds, so a hot-set ranking tracks the
CURRENT workload instead of all history, and cold entries decay to where
the periodic prune drops them instead of accumulating forever. The fleet
view (kv_router/fleet.py ``FleetKvView``) and the prefetch controller
(kv_router/prefetch.py) rank blocks by it through the read accessors
here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.kv_router.protocols import (
    KvCacheEvent,
    KvEventKind,
    StoredBlock,
)
from dynamo_tpu_torch.tokens import compute_block_hashes

WorkerId = str

# decayed heat below this is indistinguishable from never-touched; the
# periodic prune drops such entries so _freq stays bounded by the live
# hot set rather than every hash ever queried
_HEAT_EPSILON = 1.0 / 64.0
# apply_event calls between opportunistic heat prunes
_PRUNE_EVERY = 1024


@dataclass
class OverlapScores:
    """Per-worker count of matched prefix blocks (indexer.rs OverlapScores)."""

    scores: dict[WorkerId, int] = field(default_factory=dict)
    # access frequency of each matched block along the walk (0s omitted)
    frequencies: list[int] = field(default_factory=list)

    def update(self, workers: set[WorkerId]) -> None:
        for w in workers:
            self.scores[w] = self.scores.get(w, 0) + 1


class KvIndexer:
    """Consumes KvCacheEvents from all workers, answers find_matches.

    Single-threaded by design (the reference runs it on one tokio worker and
    talks to it via channels; in asyncio everything already serializes on
    the event loop).

    ``freq_halflife_s`` sets the access-heat decay half-life (None = no
    decay, raw counters). ``clock`` is injectable for tests; it must be
    monotonic-seconds compatible.
    """

    def __init__(
        self,
        block_size: int,
        expiration_s: Optional[float] = None,
        *,
        freq_halflife_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.block_size = block_size
        self.expiration_s = expiration_s
        self.freq_halflife_s = freq_halflife_s
        self._clock = clock
        self._workers: dict[int, set[WorkerId]] = {}       # hash -> workers
        self._by_worker: dict[WorkerId, set[int]] = {}     # worker -> hashes
        self._inserted: dict[int, float] = {}              # hash -> store time
        # hash -> (EWMA heat at last touch, last-touch time)
        self._freq: dict[int, tuple[float, float]] = {}
        # hash -> parent chain hash, learned from STORED events that carry
        # parent_hash — lets a fleet view reconstruct a hot block's whole
        # prefix chain for prefetch. Best-effort: batched snapshot events
        # (cache.py snapshot_stored_events) omit parents and leave gaps.
        self._parent: dict[int, int] = {}
        self.events_applied = 0

    # ---- event plane ----

    def apply_event(self, event: KvCacheEvent) -> None:
        """reference indexer.rs:283 apply_event."""
        w = event.worker_id
        self.events_applied += 1
        if event.kind == KvEventKind.STORED:
            now = self._clock()
            parent = event.parent_hash
            for blk in event.blocks:
                h = blk.block_hash
                if self.expiration_s is not None:
                    # a store that lands after the previous copy's TTL
                    # lapsed (but before a query swept it) is a NEW life
                    # for the hash: stale heat must not carry over
                    t = self._inserted.get(h)
                    if t is not None and now - t > self.expiration_s:
                        self._freq.pop(h, None)
                self._workers.setdefault(h, set()).add(w)
                self._by_worker.setdefault(w, set()).add(h)
                self._inserted[h] = now  # (re)store refreshes TTL
                if parent is not None:
                    self._parent[h] = parent
                parent = h
        elif event.kind == KvEventKind.REMOVED:
            for h in event.removed_hashes:
                self._remove(w, h)
        elif event.kind == KvEventKind.CLEARED:
            self.remove_worker(w)
        if self.events_applied % _PRUNE_EVERY == 0:
            self._prune_heat()

    def total_blocks(self) -> int:
        """Distinct block hashes currently indexed (observability)."""
        return len(self._workers)

    def remove_worker(self, worker_id: WorkerId) -> None:
        """Worker left (lease expired) — drop all its blocks
        (indexer.rs remove_worker)."""
        for h in self._by_worker.pop(worker_id, set()):
            ws = self._workers.get(h)
            if ws is not None:
                ws.discard(worker_id)
                if not ws:
                    self._forget(h)

    def _remove(self, worker_id: WorkerId, h: int) -> None:
        ws = self._workers.get(h)
        if ws is not None:
            ws.discard(worker_id)
            if not ws:
                self._forget(h)
        hs = self._by_worker.get(worker_id)
        if hs is not None:
            hs.discard(h)

    def _forget(self, h: int) -> None:
        """Last holder gone — drop every per-hash record."""
        del self._workers[h]
        self._inserted.pop(h, None)
        self._freq.pop(h, None)
        self._parent.pop(h, None)

    # ---- heat (EWMA-decayed access frequency) ----

    def _decayed(self, h: int, now: float) -> float:
        e = self._freq.get(h)
        if e is None:
            return 0.0
        v, last = e
        hl = self.freq_halflife_s
        if hl is not None and hl > 0 and now > last:
            v *= 2.0 ** (-(now - last) / hl)
        return v

    def _touch(self, h: int, now: float) -> float:
        """Decay-then-increment; returns the PRE-touch heat (matching the
        old read-before-increment counter semantics)."""
        v = self._decayed(h, now)
        self._freq[h] = (v + 1.0, now)
        return v

    def _prune_heat(self) -> None:
        if self.freq_halflife_s is None:
            return
        now = self._clock()
        dead = [h for h in self._freq if self._decayed(h, now) < _HEAT_EPSILON]
        for h in dead:
            self._freq.pop(h, None)

    def heat(self, h: int) -> float:
        """Current decayed access heat of a block (read-only: no touch)."""
        return self._decayed(h, self._clock())

    def replicas(self, h: int) -> int:
        """How many workers hold this block right now (never negative:
        holder sets are discard-based and dropped when empty)."""
        return len(self._workers.get(h, ()))

    def holders(self, h: int) -> set[WorkerId]:
        return set(self._workers.get(h, ()))

    def parent_of(self, h: int) -> Optional[int]:
        return self._parent.get(h)

    def worker_block_count(self, worker_id: WorkerId) -> int:
        """Blocks this worker currently holds in the fleet view (the
        prefetch controller's cold-worker / least-loaded signal)."""
        return len(self._by_worker.get(worker_id, ()))

    def hot_blocks(self, k: int) -> list[tuple[int, float]]:
        """Top-k currently-held blocks by decayed heat, hottest first."""
        now = self._clock()
        scored = [
            (h, self._decayed(h, now))
            for h in self._freq
            if h in self._workers
        ]
        scored = [(h, v) for h, v in scored if v >= _HEAT_EPSILON]
        scored.sort(key=lambda hv: (-hv[1], hv[0]))
        return scored[:k]

    # ---- query plane ----

    def find_matches(
        self, block_hashes: list[int], early_exit: bool = False
    ) -> OverlapScores:
        """Walk the chained hashes; stop at the first block no worker holds
        (indexer.rs:239). `early_exit` stops at the first score found."""
        scores = OverlapScores()
        now = self._clock()
        for h in block_hashes:
            ws = self._workers.get(h)
            if not ws:
                break
            if self.expiration_s is not None:
                # TTL from STORE time (reference approx.rs TimerManager) —
                # queries do NOT refresh it, else stale entries never expire
                t = self._inserted.get(h, now)
                if now - t > self.expiration_s:
                    for w in list(ws):
                        self._remove(w, h)
                    break
            freq = self._touch(h, now)
            if freq >= 1.0:
                scores.frequencies.append(int(freq))
            scores.update(ws)
            if early_exit and scores.scores:
                break
        return scores

    def find_matches_for_tokens(self, tokens: list[int], salt: str = "") -> OverlapScores:
        return self.find_matches(
            compute_block_hashes(tokens, self.block_size, salt=salt)
        )


class ApproxKvIndexer:
    """No-events indexer: ASSUMES a routed prefix is cached on the worker it
    was routed to, with TTL expiry (reference kv_router/approx.rs:157).
    Useful when engines can't publish KV events."""

    def __init__(self, block_size: int, ttl_s: float = 120.0):
        self.inner = KvIndexer(block_size, expiration_s=ttl_s)

    def find_matches(self, block_hashes: list[int]) -> OverlapScores:
        return self.inner.find_matches(block_hashes)

    def process_routing_decision(
        self, worker_id: WorkerId, block_hashes: list[int]
    ) -> None:
        """Record that `worker_id` is now presumed to hold these blocks."""
        self.inner.apply_event(
            KvCacheEvent(
                kind=KvEventKind.STORED,
                worker_id=worker_id,
                blocks=[StoredBlock(block_hash=h) for h in block_hashes],
            )
        )
