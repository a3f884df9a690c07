"""Host-side paged-KV page allocator with prefix reuse and LRU eviction
(a copy of the JAX package's engine/cache.py).

The device holds the page pool tensors (models/llama.py init_cache); this
module owns which page holds what:

  - a free list of never/no-longer-used pages (page 0 reserved as scratch);
  - a registry mapping chained block hash -> committed page, enabling
    radix-style prefix reuse across requests (equal chained hash == equal
    prefix, dynamo_tpu_torch.tokens);
  - per-page refcounts; unreferenced committed pages park in an LRU from
    which they can be revived (prefix hit) or evicted (allocation pressure);
  - stored/removed/cleared event emission for the KV-router plane;
  - the offload hook ``on_park``: a committed page that parks in the LRU
    becomes a candidate for the host tier (engine/offload.py).
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Optional

from dynamo_tpu_torch.kv_router.protocols import KvCacheEvent, KvEventKind, StoredBlock

EventSink = Callable[[KvCacheEvent], None]


@dataclass
class PageRecord:
    page: int
    block_hash: int
    parent_hash: int


class PageAllocator:
    """Allocates/reuses device pages. Thread-safe: a single lock covers
    every public mutation."""

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        worker_id: str = "",
        on_event: Optional[EventSink] = None,
        enable_prefix_caching: bool = True,
    ):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.worker_id = worker_id
        self.on_event = on_event
        self.enable_prefix_caching = enable_prefix_caching
        # offload hook: called (page, block_hash, parent_hash) when a
        # committed page parks in the LRU; the engine queues it as a G2
        # offload candidate. Called under the allocator lock: must be
        # cheap and non-blocking
        self.on_park: Optional[Callable[[int, int, int], None]] = None

        self._lock = threading.RLock()
        self._free: deque[int] = deque(range(1, num_pages))
        self._registry: dict[int, PageRecord] = {}   # block_hash -> record
        self._page_hash: dict[int, int] = {}         # page -> committed hash
        self._ref: dict[int, int] = {}               # page -> refcount
        self._lru: OrderedDict[int, None] = OrderedDict()  # block_hash -> None
        self._event_id = 0
        # prefix-cache counters
        self.hit_blocks = 0
        self.lookup_blocks = 0

    @property
    def total_pages(self) -> int:
        return self.num_pages - 1

    @property
    def active_pages(self) -> int:
        return self.total_pages - len(self._free) - len(self._lru)

    @property
    def available_pages(self) -> int:
        """Pages obtainable right now (free + evictable)."""
        return len(self._free) + len(self._lru)

    def usage(self) -> float:
        return self.active_pages / max(self.total_pages, 1)

    def hit_rate(self) -> float:
        return self.hit_blocks / max(self.lookup_blocks, 1)

    # ---- allocation ----

    def match_prefix(self, block_hashes: list[int]) -> list[int]:
        """Longest cached prefix of the given chained hashes; returned pages
        are referenced (caller must free). Revives LRU-parked pages."""
        pages: list[int] = []
        if not self.enable_prefix_caching:
            return pages
        with self._lock:
            self.lookup_blocks += len(block_hashes)
            for h in block_hashes:
                rec = self._registry.get(h)
                if rec is None:
                    break
                self._ref_page(rec.page, h)
                pages.append(rec.page)
            self.hit_blocks += len(pages)
            return pages

    def page_for_hash(self, block_hash: int) -> Optional[int]:
        """Which page holds this committed block now (None if evicted):
        offload-candidate validation."""
        with self._lock:
            rec = self._registry.get(block_hash)
            return None if rec is None else rec.page

    def cached_prefix_len(self, block_hashes: list[int]) -> int:
        """How many leading blocks are cached, without taking references
        or touching the hit-rate counters."""
        if not self.enable_prefix_caching:
            return 0
        with self._lock:
            n = 0
            for h in block_hashes:
                if h not in self._registry:
                    break
                n += 1
            return n

    def allocate(self, n: int) -> Optional[list[int]]:
        """n fresh pages (refcount 1 each), evicting LRU-parked committed
        pages if needed. None if not satisfiable (caller queues/preempts)."""
        with self._lock:
            if n > self.available_pages:
                return None
            while len(self._free) < n:
                self._evict_one()
            pages = [self._free.popleft() for _ in range(n)]
            for p in pages:
                self._ref[p] = 1
            return pages

    def commit(self, page: int, block_hash: int, parent_hash: int) -> bool:
        """Mark `page` as holding the sealed block `block_hash` (chained on
        parent_hash), making it reusable by other requests. Returns False on
        duplicate hash (page stays private to its request)."""
        if not self.enable_prefix_caching:
            return False
        with self._lock:
            if block_hash in self._registry:
                return False
            self._registry[block_hash] = PageRecord(page, block_hash, parent_hash)
            self._page_hash[page] = block_hash
            self._emit(
                KvCacheEvent(
                    kind=KvEventKind.STORED,
                    parent_hash=parent_hash,
                    blocks=[StoredBlock(block_hash=block_hash)],
                )
            )
            return True

    def free(self, pages: list[int]) -> None:
        """Release one reference on each page. Unreferenced committed pages
        park in the LRU (still prefix-hittable); uncommitted ones return to
        the free list."""
        with self._lock:
            for p in pages:
                r = self._ref.get(p, 0) - 1
                if r > 0:
                    self._ref[p] = r
                    continue
                self._ref.pop(p, None)
                h = self._page_hash.get(p)
                if h is not None:
                    self._lru[h] = None
                    self._lru.move_to_end(h)
                    if self.on_park is not None:
                        self.on_park(p, h, self._registry[h].parent_hash)
                else:
                    self._free.append(p)

    def snapshot_stored_events(
        self, batch: int = 256
    ) -> list[KvCacheEvent]:
        """Authoritative cache state as an event stream: one CLEARED
        followed by STORED events covering every committed block. Routers
        that missed events (dropped on the lossy pub/sub plane) converge
        by applying a periodic resync of this snapshot."""
        with self._lock:
            records = list(self._registry.values())
        # events are returned UNSTAMPED: the publisher sink sets worker_id
        # (same path as live events); event_id stays 0 — stamping here
        # would race _emit's counter outside the lock
        events: list[KvCacheEvent] = [KvCacheEvent(kind=KvEventKind.CLEARED)]
        for i in range(0, len(records), batch):
            chunk = records[i : i + batch]
            events.append(KvCacheEvent(
                kind=KvEventKind.STORED,
                blocks=[StoredBlock(block_hash=r.block_hash)
                        for r in chunk],
            ))
        return events

    def clear(self) -> int:
        """Drop every reusable cached page (the /clear_kv_blocks
        operation, reference http/service/clear_kv_blocks.rs); pages in
        use survive. Returns the number of pages cleared."""
        with self._lock:
            n = len(self._lru)
            while self._lru:
                self._evict_one()
            self._emit(KvCacheEvent(kind=KvEventKind.CLEARED))
            return n

    # ---- internals ----

    def _ref_page(self, page: int, block_hash: int) -> None:
        r = self._ref.get(page, 0)
        if r == 0:
            self._lru.pop(block_hash, None)
        self._ref[page] = r + 1

    def _evict_one(self) -> None:
        h, _ = self._lru.popitem(last=False)
        rec = self._registry.pop(h)
        self._page_hash.pop(rec.page, None)
        self._free.append(rec.page)
        self._emit(
            KvCacheEvent(kind=KvEventKind.REMOVED, removed_hashes=[h])
        )

    def _emit(self, ev: KvCacheEvent) -> None:
        if self.on_event is None:
            return
        self._event_id += 1
        ev.event_id = self._event_id
        ev.worker_id = self.worker_id
        self.on_event(ev)
