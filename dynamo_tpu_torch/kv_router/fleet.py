"""Fleet-wide content-addressed KV view: replica counts, hot prefixes and
the worker-side hint digests built from them (a copy of the JAX package's
kv_router/fleet.py).

The frontend already folds every worker's cache events into its
``KvIndexer`` (hash -> holders, per-hash access heat). ``FleetKvView`` is
the read side of the fleet prefix economy over that same state, with no
second event subscription:

  * the query plane (``GET /debug/kv_fleet``,
    ``python -m dynamo_tpu_torch.tools.kv_fleet``) reads ``to_dict()``;
  * the replication controller (kv_router/prefetch.py) reads
    ``hot_chains`` and ``under_replicated``;
  * workers receive a compact ``digest()`` and hold it as ``FleetHints``,
    which dedup-by-hash admission (engine.py ``_remote_prefetch``) and
    replication-aware tier eviction (engine/offload.py) consult.

Block hashes are CHAINED (dynamo_tpu_torch.tokens), so holding hash h
implies holding the whole prefix up to h: a hot leaf names a hot prefix,
and ``chain_of`` rebuilds the root-to-leaf run from the parent links that
STORED events carry.

The holders a digest names are the router's worker ids, which are lease
ids; G4 descriptors are published under a fresh id (launch/run.py
``serve_worker``), so in a launched fleet a hinted fetch finds no hinted
peer and probes the whole fleet. The JAX package does the same, and the
port keeps it so the two packages' stacks stay interchangeable (ROADMAP
Queue 3).
"""
from __future__ import annotations

from typing import Any, Optional

from dynamo_tpu_torch.kv_router.indexer import KvIndexer, WorkerId


class FleetKvView:
    """Read-only fleet view over a live ``KvIndexer``."""

    def __init__(self, indexer: KvIndexer):
        self.indexer = indexer

    # ---- per-block queries ----

    def replicas(self, h: int) -> int:
        return self.indexer.replicas(h)

    def holders(self, h: int) -> set[WorkerId]:
        return self.indexer.holders(h)

    def heat(self, h: int) -> float:
        return self.indexer.heat(h)

    # ---- chain reconstruction ----

    def chain_of(self, h: int, max_len: int = 256) -> list[int]:
        """Root-first chained-hash run ending at ``h``, following parent
        links while the parent is still held somewhere in the fleet.
        Best-effort: batched snapshot events carry no parent links, so a
        chain may start mid-prefix (still valid to fetch, just shorter)."""
        chain = [h]
        seen = {h}
        cur = h
        while len(chain) < max_len:
            p = self.indexer.parent_of(cur)
            if p is None or p in seen or self.indexer.replicas(p) == 0:
                break
            chain.append(p)
            seen.add(p)
            cur = p
        chain.reverse()
        return chain

    def hot_blocks(self, k: int) -> list[tuple[int, float]]:
        return self.indexer.hot_blocks(k)

    def hot_chains(self, k: int) -> list[list[int]]:
        """Top-k hot prefix chains, hottest first. A chain whose leaf an
        already-selected chain covers is dropped (fetching a prefix of a
        selected chain again is redundant)."""
        out: list[list[int]] = []
        covered: set[int] = set()
        for h, _ in self.indexer.hot_blocks(max(k * 4, k)):
            if h in covered:
                continue
            chain = self.chain_of(h)
            covered.update(chain)
            out.append(chain)
            if len(out) >= k:
                break
        return out

    def under_replicated(
        self, target: int, k: int
    ) -> list[tuple[int, int, float]]:
        """Hot blocks held by fewer than ``target`` workers: ``(hash,
        replicas, heat)``, hottest first."""
        out = []
        for h, heat in self.indexer.hot_blocks(k):
            r = self.indexer.replicas(h)
            if 0 < r < target:
                out.append((h, r, heat))
        return out

    # ---- wire forms ----

    def to_dict(self, top: int = 32) -> dict[str, Any]:
        """The debug form of ``GET /debug/kv_fleet``."""
        hot = []
        for h, heat in self.indexer.hot_blocks(top):
            hot.append({
                "hash": h,
                "heat": round(heat, 4),
                "replicas": self.indexer.replicas(h),
                "holders": sorted(self.indexer.holders(h)),
                "chain_len": len(self.chain_of(h)),
            })
        return {
            "total_blocks": self.indexer.total_blocks(),
            "events_applied": self.indexer.events_applied,
            "hot": hot,
        }

    def digest(
        self, max_blocks: int = 128, max_holders: int = 4
    ) -> dict[str, Any]:
        """The compact hint form pushed to workers: replica counts and
        capped holder lists of the top-``max_blocks`` hot blocks, and the
        hot hashes themselves. JSON-safe (hash keys as strings)."""
        replicas: dict[str, int] = {}
        holders: dict[str, list[str]] = {}
        hot: list[int] = []
        for h, _ in self.indexer.hot_blocks(max_blocks):
            replicas[str(h)] = self.indexer.replicas(h)
            holders[str(h)] = sorted(self.indexer.holders(h))[:max_holders]
            hot.append(h)
        return {"replicas": replicas, "holders": holders, "hot": hot}


class FleetHints:
    """A worker's copy of the frontend's fleet digest.

    ``replicas`` returns None for an unknown hash: eviction reads that as
    "assume unique", and dedup admission only skips a probe round when
    none of the missing blocks is known; a known holder is probed first,
    never refused."""

    def __init__(self, digest: Optional[dict[str, Any]] = None):
        self._replicas: dict[int, int] = {}
        self._holders: dict[int, list[str]] = {}
        self.hot: list[int] = []
        self.applied = 0
        if digest is not None:
            self.apply(digest)

    def apply(self, digest: dict[str, Any]) -> None:
        """Swap the maps whole: a reader on another thread sees the old
        digest or the new one, never a mix."""
        self._replicas = {
            int(k): int(v) for k, v in (digest.get("replicas") or {}).items()
        }
        self._holders = {
            int(k): list(v) for k, v in (digest.get("holders") or {}).items()
        }
        self.hot = [int(h) for h in digest.get("hot") or []]
        self.applied += 1

    def replicas(self, h: int) -> Optional[int]:
        return self._replicas.get(h)

    def holders(self, h: int) -> list[str]:
        return self._holders.get(h, [])

    def to_dict(self) -> dict[str, Any]:
        return {
            "applied": self.applied,
            "known_blocks": len(self._replicas),
            "hot": self.hot,
        }
