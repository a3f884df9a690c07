"""Host-side KV offload tiers: G2 host memory and G3 disk (a copy of the
JAX package's engine/offload.py on torch CPU tensors; reference KVBM
block_manager/offload.rs, storage/disk.rs:25).

Blocks leaving the device pool's reuse set go down the hierarchy G1 HBM
-> G2 host memory -> G3 disk; a prefix lookup that misses in HBM consults
the lower tiers and onboards the run back instead of recomputing it. The
engine (engine/engine.py) owns the device side: it gathers parked pool
pages on the card, copies them to the host behind compute and puts them
here; at admission it gathers a run from here, verifies it and scatters
it into the pool.

G2's pool is page-major, ``[N, 2, L, kvh, ps, hd]``, in pinned memory
when the engine runs on CUDA, so each page is one contiguous run of bytes
(its crc needs no copy, and a run gathered into a pinned staging buffer
copies to the card without a stage). G2 lives in RAM only; what must
match the JAX package is each page's bytes and crc.

G3 is an mmap-backed page pool whose file keeps the JAX package's layout
byte for byte: ``pool_shape`` ``(2, L, kvh, N, ps, hd)``, page axis at
3, in the tier's element type (bf16 as its raw 2-byte words). G2's LRU
evictions spill into it, and lookups fall through G2 into G3 mid-run, so
one onboard may come from both tiers. Writes go through the OS page
cache (no fsync on the hot path).

Integrity (kv_integrity.py): every index entry carries the block's crc,
minted at its first host landing and carried down the spill;
``verify_pages`` checks gathered bytes against it, and a shared
``KvQuarantine`` makes puts refuse hashes that ever failed.

Crash consistency (G3): with an operator-given ``path`` the tier journals
a manifest (``<path>.manifest``, JSON lines: slot -> hash, parent, crc,
scale; compacted through an atomic rename) and replays it at attach, so
the disk corpus survives a restart, and a corpus written by either
package attaches in the other. A startup scrub (lazy by default, eager
with ``scrub_on_start``) verifies or drops entries: torn writes come back
as misses.

Fault injection (resilience/chaos.py): ``flip_kv_bits`` flips bits of a
gather's output (the staging copy, never the pool), and ``truncate_g3``
zeroes G3's tail half before a G3 gather or page read (G2's fall-through
reads G3 page-wise, so both paths reach it).

Replication-aware eviction: once the engine applies the frontend's fleet
hints (``TorchEngine.apply_fleet_hints``), ``fleet_replicas`` maps a hash
to its known fleet replica count, and eviction drops the best-replicated
of the LRU-oldest entries before the fleet's last copy of a block
(``_pick_victim``, counted in kv_fleet_metrics.py).
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import tempfile
from collections import OrderedDict
from concurrent.futures import Executor
from typing import Any, Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.kv_fleet_metrics import KV_FLEET
from dynamo_tpu_torch.kv_integrity import (
    KV_INTEGRITY,
    KvQuarantine,
    page_checksum,
    page_checksums,
)

log = logging.getLogger(__name__)

# journal compaction threshold: rewrite the manifest once the journal
# carries this many times more lines than live entries could need
_JOURNAL_SLACK = 4

# replication-aware eviction scans this many LRU-oldest entries for a
# well-replicated victim before it falls back to the LRU head, so an
# eviction stays O(1)-ish under pressure
_EVICT_SCAN = 8

# a tier's element type, its name in the G3 manifest (numpy's, as the JAX
# package writes it) and the numpy type of the same width the G3 file is
# mapped as (numpy has no bf16 without ml_dtypes)
def _chaos():
    # lazy: the tiers stay importable standalone and pay one module-dict
    # lookup per gather
    from dynamo_tpu_torch.resilience.chaos import CHAOS

    return CHAOS


_DTYPE_NAME = {torch.bfloat16: "bfloat16", torch.float16: "float16",
               torch.float32: "float32", torch.int8: "int8"}
_MMAP_DTYPE = {torch.bfloat16: np.int16, torch.float16: np.float16,
               torch.float32: np.float32, torch.int8: np.int8}


class _PageTier:
    """Fixed-capacity pool of KV pages keyed by chained block hash, with
    LRU eviction. A page is ``[2(k/v), L, kvh, ps, hd]``; scales (int8
    tiers) are ``scale_shape`` (``(2, L)``) a page and stay in RAM for
    every tier (the G3 manifest journals them too). Single owner (the
    engine loop) except for read-only counter access. Subclasses give the
    storage: ``_ensure_pool`` and ``_slot`` (one slot's page view)."""

    def __init__(self, num_pages: int, page_shape: tuple,
                 dtype: torch.dtype, scale_shape: tuple = (),
                 quarantine: Optional[KvQuarantine] = None):
        self.num_pages = num_pages
        self.page_shape = tuple(page_shape)
        self.dtype = dtype
        self._pool: Optional[torch.Tensor] = None  # lazy: it can be GBs
        self.scale_shape = tuple(scale_shape)
        self._scale_pool: Optional[torch.Tensor] = None   # [N, *scale_shape]
        # hash -> (slot, parent_hash, crc); insertion order = LRU order
        self._index: "OrderedDict[int, tuple[int, int, int]]" = OrderedDict()
        self._free: list[int] = list(range(num_pages))
        # shared deny-list: hashes that failed verification are refused
        # (puts are no-ops) until their quarantine TTL lapses
        self.quarantine = quarantine
        # threads that gather and verify a run's pages side by side (the
        # engine's; None: one page after another on the caller's thread)
        self.crc_pool: Optional[Executor] = None
        # fleet prefix economy: once wired (engine.apply_fleet_hints),
        # maps hash -> known fleet replica count (None = unknown), and
        # eviction prefers well-replicated blocks over the last copy
        self.fleet_replicas: Optional[Callable[[int], Optional[int]]] = None
        self.pages_offloaded = 0
        self.onboard_hits = 0
        self.lookups = 0

    @property
    def pool_shape(self) -> tuple:
        """The JAX package's tier pool shape (page axis at 3)."""
        p = self.page_shape
        return (p[0], p[1], p[2], self.num_pages, p[3], p[4])

    def _ensure_pool(self) -> torch.Tensor:
        raise NotImplementedError

    def _slot(self, slot: int) -> torch.Tensor:
        raise NotImplementedError

    def _ensure_scales(self) -> torch.Tensor:
        if self._scale_pool is None:
            self._scale_pool = torch.zeros(
                (self.num_pages,) + self.scale_shape, dtype=torch.float32)
        return self._scale_pool

    def __contains__(self, block_hash: int) -> bool:
        return block_hash in self._index

    def __len__(self) -> int:
        return len(self._index)

    # -- journal hooks (no-ops except for the manifest-backed G3) --

    def _on_put(self, h: int, parent: int, slot: int, crc: int,
                scale: Optional[torch.Tensor]) -> None:
        pass

    def _on_drop(self, h: int) -> None:
        pass

    def _pick_victim(self) -> int:
        """The hash to evict: the LRU head, unless the fleet replica hook
        is wired; then the best-replicated of the ``_EVICT_SCAN`` oldest
        entries (>= 2 known fleet copies, the oldest wins ties), so the
        fleet's LAST copy of a warm block outlives the eighth copy of a
        shared system prompt."""
        head = next(iter(self._index))
        fn = self.fleet_replicas
        if fn is None:
            return head
        best_h = None
        best_r = 1
        for h in itertools.islice(self._index, _EVICT_SCAN):
            try:
                r = fn(h)
            except Exception:  # noqa: BLE001 — stale hints must not block eviction
                log.debug("fleet replica lookup failed for %#x", h,
                          exc_info=True)
                r = None
            if r is not None and r > best_r:
                best_h, best_r = h, r
        if best_h is not None:
            KV_FLEET.inc("dynamo_kv_fleet_replicated_evictions_total")
            return best_h
        try:
            head_r = fn(head)
        except Exception:  # noqa: BLE001 — stale hints must not block eviction
            log.debug("fleet replica lookup failed for %#x", head,
                      exc_info=True)
            head_r = None
        if head_r is not None and head_r <= 1:
            KV_FLEET.inc("dynamo_kv_fleet_last_copy_evictions_total")
        return head

    def _evict_one(self) -> None:
        """Drop one entry to free a slot (_pick_victim; G2 spills it)."""
        old_h = self._pick_victim()
        old_slot, _, _ = self._index.pop(old_h)
        self._free.append(old_slot)
        self._on_drop(old_h)

    def put_one(self, h: int, parent: int, page: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                checksum: Optional[int] = None) -> bool:
        """Store one page ([2, L, kvh, ps, hd]); False if already held or
        quarantined. ``scale`` ([*scale_shape]) rides along for int8
        tiers. ``checksum`` is the block's crc, minted here over the
        stored bytes when the caller carries none."""
        if self.quarantine is not None and h in self.quarantine:
            return False
        if h in self._index:
            self._index.move_to_end(h)
            return False
        self._ensure_pool()
        if not self._free:
            self._evict_one()
        slot = self._free.pop()
        dst = self._slot(slot)
        dst.copy_(page)
        if self.scale_shape:
            if scale is None:
                self._ensure_scales()[slot].zero_()
            else:
                self._ensure_scales()[slot].copy_(scale)
        if checksum is None:
            checksum = page_checksum(
                dst, self._ensure_scales()[slot] if self.scale_shape
                else None)
        self._index[h] = (slot, parent, checksum)
        self.pages_offloaded += 1
        self._on_put(h, parent, slot, checksum,
                     scale if self.scale_shape else None)
        return True

    def put_batch(self, hashes: list[int], parents: list[int], data: Any,
                  scales: Optional[torch.Tensor] = None,
                  checksums: Optional[list[int]] = None) -> int:
        """Store gathered pages (``[2, L, kvh, n, ps, hd]`` or a
        kv_quant.QuantizedPages bundle, aligned with ``hashes``).
        Existing entries are refreshed in LRU order. Returns the number
        of new pages stored."""
        if scales is None and hasattr(data, "scales"):
            data, scales = data.data, data.scales
        stored = 0
        for i, (h, parent) in enumerate(zip(hashes, parents)):
            stored += bool(self.put_one(
                h, parent, data[:, :, :, i],
                scales[..., i] if scales is not None else None,
                checksums[i] if checksums is not None else None))
        return stored

    def lookup_run(self, hashes: list[int]) -> list[tuple[int, int]]:
        """Longest leading run of hashes present in the tier, as
        [(hash, parent_hash), ...]; refreshes their LRU position."""
        self.lookups += len(hashes)
        run: list[tuple[int, int]] = []
        for h in hashes:
            ent = self._index.get(h)
            if ent is None:
                break
            self._index.move_to_end(h)
            run.append((h, ent[1]))
        self.onboard_hits += len(run)
        return run

    def checksum_of(self, block_hash: int) -> Optional[int]:
        ent = self._index.get(block_hash)
        return None if ent is None else ent[2]

    def verify_pages(self, hashes: list[int], data: Any,
                     scales: Optional[torch.Tensor] = None) -> list[int]:
        """Check gathered pages against the stored crcs; returns the
        indices of the pages that mismatch (counters updated here)."""
        if scales is None and hasattr(data, "scales"):
            data, scales = data.data, data.scales
        got = page_checksums(data, scales, self.crc_pool)
        bad = [i for i, h in enumerate(hashes)
               if self.checksum_of(h) not in (None, got[i])]
        if bad:
            KV_INTEGRITY.inc("dynamo_kv_integrity_failed_total", len(bad))
        KV_INTEGRITY.inc("dynamo_kv_integrity_verified_total",
                         len(hashes) - len(bad))
        return bad

    def _page(self, block_hash: int) -> torch.Tensor:
        return self._slot(self._index[block_hash][0])

    def gather(self, hashes: list[int],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Copies of the given (present) pages as ``[2, L, kvh, n, ps,
        hd]``: a view of ``out`` (page-major ``[n, 2, L, kvh, ps, hd]``,
        e.g. a pinned staging buffer; allocated when None), so each page
        of the result is contiguous."""
        self._ensure_pool()
        if out is None:
            out = torch.empty((len(hashes),) + self.page_shape,
                              dtype=self.dtype)
        pages = [self._page(h) for h in hashes]

        def one(i: int) -> None:
            out[i].copy_(pages[i])

        if self.crc_pool is not None and len(pages) > 1:
            list(self.crc_pool.map(one, range(len(pages))))
        else:
            for i in range(len(pages)):
                one(i)
        batch = out.permute(1, 2, 3, 0, 4, 5)
        _chaos().maybe_flip_bits(batch)
        return batch

    def _scale(self, block_hash: int) -> torch.Tensor:
        return self._ensure_scales()[self._index[block_hash][0]]

    def gather_scales(self, hashes: list[int]) -> Optional[torch.Tensor]:
        """Scales aligned with ``gather`` (``[*scale_shape, n]``); None
        for a dense tier."""
        if not self.scale_shape:
            return None
        return torch.stack([self._scale(h) for h in hashes], dim=-1)

    def read_page(self, block_hash: int) -> torch.Tensor:
        """One page [2, L, kvh, ps, hd] (a view; must be present)."""
        self._ensure_pool()
        return self._page(block_hash)

    def read_scale(self, block_hash: int) -> Optional[torch.Tensor]:
        if not self.scale_shape:
            return None
        return self._scale(block_hash)

    def rot_page(self, block_hash: int) -> bool:
        """Flip one bit of the tier's own copy of a page without touching
        its crc: silent rot after the seal (a memory flip, a torn disk
        write). The next onboard's verify fails closed."""
        ent = self._index.get(block_hash)
        if ent is None:
            return False
        self._ensure_pool()
        first = self._slot(ent[0])[0, 0, 0, 0, :1]   # a view, any layout
        first.view(torch.uint8)[0] ^= 1
        return True

    def drop(self, block_hash: int) -> None:
        ent = self._index.pop(block_hash, None)
        if ent is not None:
            self._free.append(ent[0])
            self._on_drop(block_hash)

    def drop_everywhere(self, block_hash: int) -> None:
        """Quarantine support: purge the hash from this tier (and a lower
        tier: HostOffloadTier)."""
        self.drop(block_hash)

    def clear(self) -> int:
        n = len(self._index)
        for h in list(self._index):
            self.drop(h)
        return n


class DiskOffloadTier(_PageTier):
    """G3: an mmap-backed page pool (reference storage/disk.rs:25). The
    file is a plain dense array in the JAX package's layout; the OS page
    cache absorbs write bursts and serves hot reads.

    With an operator-given ``path`` the tier survives a restart: a
    manifest (``<path>.manifest``) journals every put and drop and is
    replayed at attach. Pages are written to the mmap BEFORE their
    journal line, so a crash can leave an orphaned page (harmless, the
    slot is reused) but never a journal entry over unwritten bytes that
    would verify; torn journal tails are skipped line by line."""

    def __init__(self, num_pages: int, page_shape: tuple,
                 dtype: torch.dtype, path: Optional[str] = None,
                 scale_shape: tuple = (),
                 quarantine: Optional[KvQuarantine] = None,
                 scrub_on_start: bool = False):
        super().__init__(num_pages, page_shape, dtype,
                         scale_shape=scale_shape, quarantine=quarantine)
        self.path = path
        self._owns_file = path is None
        self.scrub_on_start = bool(scrub_on_start)
        self._mm: Optional[np.memmap] = None
        self._journal = None  # open append handle to the manifest
        self._journal_lines = 0
        self.scrub_recovered = 0
        self.scrub_dropped = 0
        if path is not None and os.path.exists(path):
            self._attach()
        elif (self.manifest_path is not None
              and os.path.exists(self.manifest_path)):
            # a manifest without its pool file is stale: its entries
            # would point into fresh zeros, so start clean instead
            os.unlink(self.manifest_path)

    # -- backing file --

    @property
    def manifest_path(self) -> Optional[str]:
        return None if self.path is None else self.path + ".manifest"

    def _ensure_pool(self) -> torch.Tensor:
        if self._pool is None:
            if self.path is None:
                fd, self.path = tempfile.mkstemp(
                    prefix="dynamo-tpu-kv-g3-", suffix=".mmap")
                os.close(fd)
            itemsize = np.dtype(_MMAP_DTYPE[self.dtype]).itemsize
            nbytes = int(np.prod(self.pool_shape)) * itemsize
            exists = os.path.exists(self.path)
            size = os.path.getsize(self.path) if exists else 0
            if exists and 0 < size < nbytes:
                # truncated mid-growth (crash) or a short operator file:
                # extend sparsely; the zero tail fails its crc at scrub
                # and its blocks come back as misses, not as SIGBUS
                os.truncate(self.path, nbytes)
                size = nbytes
            # an existing file attaches with "r+" ("w+" would zero a
            # restart-survivable corpus or an operator's file)
            mode = "r+" if exists and size >= nbytes else "w+"
            self._mm = np.memmap(self.path, dtype=_MMAP_DTYPE[self.dtype],
                                 mode=mode, shape=self.pool_shape)
            self._pool = torch.from_numpy(self._mm).view(self.dtype)
            log.info("G3 disk tier: %d pages (%.1f MB) at %s (%s)",
                     self.num_pages, nbytes / 1e6, self.path,
                     "attached" if mode == "r+" else "created")
        return self._pool

    def _slot(self, slot: int) -> torch.Tensor:
        return self._pool[:, :, :, slot]

    def _maybe_chaos_truncate(self) -> None:
        # chaos truncate_g3: the backing file loses its tail region
        # (dropped writes); live-safe (an ftruncate under the mmap would
        # SIGBUS) and caught by the crc verify
        if _chaos().fire("truncate_g3"):
            self._ensure_pool()[:, :, :, self.num_pages // 2:] = 0

    def gather(self, hashes: list[int],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        self._maybe_chaos_truncate()
        return super().gather(hashes, out)

    def read_page(self, block_hash: int) -> torch.Tensor:
        # the G2 tier's fall-through gather reads G3 page-wise
        self._maybe_chaos_truncate()
        return super().read_page(block_hash)

    # -- manifest journal --

    def _meta(self) -> dict:
        return {
            "g3_manifest": 1,
            "num_pages": self.num_pages,
            "page_shape": list(self.page_shape),
            "dtype": _DTYPE_NAME[self.dtype],
            "scale_shape": list(self.scale_shape),
        }

    def _ensure_journal(self):
        if self._journal is None and self.manifest_path is not None:
            fresh = (not os.path.exists(self.manifest_path)
                     or os.path.getsize(self.manifest_path) == 0)
            self._journal = open(self.manifest_path, "a")
            if fresh:
                self._journal.write(json.dumps(self._meta()) + "\n")
                self._journal.flush()
        return self._journal

    def _journal_write(self, rec: dict) -> None:
        j = self._ensure_journal()
        if j is None:
            return
        j.write(json.dumps(rec) + "\n")
        j.flush()
        self._journal_lines += 1
        if self._journal_lines > max(_JOURNAL_SLACK * self.num_pages, 256):
            self.compact_manifest()

    @staticmethod
    def _put_record(h: int, parent: int, slot: int, crc: int,
                    scale: Optional[torch.Tensor]) -> dict:
        return {
            "put": int(h), "parent": int(parent), "slot": int(slot),
            "crc": int(crc),
            "scale": (scale.to(torch.float32).reshape(-1).tolist()
                      if scale is not None else None),
        }

    def _on_put(self, h: int, parent: int, slot: int, crc: int,
                scale: Optional[torch.Tensor]) -> None:
        if self.manifest_path is None or self._owns_file:
            return
        self._journal_write(self._put_record(h, parent, slot, crc, scale))

    def _on_drop(self, h: int) -> None:
        if self.manifest_path is None or self._owns_file:
            return
        self._journal_write({"drop": int(h)})

    def compact_manifest(self) -> None:
        """Rewrite the journal as one line per live entry through a
        temporary file and an atomic rename: a crash mid-compaction
        leaves the old or the new manifest, never half of one."""
        if self.manifest_path is None or self._owns_file:
            return
        if self._journal is not None:
            self._journal.close()
            self._journal = None
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(self._meta()) + "\n")
            for h, (slot, parent, crc) in self._index.items():
                scale = (self._ensure_scales()[slot] if self.scale_shape
                         else None)
                f.write(json.dumps(self._put_record(
                    h, parent, slot, crc, scale)) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.manifest_path)
        self._journal_lines = len(self._index)

    @staticmethod
    def load_manifest(manifest_path: str):
        """Replay a manifest journal: (meta, live entries {hash: (slot,
        parent, crc, scale list or None)}, torn or invalid line count)."""
        meta = None
        live: "OrderedDict[int, tuple]" = OrderedDict()
        torn = 0
        with open(manifest_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    torn += 1  # torn tail / partial write
                    continue
                if "g3_manifest" in rec:
                    meta = rec
                elif "drop" in rec:
                    live.pop(int(rec["drop"]), None)
                elif "put" in rec:
                    try:
                        ent = (int(rec["slot"]), int(rec["parent"]),
                               int(rec["crc"]), rec.get("scale"))
                    except (KeyError, TypeError, ValueError):
                        torn += 1
                        continue
                    h = int(rec["put"])
                    live.pop(h, None)  # re-put: the newest slot wins
                    live[h] = ent
                else:
                    torn += 1
        return meta, live, torn

    def _attach(self) -> None:
        """Restart survival: replay the manifest against the existing
        file, scrubbing entries back into the index."""
        mpath = self.manifest_path
        if mpath is None or self._owns_file:
            return
        if not os.path.exists(mpath):
            return  # operator file with no manifest: attach empty
        try:
            meta, live, torn = self.load_manifest(mpath)
        except OSError as e:
            log.warning("G3 manifest unreadable (%s); starting empty", e)
            return
        dropped = torn
        if meta is not None and (
            meta.get("num_pages") != self.num_pages
            or list(meta.get("page_shape", [])) != list(self.page_shape)
            or meta.get("dtype") != _DTYPE_NAME[self.dtype]
            or list(meta.get("scale_shape", [])) != list(self.scale_shape)
        ):
            log.warning("G3 manifest geometry mismatch at %s; dropping %d "
                        "entries", mpath, len(live))
            dropped += len(live)
            live.clear()
        self._ensure_pool()
        used: set[int] = set()
        for h, (slot, parent, crc, scale) in live.items():
            scale_t = None
            if self.scale_shape:
                want_n = int(np.prod(self.scale_shape))
                if scale is None or len(scale) != want_n:
                    dropped += 1
                    continue
                scale_t = torch.tensor(scale, dtype=torch.float32).reshape(
                    self.scale_shape)
            if not (0 <= slot < self.num_pages) or slot in used:
                dropped += 1
                continue
            if self.scrub_on_start and page_checksum(
                    self._slot(slot), scale_t) != crc:
                dropped += 1
                KV_INTEGRITY.inc("dynamo_kv_integrity_failed_total")
                continue
            used.add(slot)
            self._index[h] = (slot, parent, crc)
            if self.scale_shape:
                self._ensure_scales()[slot] = scale_t
        self._free = [s for s in range(self.num_pages) if s not in used]
        self.scrub_recovered = len(self._index)
        self.scrub_dropped = dropped
        KV_INTEGRITY.inc("dynamo_kv_integrity_g3_scrub_recovered_total",
                         self.scrub_recovered)
        KV_INTEGRITY.inc("dynamo_kv_integrity_g3_scrub_dropped_total",
                         dropped)
        if self.scrub_on_start:
            KV_INTEGRITY.inc("dynamo_kv_integrity_verified_total",
                             self.scrub_recovered)
        log.info("G3 attach: %d blocks recovered, %d dropped (%s scrub) "
                 "from %s", self.scrub_recovered, dropped,
                 "eager" if self.scrub_on_start else "lazy", mpath)
        # restart the journal compact, so replayed puts and drops of the
        # previous life do not accrete
        self.compact_manifest()

    def close(self) -> None:
        if not self._owns_file:
            self.compact_manifest()
        if self._journal is not None:
            self._journal.close()
            self._journal = None
        if self._mm is not None:
            self._pool = None
            self._mm.flush()
            self._mm._mmap.close()
            self._mm = None
        if self._owns_file and self.path and os.path.exists(self.path):
            os.unlink(self.path)
            self.path = None


class HostOffloadTier(_PageTier):
    """G2: a host-memory pool, page-major and pinned when ``pin_memory``
    (an engine on CUDA). With a ``spill`` tier its LRU evictions go down
    into it (G2 -> G3) instead of being dropped, and ``lookup_run`` and
    ``gather`` fall through to it mid-run (reference offload.rs tier
    walk)."""

    def __init__(self, num_pages: int, page_shape: tuple,
                 dtype: torch.dtype, spill: Optional[_PageTier] = None,
                 scale_shape: tuple = (),
                 quarantine: Optional[KvQuarantine] = None,
                 pin_memory: bool = False):
        super().__init__(num_pages, page_shape, dtype,
                         scale_shape=scale_shape, quarantine=quarantine)
        self.spill = spill
        self.pin_memory = pin_memory

    def _ensure_pool(self) -> torch.Tensor:
        if self._pool is None:
            self._pool = torch.zeros((self.num_pages,) + self.page_shape,
                                     dtype=self.dtype,
                                     pin_memory=self.pin_memory)
        return self._pool

    def _slot(self, slot: int) -> torch.Tensor:
        return self._pool[slot]

    def _evict_one(self) -> None:
        old_h = self._pick_victim()
        old_slot, old_parent, old_crc = self._index.pop(old_h)
        if self.spill is not None:
            # the crc travels with the block down the spill: G3 inherits
            # G2's seal-time crc instead of minting one over bytes that
            # may already have rotted in memory
            self.spill.put_one(
                old_h, old_parent, self._slot(old_slot),
                self._ensure_scales()[old_slot] if self.scale_shape
                else None,
                checksum=old_crc)
        self._free.append(old_slot)
        self._on_drop(old_h)

    def lookup_run(self, hashes: list[int]) -> list[tuple[int, int]]:
        self.lookups += len(hashes)
        run: list[tuple[int, int]] = []
        for h in hashes:
            ent = self._index.get(h)
            if ent is not None:
                self._index.move_to_end(h)
                run.append((h, ent[1]))
                continue
            if self.spill is not None:
                sub = self.spill.lookup_run([h])
                if sub:
                    run.append(sub[0])
                    continue
            break
        self.onboard_hits += len(run)
        return run

    def checksum_of(self, block_hash: int) -> Optional[int]:
        ent = self._index.get(block_hash)
        if ent is not None:
            return ent[2]
        if self.spill is not None:
            return self.spill.checksum_of(block_hash)
        return None

    def _page(self, block_hash: int) -> torch.Tensor:
        if block_hash in self._index:
            return super()._page(block_hash)
        return self.spill.read_page(block_hash)

    def _scale(self, block_hash: int) -> torch.Tensor:
        if block_hash in self._index:
            return super()._scale(block_hash)
        return self.spill.read_scale(block_hash)

    def drop_everywhere(self, block_hash: int) -> None:
        self.drop(block_hash)
        if self.spill is not None:
            self.spill.drop(block_hash)

    def clear(self) -> int:
        n = super().clear()
        if self.spill is not None:
            n += self.spill.clear()
        return n
