"""KV data integrity: content checksums at every tier boundary and the
quarantine-and-recompute path (a copy of the JAX package's
kv_integrity.py, cut to the engine-local tiers).

The G1 -> G2 -> G3 tiers move raw page bytes addressed by chained block
hashes. One flipped bit on the way poisons every request that prefix-hits
the block, and in an int8 pool a corrupted f32 scale garbles a whole
block; the stream still completes, so nothing else would notice.

* **Minting**: a crc32 over a page's bytes, then its scale sidecar,
  computed when the block first lands in host memory (the offload copy
  of a parked pool page). It is keyed by and travels with the block
  hash from then on.
* **Carrying**: G2/G3 index entries hold (slot, parent, crc); the G3
  manifest journals them, so a restarted tier can verify its file.
* **Verifying**: an onboard checks the gathered tier bytes against the
  crcs before they reach the device pool.
* **Quarantine**: a mismatched block is dropped from every tier and its
  hash refused re-admission for a TTL; the stream treats it as a miss and
  recomputes it as prefill. Corruption costs latency, never tokens.

Checksums are zlib.crc32 over the C-order bytes, so a page's crc equals
the JAX package's for the same bytes (a bf16 page: its raw 2-byte
words). Pages here are torch CPU tensors. The wire half stamps each page
frame of the transfer plane (kv_transfer.py) with its pages' crcs
(``kv_crc``), which the receiver verifies before anything is scattered.
"""
from __future__ import annotations

import time
import zlib
from concurrent.futures import Executor
from typing import Any, Iterable, Optional

import torch

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_kv_integrity_verified_total", "counter",
     "KV pages whose content checksum verified clean at a tier or wire "
     "boundary"),
    ("dynamo_kv_integrity_failed_total", "counter",
     "KV pages that failed checksum verification (corruption detected "
     "before the bytes could reach a pool or a scatter)"),
    ("dynamo_kv_integrity_quarantined_total", "counter",
     "KV blocks quarantined after a checksum mismatch: dropped from "
     "every local tier and refused re-admission for the quarantine TTL"),
    ("dynamo_kv_integrity_recomputed_total", "counter",
     "KV blocks a stream recomputed as prefill because the cached copy "
     "failed verification (the latency cost of corruption)"),
    ("dynamo_kv_integrity_retries_total", "counter",
     "wire transfers retried once after a receiver integrity nack"),
    ("dynamo_kv_integrity_g3_scrub_recovered_total", "counter",
     "G3 manifest entries adopted at startup scrub (block verified or "
     "structurally sound and prefix-hittable again after restart)"),
    ("dynamo_kv_integrity_g3_scrub_dropped_total", "counter",
     "G3 manifest entries dropped at startup scrub (torn journal lines, "
     "bad slots, or checksum mismatches — recovered as cache misses)"),
)

KV_INTEGRITY = CounterRegistry(FAMILIES, (), label="kv-integrity")


class KvIntegrityError(RuntimeError):
    """A KV payload failed content-checksum verification."""

    def __init__(self, msg: str, bad_pages: tuple[int, ...] = ()):
        super().__init__(msg)
        self.bad_pages = tuple(bad_pages)


# ---------------------------------------------------------------------------
# checksums


def tensor_bytes(t: torch.Tensor) -> memoryview:
    """The C-order bytes of a CPU tensor, without a copy when it is
    contiguous (any dtype: viewed as bytes, so bf16 needs no numpy
    dtype)."""
    t = t.detach().contiguous()
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def checksum_bytes(*parts) -> int:
    """Chained crc32 over byte buffers (page payload, then sidecar)."""
    crc = 0
    for part in parts:
        crc = zlib.crc32(part, crc)
    return crc & 0xFFFFFFFF


def page_checksum(page: torch.Tensor,
                  scale: Optional[torch.Tensor] = None) -> int:
    """Content checksum of one KV page ``[2, L, kvh, ps, hd]`` plus its
    optional int8 scale sidecar ``[2, L]`` (as f32). A strided pool slice
    and a dense copy of the same block agree."""
    if scale is None:
        return checksum_bytes(tensor_bytes(page))
    return checksum_bytes(tensor_bytes(page),
                          tensor_bytes(scale.to(torch.float32)))


def page_checksums(data: Any, scales: Optional[torch.Tensor] = None,
                   pool: Optional[Executor] = None) -> list[int]:
    """Per-page checksums of a page batch ``[2, L, kvh, n, ps, hd]`` or a
    kv_quant.QuantizedPages bundle, whose scales are folded into each
    page's checksum (a flipped scale fails like a flipped payload byte).
    With ``pool`` the pages are checksummed on its threads (zlib releases
    the interpreter lock), in order."""
    if scales is None and hasattr(data, "scales"):
        data, scales = data.data, data.scales

    def one(i: int) -> int:
        return page_checksum(data[:, :, :, i],
                             scales[..., i] if scales is not None else None)

    n = int(data.shape[3])
    if pool is None or n < 2:
        return [one(i) for i in range(n)]
    return list(pool.map(one, range(n)))


# ---------------------------------------------------------------------------
# wire form: per-page crc list in the two-part frame's JSON header


def attach_wire_checksums(header: dict, data: Any,
                          pool: Optional[Executor] = None) -> None:
    """Stamp an outgoing page frame with per-page content checksums. Call
    it on the pre-serialization value (the QuantizedPages bundle, not its
    raw int8 payload) so the scales are covered."""
    header["kv_crc"] = page_checksums(data, pool=pool)


def verify_wire_payload(header: dict, data: Any, *, context: str = "wire",
                        pool: Optional[Executor] = None) -> None:
    """Receiver-side verify of a decoded page payload against the frame's
    ``kv_crc`` list. Frames without ``kv_crc`` pass unverified (the
    reference's behaviour for peers that predate the integrity plane)."""
    want = header.get("kv_crc")
    if want is None:
        return
    got = page_checksums(data, pool=pool)
    if len(want) != len(got):
        KV_INTEGRITY.inc("dynamo_kv_integrity_failed_total", len(got))
        raise KvIntegrityError(
            f"{context}: kv_crc count {len(want)} != {len(got)} pages")
    bad = tuple(i for i, (w, g) in enumerate(zip(want, got)) if int(w) != g)
    if bad:
        KV_INTEGRITY.inc("dynamo_kv_integrity_failed_total", len(bad))
        KV_INTEGRITY.inc("dynamo_kv_integrity_verified_total",
                         len(got) - len(bad))
        raise KvIntegrityError(
            f"{context}: checksum mismatch on pages {list(bad)} "
            f"of {len(got)}", bad_pages=bad)
    KV_INTEGRITY.inc("dynamo_kv_integrity_verified_total", len(got))


# ---------------------------------------------------------------------------
# quarantine


class KvQuarantine:
    """TTL'd deny-list of block hashes that failed verification: dropped
    from every local tier, refused re-admission (tier puts are no-ops)
    and never re-served. The TTL lets legitimately recomputed content
    re-cache later; a capacity cap bounds memory under a corruption
    storm."""

    def __init__(self, ttl_s: float = 300.0, max_entries: int = 4096):
        self.ttl_s = float(ttl_s)
        self.max_entries = int(max_entries)
        self._deadline: dict[int, float] = {}
        self.total = 0

    def add(self, block_hash: int) -> bool:
        """Quarantine a hash; False if it already was (no double count)."""
        now = time.monotonic()
        fresh = block_hash not in self._deadline
        self._deadline[block_hash] = now + self.ttl_s
        if fresh:
            self.total += 1
            KV_INTEGRITY.inc("dynamo_kv_integrity_quarantined_total")
            if len(self._deadline) > self.max_entries:
                self._expire(now)
                while len(self._deadline) > self.max_entries:
                    self._deadline.pop(next(iter(self._deadline)))
        return fresh

    def add_all(self, hashes: Iterable[int]) -> int:
        return sum(self.add(h) for h in hashes)

    def _expire(self, now: float) -> None:
        dead = [h for h, t in self._deadline.items() if t <= now]
        for h in dead:
            self._deadline.pop(h, None)

    def __contains__(self, block_hash: int) -> bool:
        t = self._deadline.get(block_hash)
        if t is None:
            return False
        if t <= time.monotonic():
            self._deadline.pop(block_hash, None)
            return False
        return True

    def __len__(self) -> int:
        self._expire(time.monotonic())
        return len(self._deadline)
