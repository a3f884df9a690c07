"""KV cache event types the page allocator emits, and the per-worker load
metrics the engine reports (a copy of the JAX package's
kv_router/protocols.py, cut to these dataclasses)."""
from __future__ import annotations

import enum
from dataclasses import asdict, dataclass, field
from typing import Any, Optional


class KvEventKind(str, enum.Enum):
    STORED = "stored"
    REMOVED = "removed"
    CLEARED = "cleared"


@dataclass
class StoredBlock:
    block_hash: int
    tokens_hash: Optional[int] = None  # hash of this block's tokens alone


@dataclass
class KvCacheEvent:
    """One cache mutation at a worker, broadcast on the event plane."""

    kind: KvEventKind
    worker_id: str = ""
    event_id: int = 0
    # STORED: blocks share one parent chain starting at parent_hash
    parent_hash: Optional[int] = None
    blocks: list[StoredBlock] = field(default_factory=list)
    # REMOVED: hashes evicted
    removed_hashes: list[int] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        d = asdict(self)
        d["kind"] = self.kind.value
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "KvCacheEvent":
        d = dict(d)
        d["kind"] = KvEventKind(d["kind"])
        d["blocks"] = [StoredBlock(**b) for b in d.get("blocks", [])]
        return cls(**d)


@dataclass
class KvStats:
    """Paged-cache occupancy at a worker (reference KvStats)."""

    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0
    # host-memory offload tier (KVBM G2); zero when the tier is disabled
    host_blocks: int = 0
    host_total_blocks: int = 0
    host_onboard_hits: int = 0
    # mmap-backed disk tier (KVBM G3); zero when the tier is disabled
    disk_blocks: int = 0
    disk_total_blocks: int = 0


@dataclass
class WorkerStats:
    """Batch occupancy at a worker (reference WorkerStats). The overload
    and speculation fields stay at their defaults until those planes are
    ported."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    num_requests_waiting: int = 0
    num_waiting_prefill_tokens: int = 0
    max_waiting_requests: int = 0
    max_waiting_prefill_tokens: int = 0
    spec_proposed_total: int = 0
    spec_accepted_total: int = 0
    spec_acceptance_rate: float = 0.0
    spec_effective_k: float = 0.0
    spec_effective_k_p50: float = 0.0
    spec_effective_k_p95: float = 0.0
    spec_tree_nodes_total: int = 0
    spec_tree_accepted_path_len_total: int = 0
    spec_gated_despecs_total: int = 0


@dataclass
class ForwardPassMetrics:
    """Per-forward-pass load metrics a worker publishes (reference
    protocols.rs:43-59). ``histograms``: latency histogram snapshots by
    name, empty when the worker exports none."""

    worker_id: str = ""
    worker_stats: WorkerStats = field(default_factory=WorkerStats)
    kv_stats: KvStats = field(default_factory=KvStats)
    histograms: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ForwardPassMetrics":
        d = dict(d)
        d["worker_stats"] = WorkerStats(**d.get("worker_stats") or {})
        d["kv_stats"] = KvStats(**d.get("kv_stats") or {})
        d.setdefault("histograms", {})
        return cls(**d)
