"""KV cache event types the page allocator emits (a copy of the event
dataclasses in the JAX package's kv_router/protocols.py)."""
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
