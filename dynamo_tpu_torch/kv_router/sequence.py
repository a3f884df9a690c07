"""Predicted per-worker active-block tracking (the port's copy of the JAX
package's kv_router/sequence.py).

Parity: reference kv_router/sequence.rs — ActiveSequences (:74) tracks each
in-flight request's token sequence as shared full blocks (dedup by chained
hash) plus one private partial block per unfinished tail;
ActiveSequencesMultiWorker (:247) keeps one tracker per worker. The
reference spreads workers across threads; here one asyncio loop owns all of
them, so it's a plain dict.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.tokens import TokenBlockSequence

RequestId = str
WorkerId = str


class ActiveSequences:
    """Blocks a single worker would hold for its in-flight requests."""

    def __init__(self, block_size: int):
        assert block_size > 1, "block_size must be greater than 1"
        self.block_size = block_size
        self._seqs: dict[RequestId, TokenBlockSequence] = {}
        self._block_refs: dict[int, set[RequestId]] = {}  # full-block hash
        self._partial: set[RequestId] = set()

    @property
    def active_blocks(self) -> int:
        return len(self._block_refs) + len(self._partial)

    def _full_hashes(self, seq: TokenBlockSequence) -> list[int]:
        return [b.block_hash for b in seq.blocks]

    def add_request(self, request_id: RequestId, seq: TokenBlockSequence) -> int:
        for h in self._full_hashes(seq):
            self._block_refs.setdefault(h, set()).add(request_id)
        if seq.total_tokens % self.block_size != 0:
            self._partial.add(request_id)
        self._seqs[request_id] = seq
        return self.active_blocks

    def new_blocks(self, seq: TokenBlockSequence) -> int:
        """Blocks this sequence would ADD if scheduled here
        (sequence.rs new_blocks)."""
        n = sum(1 for h in self._full_hashes(seq) if h not in self._block_refs)
        if seq.total_tokens % self.block_size != 0:
            n += 1  # its private partial block
        return n

    def potential_blocks(self, seq: TokenBlockSequence) -> int:
        return self.new_blocks(seq) + self.active_blocks

    def push(self, request_id: RequestId, token: int) -> int:
        """Record one generated token (sequence.rs push)."""
        seq = self._seqs.get(request_id)
        if seq is None:
            return self.active_blocks
        for blk in seq.extend([token]):
            self._block_refs.setdefault(blk.block_hash, set()).add(request_id)
        if seq.total_tokens % self.block_size != 0:
            self._partial.add(request_id)
        else:
            self._partial.discard(request_id)
        return self.active_blocks

    def free(self, request_id: RequestId) -> int:
        seq = self._seqs.pop(request_id, None)
        if seq is None:
            return self.active_blocks
        for h in self._full_hashes(seq):
            refs = self._block_refs.get(h)
            if refs is not None:
                refs.discard(request_id)
                if not refs:
                    del self._block_refs[h]
        self._partial.discard(request_id)
        return self.active_blocks


class ActiveSequencesMultiWorker:
    """One ActiveSequences per worker + request->worker routing
    (sequence.rs:247)."""

    def __init__(self, block_size: int, worker_ids: list[WorkerId]):
        self.block_size = block_size
        self._workers: dict[WorkerId, ActiveSequences] = {
            w: ActiveSequences(block_size) for w in worker_ids
        }
        self._request_worker: dict[RequestId, WorkerId] = {}

    def update_workers(self, worker_ids: list[WorkerId]) -> None:
        """Reconcile with discovery: add new workers, drop departed ones."""
        for w in worker_ids:
            self._workers.setdefault(w, ActiveSequences(self.block_size))
        for w in list(self._workers):
            if w not in worker_ids:
                del self._workers[w]
                self._request_worker = {
                    r: ww for r, ww in self._request_worker.items() if ww != w
                }

    def worker_ids(self) -> list[WorkerId]:
        return list(self._workers)

    def potential_blocks(self, seq: TokenBlockSequence) -> dict[WorkerId, int]:
        """Blocks each worker WOULD hold if this request landed there —
        the scheduler's load term."""
        return {
            w: t.potential_blocks(seq) for w, t in self._workers.items()
        }

    def active_blocks(self) -> dict[WorkerId, int]:
        return {w: t.active_blocks for w, t in self._workers.items()}

    def add_request(
        self, request_id: RequestId, worker_id: WorkerId, seq: TokenBlockSequence
    ) -> None:
        self._request_worker[request_id] = worker_id
        if worker_id in self._workers:
            self._workers[worker_id].add_request(request_id, seq)

    def push(self, request_id: RequestId, token: int) -> None:
        w = self._request_worker.get(request_id)
        if w is not None and w in self._workers:
            self._workers[w].push(request_id, token)

    def free(self, request_id: RequestId) -> None:
        w = self._request_worker.pop(request_id, None)
        if w is not None and w in self._workers:
            self._workers[w].free(request_id)
