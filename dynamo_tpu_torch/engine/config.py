"""Engine runtime configuration (a copy of the JAX package's
engine/config.py, cut to the knobs the PyTorch engine honours).

Decode rounds are pipelined by default (``round_pipeline``, as in the
reference) and, on the card, each round shape is replayed as one CUDA
graph (engine/graphs.py). The G2/G3 offload tiers and the engine-local
page-transfer plane are served. The reference's other planes
(speculation, tenancy quotas, overload budgets, sequence-parallel
prefill) are not ported yet. Their knobs are kept here at the values
that mean "off", and any other value raises, so a config written for
the reference never silently runs something else.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


def _default_buckets() -> tuple[int, ...]:
    return (128, 256, 512, 1024, 2048, 4096)


def pow2_cover(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo) — the bucketing of page-list
    and seal-batch widths (padding always targets scratch page 0)."""
    w = lo
    while w < n:
        w *= 2
    return w


# knobs of the reference that this engine does not serve yet, with the
# only value it accepts (the reference's "off")
_UNPORTED = {
    "speculative": "off",
    "lora_adapters": 0,
    "sp_prefill_threshold": None,
    "max_waiting_requests": 0,
    "max_waiting_prefill_tokens": 0,
    "preempt_running": False,
}


@dataclass
class EngineConfig:
    """Knobs of the continuous-batching engine."""

    # prefix-cache pool (the paged pool is prefix-cache STORAGE; the
    # serving context is a contiguous per-slot region — models/llama.py)
    num_pages: int = 512          # pool capacity incl. reserved page 0
    page_size: int = 64           # tokens per page (also the block size)
    # per-slot context capacity in pages: max_context = this * page_size
    max_pages_per_seq: int = 64

    # batching
    max_decode_slots: int = 8     # fixed decode batch width
    prefill_buckets: tuple[int, ...] = field(default_factory=_default_buckets)

    # steps per dispatched round (decode+sample steps, then one ring->ctx
    # flush and one stacked token copy to the host) and rounds allowed in
    # flight before the loop blocks on results
    flush_every: int = 4
    max_inflight_rounds: int = 2
    # prefill chunks dispatched per scheduling round
    prefill_chunks_per_round: int = 2
    # batched multi-request prefill: concurrent same-bucket chunks run as
    # one [K, T] batch; K <= min(prefill_batch_max, budget // T)
    prefill_batch_max: int = 8
    prefill_token_budget: int = 8192

    # sampling: static top-k width for top-p/top-k sampling
    max_top_k: int = 64
    # static top-N width for logprobs (OpenAI caps top_logprobs at 20);
    # only rounds with a slot asking for logprobs compute them
    max_logprobs: int = 20

    # prefix cache
    enable_prefix_caching: bool = True

    # model memory
    cache_dtype: str = "bfloat16"
    # "int8": the serving ctx region and the prefix pool hold int8 K/V
    # with per-group absmax scales (the ring stays cache_dtype)
    kv_quant: str = "none"

    # identity on the control plane
    worker_id: str = ""

    # round pipelining: when nothing pending would patch slot state, the
    # next round is dispatched BEFORE the previous round's tokens are
    # consumed, so host processing overlaps device execution. False is
    # the strict process-then-dispatch order (the differential baseline)
    round_pipeline: bool = True

    # host-memory offload tier (KVBM G2): 0 disables. Pages parked in the
    # LRU are copied to a host pool of this many pages behind compute;
    # prefix misses in HBM onboard from it instead of recomputing
    host_offload_pages: int = 0
    # mmap-backed disk tier (KVBM G3, reference storage/disk.rs:25): 0
    # disables. G2's LRU evictions spill into it; requires G2 (the tier
    # hierarchy is strict: G1 -> G2 -> G3)
    disk_offload_pages: int = 0
    # backing file of the G3 pool (None = a fresh temporary file per
    # engine). With a path the tier survives a restart: a manifest
    # (<path>.manifest) journals slot -> (hash, crc) and is replayed at
    # attach
    disk_offload_path: Optional[str] = None
    # eager G3 startup scrub: re-checksum every manifest entry against
    # the file at attach, dropping mismatches. Off = verify at each
    # onboard gather (the same safety, paid per hit)
    scrub_on_start: bool = False
    # offload gathers per scheduling round (pages)
    offload_batch: int = 8
    # page transfers in chunks of this many pages (onboard scatters,
    # export streams): host staging O(chunk), not O(transfer). 0 = one
    # chunk
    kv_transfer_chunk_pages: int = 8
    # chunk gathers in flight per export stream (the double-buffer depth)
    kv_transfer_inflight_chunks: int = 2
    # deadline of one queued page export/import op (engine._xfer_op)
    xfer_op_timeout_s: float = 120.0
    # an export stream that moved nothing for this long is abandoned: its
    # page pins are released and its consumer gets an error
    kv_transfer_stream_idle_timeout_s: float = 15.0

    # not ported yet: see _UNPORTED
    speculative: str = "off"
    lora_adapters: int = 0
    sp_prefill_threshold: Optional[int] = None
    max_waiting_requests: int = 0
    max_waiting_prefill_tokens: int = 0
    preempt_running: bool = False

    def __post_init__(self):
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"EngineConfig.kv_quant={self.kv_quant!r}: expected 'none' "
                f"or 'int8'")
        if self.disk_offload_pages > 0 and self.host_offload_pages <= 0:
            raise ValueError(
                "disk_offload_pages (G3) requires host_offload_pages (G2): "
                "the tier hierarchy is strict (block_manager.rs:69-82)")
        for name, off in _UNPORTED.items():
            if getattr(self, name) != off:
                raise ValueError(
                    f"EngineConfig.{name}={getattr(self, name)!r}: not "
                    f"supported by the PyTorch engine yet (only {off!r})")

    @property
    def max_context(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def bucket_for(self, n_tokens: int) -> Optional[int]:
        """Smallest prefill bucket holding n_tokens."""
        for b in self.prefill_buckets:
            if n_tokens <= b:
                return b
        return None
