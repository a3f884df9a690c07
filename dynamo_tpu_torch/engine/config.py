"""Engine runtime configuration (a copy of the JAX package's
engine/config.py, cut to the knobs the PyTorch engine honours).

Decode rounds are pipelined by default (``round_pipeline``, as in the
reference) and, on the card, each round shape is replayed as one CUDA
graph (engine/graphs.py). The G2/G3 offload tiers, the engine-local
page-transfer plane, speculative decoding (``speculative`` "ngram" or
"draft", adaptive K, the acceptance gate, and tree speculation under
``spec_tree``), the overload budgets with priority preemption, and the
tenancy plane (a resident LoRA bank, per-tenant budgets and fair-share
weights) and the telemetry plane (flight ring, round attribution, SLO
targets, forensics sampling) are served. Sequence-parallel prefill is not ported yet: its
knob is kept here at the value that means "off", and any other value
raises, so a config written for the reference never silently runs
something else.
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
    "sp_prefill_threshold": None,
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

    # flight recorder (telemetry/flight.py): ring capacity of recent
    # engine-round events served at /debug/flight and dumped to the log
    # when an engine round fails
    flight_recorder_events: int = 256

    # performance-attribution plane (telemetry/prof.py): per-round
    # host-segment timers feeding dynamo_host_round_seconds{segment} and
    # /debug/prof. Always-on by design; the switch exists for A/B
    # measurement.
    prof_attribution: bool = True
    # SLO targets backing the dynamo_slo_{ttft,itl}_burn_rate gauges:
    # burn rate = frac-of-observations-over-target / (1 - objective),
    # recomputed from the live histograms at the metrics-publish cadence
    slo_ttft_target_s: float = 0.5
    slo_itl_target_s: float = 0.05
    slo_objective: float = 0.99
    # tail-latency forensics (telemetry/forensics.py): fraction of
    # NON-breaching finishes that still get a dossier captured worker-side
    # when no in-process frontend owns the request's trace. SLO breaches
    # are always captured; 0 disables sampling (breach capture stays on).
    forensics_sample_rate: float = 0.0
    # fleet prefix economy (kv_router/fleet.py): once the frontend's hint
    # digest is applied, dedup-by-hash admission consults it before a G4
    # probe round: fleet-known holders are probed first, and a demand
    # miss whose blocks the fleet hot set does not know at all skips the
    # probe. False restores hint-blind G4
    kv_dedup_admission: bool = True

    # speculative decoding (spec/): "off" | "ngram" | "draft". ngram needs
    # no extra model (prompt lookup against the request's own history);
    # draft needs a draft_config (and optionally draft_params) passed to
    # TorchEngine, a small model sharing the target's vocabulary. Eligible
    # slots (no logprobs) verify K proposed tokens per target forward
    # instead of taking the fused decode round
    speculative: str = "off"
    num_speculative_tokens: int = 4   # K a verify step (the cap when
                                      # spec_adaptive is on)
    spec_ngram_max: int = 3           # longest tail n-gram to match
    spec_ngram_min: int = 1
    # acceptance-adaptive K (spec/decoder.py AdaptiveKController): each
    # slot's effective K walks within [spec_min_k, num_speculative_tokens]
    # on an EWMA of its per-step acceptance, growing above
    # grow_threshold and shrinking below shrink_threshold; a slot whose
    # rate stays at or below despec_threshold after
    # spec_min_observations verify steps goes back to the fused round.
    # The round's width is the bucketed max of the participants' K
    spec_adaptive: bool = True
    spec_min_k: int = 1
    spec_grow_threshold: float = 0.8
    spec_shrink_threshold: float = 0.4
    spec_despec_threshold: float = 0.125
    spec_rate_ewma: float = 0.75      # weight of history in the rate
    spec_min_observations: int = 8    # verify steps before despec may fire
    # draft for every speculating slot in one batched program a round
    # (False: the per-slot loop, 1 + (k-1) programs a slot)
    spec_batch_draft: bool = True
    # tree speculation (spec/verifier.py spec_verify_tree): proposals form
    # a packed token tree, up to spec_branches candidates at a divergence
    # point, verified in one forward under a tree-causal ancestor mask;
    # acceptance walks the deepest surviving root-to-leaf path and only
    # that path's KV rows are committed. spec_tree_budget bounds the
    # packed node count (root included) so one verify shape serves every
    # tree; 0 = auto (1 + K * spec_branches, the full comb)
    spec_tree: bool = False
    spec_branches: int = 4
    spec_tree_budget: int = 0
    # acceptance gate: a stream whose acceptance EWMA stays below
    # spec_gate_acceptance for spec_gate_window consecutive verify steps
    # goes back to the fused round (0.0: no gate); it may re-arm after
    # spec_rearm_tokens emitted tokens, doubling each time it re-gates
    # (0: never re-arms)
    spec_gate_acceptance: float = 0.0
    spec_gate_window: int = 4
    spec_rearm_tokens: int = 256

    # overload plane (overload/): bounded admission. Intake past either
    # budget raises the retriable EngineOverloadedError (HTTP 429 +
    # Retry-After at the frontend) instead of growing the waiting queue,
    # and every admitted request's TTFT, without limit. 0 = unbounded.
    # A HIGH-priority arrival is admitted past them; the loop then
    # evicts the lowest-priority, newest waiting entry
    max_waiting_requests: int = 0
    # prompt-token budget over the same backlog
    max_waiting_prefill_tokens: int = 0
    # priority preemption, running half: a waiting HIGH-priority request
    # with no free lane force-evicts the lowest-priority RUNNING stream,
    # whose client stream fails with the retriable PreemptedError: the
    # router replays it on a peer (a migration)
    preempt_running: bool = False

    # tenancy plane (tenancy/). A resident LoRA bank of this many adapter
    # slots (row 0 is the all-zeros identity = the base model) at rank
    # lora_rank, in the compute dtype, read by every prefill and decode
    # round: mixed adapter ids run in one round. 0 = no bank: the engine
    # runs exactly the programs it runs without tenancy
    lora_adapters: int = 0
    lora_rank: int = 8
    # per-tenant slices of the backlog budgets above (0 = unbounded): one
    # tenant's storm exhausts its own slice, and bounces with a
    # Retry-After from its own observed queue waits, before it can crowd
    # the global queue
    tenant_max_waiting_requests: int = 0
    tenant_max_waiting_prefill_tokens: int = 0
    # fair-share weights of the waiting queue's order (tenant -> weight,
    # default 1.0); they bias the order, not the budgets
    tenant_weights: Optional[dict] = None

    # not ported yet: see _UNPORTED
    sp_prefill_threshold: Optional[int] = None

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
