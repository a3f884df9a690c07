"""TorchEngine: continuous batching over contiguous per-slot KV, in
PyTorch (port of the JAX package's TpuEngine main path).

  - Serving context is contiguous per slot (``ctx``); the paged pool is
    prefix-cache storage, copied in at admission (load_ctx_pages) and out
    at block seal (seal_blocks). Decode attention goes through the Hopper
    flash-decode kernel (ops/flash_decode.py). With ``kv_quant="int8"``
    the region and the pool are int8 with per-group scales and decode
    runs the kernel's int8 mode; the ring stays in ``cache_dtype``. A
    model with w8a16 weights (``config.quant="int8"``) runs every weight
    product through the w8a16 GEMM kernel (ops/w8a16.py).
  - Decode state lives on the device at fixed addresses: last tokens,
    context lengths, write destinations, the sampler's threefry keys and
    counts and per-slot sampling knobs. A round is ``flush_every``
    decode+sample steps, then the ring->ctx flush and the round's queued
    block seals (engine/graphs.py): on the card each round shape is one
    CUDA graph, captured when the engine is built and replayed, so a
    round costs one graph launch; the CPU runs the same round function
    eagerly. Its tokens [F, B] come back in ONE device->host copy into a
    pinned buffer (plus one packed logprob copy [F, B, 1+2K] in rounds where a
    slot asked for logprobs), which the host reads a bounded lag
    (``max_inflight_rounds``) behind dispatch. All-greedy rounds take a
    bare argmax and touch no key, as the reference's ``want_sample``
    gate does.
  - Rounds are pipelined (``round_pipeline``, on by default as in the
    reference): when nothing pending would patch slot state (no waiting
    or fresh request, no release, no seal overflow) the next round is
    dispatched before the previous round's tokens are processed, so the
    host's processing overlaps the device's round; otherwise the round
    runs the strict process-then-dispatch order.
  - Host processing (token emission, stop detection, block sealing,
    admission) runs on lagged results. Releases and admissions patch the
    device state between rounds, one fixed-shape program (a graph on the
    card); a freed slot's lane is redirected to the scratch lane so its
    in-flight garbage steps never touch a lane being re-prefilled. One
    CUDA stream keeps every program in dispatch order.
  - Intake follows the reference's overload plane: a request whose
    deadline has passed is shed with zero tokens and the DEADLINE finish,
    at intake or while it still waits; a high-priority arrival queues
    ahead of every not-started lower-priority entry; and entries of one
    priority are ordered per tenant by start-time fair queuing, each
    tenant's stamps advanced by prompt length over its weight
    (``tenant_weights``; one tenant stays FIFO). With queue budgets
    (``max_waiting_requests``, ``max_waiting_prefill_tokens``, and their
    per-tenant slices ``tenant_max_waiting_*``) an arrival past a budget
    is refused with the retriable EngineOverloadedError and a
    load-derived Retry-After; a HIGH-priority arrival is admitted past
    it, and the loop restores the budget by evicting the lowest-priority,
    newest waiting entry (within the offending tenant for a tenant
    budget). With ``preempt_running`` a HIGH-priority request blocked on
    a lane evicts the lowest-priority running stream with PreemptedError,
    which a router turns into a migration.
  - Tenancy: with ``lora_adapters`` the engine holds a resident LoRA bank
    (tenancy/adapters.py; ``install_adapter``) in its params; a
    request's ``adapter_id`` rides into its prefill and into the slot's
    device state (``dev["adapter"]``, set by the admission patch and
    cleared by a release), so the round graph runs mixed adapters in one
    replay. Speculation stays with adapter 0.
  - Prefill runs batched per prefill bucket (batch_prefill); a group of
    one runs the single-request prefill (llama.prefill), as the
    reference does. The first token is sampled on the device with its
    own key stream and patched into the slot without a host round trip.

  - KV offload (``host_offload_pages``, ``disk_offload_pages``): a
    committed page that parks in the pool's LRU is a candidate; once a
    round the candidates still holding their block are gathered on the
    card (after the queued seals, in stream order) and copied to pinned
    host memory on a copy stream behind compute, then put into the G2
    tier (engine/offload.py), which spills its LRU evictions into G3 on
    disk. The puts (crc32s on a thread pool, copies, the spill) run on a
    put thread, off the loop, under a lock the loop's onboards take. A
    prefix that misses in HBM continues from G2/G3: each chunk of the run
    is gathered on the host, verified against its crc and copied to the
    card ahead of the admission's ``load_ctx_pages`` in stream order; a
    block that fails its crc is quarantined and it and the rest of the
    run are recomputed as prefill (kv_integrity.py).
  - Page transfers (``export_pages``, ``import_pages``,
    ``export_pages_by_hash``, the chunked ``export_pages_stream`` and
    ``export_hash_stream``, ``clear_kv_blocks``) are thread-safe: each is
    queued to the engine loop and serviced at a round boundary, in the
    round order of the reference: transfers, export streams, offloads,
    then admission. Exports gather in the wire's layout (``[2, L, kvh,
    n, ps, hd]``, contiguous), so the transfer plane (kv_transfer.py)
    sends them without a copy. ``metrics()`` reports
    ``ForwardPassMetrics`` with the G2/G3 occupancy.
  - Commit events (``subscribe_commits``): a callback fires on the engine
    thread when prefill commits prompt blocks and when a seal batch's
    copies are dispatched; the disagg prefill worker (disagg.py) streams
    each new run of blocks to the decode worker on it.
  - G4 (``remote_kv``, a kv_transfer.RemoteKvFetcher): with a G2 tier, a
    request whose prefix misses G1/G2/G3 first fetches it from a peer
    worker's pool; the pages land in G2 on the loop ahead of admission
    and onboard from there (``remote_onboard_blocks`` counts them); the
    ``corrupt_prefetch`` chaos point rots one landed page there.
  - The fleet prefix economy: ``apply_fleet_hints`` keeps the frontend's
    replica and holder digest (``fleet_hints``, a kv_router/fleet.py
    FleetHints) and wires its replica counts into G2/G3 eviction; dedup
    admission (``kv_dedup_admission``) probes the hinted holders first
    and skips the probe round for a prefix the fleet does not know; the
    frontend's controller pushes hot prefixes through ``prefetch_hashes``,
    whose pages land through the same ingest queue as demand fetches.
  - Graceful drain (``begin_drain``, ``drained``): admissions are refused
    with WorkerDrainingError, the pipeline falls back to the strict order
    (``pipe_flushes["drain"]``), and ``drained()`` holds once no request
    and no round is left in flight.
  - Speculative decoding (``speculative`` "ngram" or "draft", spec/): an
    eligible request (no logprobs) is admitted with its lane PARKED on
    the scratch lane, as a freed slot's is, so the fused round (and its
    graph) treats it as free; its state lives on the host and it advances
    through verify dispatches (``_dispatch_spec``): one batched draft
    (draft mode) and one score + accept program for every ready slot,
    run eagerly, whose packed result comes back in one copy. Adaptive K
    sets the round's width; a slot whose acceptance collapses, or that
    nears the region's end, goes back to the fused round through an
    admission patch that restores its token, context, keys and penalty
    counts (``_despeculate``); the acceptance gate does the same and may
    re-arm it later. Rounds are not pipelined while a slot speculates
    (``pipe_flushes["spec"]``). Under ``spec_tree`` a round packs a token
    tree a slot instead (``_dispatch_spec_tree``: an n-gram trie, or a
    comb from one batched draft), verifies it under a tree-causal mask,
    commits only the accepted path's KV rows, and returns one packed
    [B, 2D+4] result (``_process_spec_tree``).

  - Telemetry (telemetry/): the request histograms (TTFT, ITL, E2E,
    queue wait, round time) observed with the request id as exemplar and
    published in ``metrics()``; a flight ring of recent dispatches
    (``flight``, dumped to the log when a round fails); per-round host
    attribution (``prof``, a flat switch over SEGMENTS whose sums equal
    the round's wall time) folded into PROF with the SLO burn rates at
    the publish cadence; and a request's worker-side spans (queue,
    prefill, g2_onboard, g4_fetch with its g4_chunk children, and a
    capped run of round spans, with spec_draft and spec_verify children
    on speculative rounds), shipped in the finishing output's
    ``annotations["trace"]``. Every timer reads the host clock: no
    telemetry code reads or synchronizes the device.

Not ported yet (ROADMAP.md): multimodal and MoE.
"""
from __future__ import annotations

import asyncio
import logging
import os
import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine import graphs, sampling
from dynamo_tpu_torch.engine.cache import PageAllocator
from dynamo_tpu_torch.engine.config import EngineConfig, pow2_cover
from dynamo_tpu_torch.engine.offload import DiskOffloadTier, HostOffloadTier
from dynamo_tpu_torch.kv_integrity import (
    KV_INTEGRITY,
    KvQuarantine,
    page_checksums,
)
from dynamo_tpu_torch.kv_fleet_metrics import KV_FLEET
from dynamo_tpu_torch.kv_quant import KV_QUANT, QuantizedPages, to_pool_dtype
from dynamo_tpu_torch.resilience.chaos import CHAOS
from dynamo_tpu_torch.resilience.drain import WorkerDrainingError
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    KvStats,
    WorkerStats,
)
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.overload.admission import AdmissionController
from dynamo_tpu_torch.overload.deadline import PRIORITY_HIGH
from dynamo_tpu_torch.overload.errors import (
    EngineOverloadedError,
    PreemptedError,
)
from dynamo_tpu_torch.overload.metrics import OVERLOAD
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.spec.decoder import SpecDecoder
from dynamo_tpu_torch.spec.metrics import SPEC
from dynamo_tpu_torch.spec.proposer import comb_parents
from dynamo_tpu_torch.telemetry import metrics as tmetrics
from dynamo_tpu_torch.telemetry import prof as tprof
from dynamo_tpu_torch.telemetry.flight import FlightRecorder
from dynamo_tpu_torch.telemetry.forensics import ForensicsCapture
from dynamo_tpu_torch.telemetry.prof import PROF, RoundProf
from dynamo_tpu_torch.telemetry.trace import TRACES, Span, span_now
from dynamo_tpu_torch.tenancy.adapters import init_adapter_bank, set_adapter
from dynamo_tpu_torch.tenancy.metrics import TENANT
from dynamo_tpu_torch.tenancy.quotas import TenantQuotas
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger(__name__)

_FIRST_TOKEN_KEY_TAG = 0x46697273  # distinct PRNG stream for first tokens

# a request's round spans shipped in its finishing annotation are capped
# (a 10k-token generation must not grow a 10k-entry span list); the
# total round count still travels in the timing annotation
_MAX_ROUND_SPANS = 24
# requests flagged "trace_detail" by the frontend (forensics candidates:
# every request, since a breach is only known at finish) keep a deeper
# run, so a late promotion yields a complete dossier
_MAX_ROUND_SPANS_DETAIL = 256


def _span_dict(name: str, t0_monotonic: float, **attrs) -> dict:
    """Span ending now that began at monotonic ``t0_monotonic``, in the
    annotation's wire form."""
    return span_now(name, t0_monotonic, **attrs).to_dict()


# attribution-segment indices (telemetry/prof.py SEGMENTS), bound once so
# the round loop's enter() calls pass ints
_SEG_INTAKE = tprof.SEGMENTS.index("intake")
_SEG_SLOT_SCAN = tprof.SEGMENTS.index("slot_scan")
_SEG_FETCH = tprof.SEGMENTS.index("fetch")
_SEG_ANNOTATE = tprof.SEGMENTS.index("annotate")
_SEG_RELEASES = tprof.SEGMENTS.index("releases")
_SEG_TRANSFER = tprof.SEGMENTS.index("transfer")
_SEG_OFFLOAD = tprof.SEGMENTS.index("offload")
_SEG_ADMIT = tprof.SEGMENTS.index("admit")
_SEG_SEAL_ASM = tprof.SEGMENTS.index("seal_assembly")
_SEG_DISPATCH = tprof.SEGMENTS.index("dispatch")
_SEG_SPEC = tprof.SEGMENTS.index("spec_dispatch")
_SEG_SEAL_FLUSH = tprof.SEGMENTS.index("seal_flush")
_SEG_METRICS = tprof.SEGMENTS.index("metrics_fold")


def _wall_time() -> float:
    """Unix time: the clock request deadlines are stamped in."""
    return time.time()


def _sampling_knobs(so) -> dict[str, Any]:
    """A request's sampler knobs, as the device state holds them."""
    return dict(
        temp=float(so.temperature or 0.0),
        top_k=int(so.top_k or 0),
        top_p=float(so.top_p if so.top_p is not None else 1.0),
        freq=float(so.frequency_penalty or 0.0),
        pres=float(so.presence_penalty or 0.0),
        rep=float(so.repetition_penalty or 1.0),
    )


@dataclass
class _Request:
    req: PreprocessedRequest
    seq: TokenBlockSequence
    out: asyncio.Queue
    loop: asyncio.AbstractEventLoop
    # the prompt — kept separate from req.token_ids so engine-side state
    # never mutates the caller's request object
    tokens: list[int] = field(default_factory=list)
    tenant: str = "default"
    # start-time fair queuing stamp: the tenant's virtual finish time
    vft: float = 0.0
    # the prompt is counted in the waiting backlog (the budgets' counters:
    # set at intake, cleared exactly once at lane acquisition or exit)
    counted: bool = False
    matched_blocks: int = 0
    # prompt blocks already copy-committed into the prefix cache
    sealed_prefix: int = 0
    # chunked-prefill progress: tokens already in the region (-1 = not
    # started)
    prefill_pos: int = -1
    slot: int = -1
    produced: int = 0
    last_token: int = -1          # newest processed token, not yet in seq
    cancelled: bool = False
    finished: bool = False
    enqueue_time: float = field(default_factory=time.monotonic)
    first_token_time: Optional[float] = None
    t_prefill_start: Optional[float] = None
    # telemetry: worker-side span dicts (queue, prefill, g2_onboard,
    # g4_fetch), the round spans as raw tuples (kind, t0_monotonic,
    # duration_s, n_tokens, spec_host) turned into dicts once at finish,
    # the round-batched inter-token gaps as (gap_s, n), and their clock
    trace_spans: list[dict] = field(default_factory=list)
    round_spans: list[tuple] = field(default_factory=list)
    itl_gaps: list[tuple] = field(default_factory=list)
    t_last_emit: Optional[float] = None
    decode_rounds: int = 0
    # the frontend's "trace_detail" annotation: lifts the round-span cap
    trace_detail: bool = False
    # speculative decoding (spec/): a speculating slot's lane stays PARKED
    # on the scratch lane; its real state lives here and in the ctx
    # region, advanced by verify dispatches instead of the fused round
    spec: bool = False
    spec_ready: bool = False       # the host knows the pending token
    spec_inflight: bool = False    # a verify dispatch is outstanding
    # the full sequence incl. the pending token (the region holds KV for
    # all but the last): the proposers' lookup corpus
    spec_tokens: list[int] = field(default_factory=list)
    spec_keys: Optional[np.ndarray] = None  # [2] threefry key (uint32s)
    # host mirror of the sampler's output-token counts [V], for penalized
    # requests only (the penalized accept path reads it; a despec
    # restores it onto the device)
    spec_counts: Optional[np.ndarray] = None
    spec_proposed: int = 0
    spec_accepted: int = 0
    # acceptance gate: a gated stream runs on the fused round (spec False)
    # but keeps mirroring its sequence and counts (_spec_gated_advance) so
    # speculation can re-arm mid-stream
    spec_gated: bool = False
    spec_rearm_left: int = 0     # fused tokens until a re-arm attempt
    spec_gate_backoff: int = 1   # re-arm budget multiplier (doubles)
    # re-arm drain: in-flight rounds whose snapshot still steps this lane
    # (their tokens are real and must be mirrored first)
    spec_rearm_wait: int = 0

    @property
    def adapter_id(self) -> int:
        return int(self.req.adapter_id or 0)

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)

    def max_new_tokens(self, max_context: int) -> int:
        mt = self.req.stop_conditions.max_tokens
        cap = max_context - self.prompt_len
        return min(mt, cap) if mt is not None else cap

    def emit(self, item: LLMEngineOutput | Exception) -> None:
        # the client's event loop can be gone by the time the engine
        # thread emits (teardown): never mask the original failure
        try:
            self.loop.call_soon_threadsafe(self.out.put_nowait, item)
        except RuntimeError:
            log.debug("dropped emit to a closed event loop (shutdown)")


class _Fetch:
    """A device->host copy in flight: a pinned host buffer filled with a
    non-blocking copy, and the CUDA event recorded after it. With a
    ``stream`` (the engine's copy stream) the copy runs there, behind an
    event recorded on the compute stream after ``src`` was made, so it
    overlaps the rounds dispatched after it; ``src`` is kept for the copy
    stream (``record_stream``) and the copy's start and end are timed.
    CPU results are copied at once."""

    def __init__(self, src: torch.Tensor,
                 stream: Optional[torch.cuda.Stream] = None):
        self.event = None
        self.timing: Optional[tuple] = None
        if not src.is_cuda:
            self.host = src.clone()
            return
        self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        if stream is None:
            self.host.copy_(src, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            return
        made = torch.cuda.Event()
        made.record()
        with torch.cuda.stream(stream):
            stream.wait_event(made)
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record()
            self.host.copy_(src, non_blocking=True)
            src.record_stream(stream)
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        self.timing = (t0, self.event)

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host

    def numpy(self) -> np.ndarray:
        return self.wait().numpy()


@dataclass
class _Entry:
    """One in-flight fetch: a round of stacked step tokens, a request's
    prefill first token (with its packed logprobs when asked for), or an
    offload batch of gathered pool pages (with their scales in an int8
    pool, in ``lp_fetch``)."""

    kind: str                      # "round" | "first" | "offload" | "spec"
                                   # | "spec_tree"
    fetch: _Fetch
    lp_fetch: Optional[_Fetch] = None
    # round: the slot snapshot at dispatch
    slots: list[Optional[_Request]] = field(default_factory=list)
    n_steps: int = 0
    # first:
    request: Optional[_Request] = None
    # offload: the batch's block hashes and their parents
    hashes: list[int] = field(default_factory=list)
    parents: list[int] = field(default_factory=list)
    # spec: (slot, request, history length at dispatch) per row
    rows: list[tuple] = field(default_factory=list)
    # spec_tree: (round fan M, parents [n, T], proposal nodes a row)
    tree: Optional[tuple] = None
    # telemetry: host dispatch time (dynamo_engine_round_seconds and the
    # round span), and a verify's (draft_s, verify_s) host walls, the
    # spec_draft and spec_verify child spans
    t_dispatch: float = 0.0
    spec_host: Any = None


# closes an export stream's chunk queue (engine loop -> consumer)
_STREAM_EOS = object()


@dataclass
class _ExportStream:
    """One chunked page export in flight: the engine loop advances it a
    little every round (dispatching up to ``inflight`` chunk gathers and
    copies, handing ready chunks to the consumer's queue) and never
    blocks on the consumer."""

    ids: list[int]
    chunk_pages: int
    inflight: int
    out_q: queue_mod.Queue
    pos: int = 0                      # next page index to gather
    # (data fetch, scales fetch or None, page_major) per dispatched,
    # unhanded chunk
    pending: deque = field(default_factory=deque)
    # hash-addressed exports pin their matched pages until every gather
    # is dispatched (stream order then protects the reads)
    free_pages: Optional[list[int]] = None
    # the last time the stream moved: one whose consumer vanished parks
    # with a full queue, and is reclaimed after
    # ``kv_transfer_stream_idle_timeout_s``
    last_progress: float = field(default_factory=time.monotonic)


class TorchEngine:
    """Continuous-batching engine with a contiguous per-slot KV region,
    on one device. ``generate(PreprocessedRequest)`` streams
    LLMEngineOutput deltas, as TpuEngine does."""

    def __init__(
        self,
        model_config: ModelConfig,
        engine_config: Optional[EngineConfig] = None,
        *,
        params: Any = None,
        device: str | torch.device | None = None,
        rng_seed: int = 0,
        on_kv_event: Optional[Callable[[KvCacheEvent], None]] = None,
        on_metrics: Optional[Callable[[ForwardPassMetrics], None]] = None,
        draft_config: Optional[ModelConfig] = None,
        draft_params: Any = None,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchEngine runs on CUDA unless device='cpu' is "
                    "passed, and no CUDA device is available")
            device = "cuda"
        self.device = torch.device(device)
        self.config = c = model_config
        self.ecfg = e = engine_config or EngineConfig()
        dtype = llama.torch_dtype(e.cache_dtype)
        if params is None:
            params = llama.init_params(c, rng_seed, self.device)
        # resident LoRA bank (tenancy/adapters.py): rides in the params
        # (params["adapters"]) in the compute dtype; row 0 is the all-zeros
        # identity = the base model, exactly. Without one every program is
        # the one an engine without tenancy runs
        self.n_adapters = max(0, e.lora_adapters)
        if self.n_adapters > 0:
            params = dict(params, adapters=init_adapter_bank(
                c, self.n_adapters, e.lora_rank, dtype=dtype,
                device=self.device))
        self.params = params
        # paged pool: prefix-cache STORAGE; contiguous per-slot serving
        # context (+1 scratch lane); the round's decode write ring. Under
        # kv_quant=int8 the pool and the region are int8 with a scale per
        # page and per (lane, page-sized group); the ring stays dtype
        self.kv_quant = e.kv_quant == "int8"
        self.cache = llama.init_cache(c, e.num_pages, e.page_size, dtype,
                                      self.device, kv_quant=e.kv_quant)
        self.ctx = llama.init_ctx(c, e.max_decode_slots, e.max_context,
                                  dtype, self.device, kv_quant=e.kv_quant,
                                  group=e.page_size)
        self.ring = llama.init_ring(c, e.max_decode_slots, e.flush_every,
                                    dtype, self.device)
        # load-metrics sink (the worker's WorkerMetricsPublisher): called
        # with metrics() from the loop thread at most every 0.1 s of busy
        # rounds and every 0.5 s while idle (the heartbeat). The snapshot
        # is built only at that cadence, so a round between publishes
        # pays one timestamp compare
        self.on_metrics = on_metrics
        self._last_metrics_pub = 0.0
        self.allocator = PageAllocator(
            e.num_pages, e.page_size,
            worker_id=e.worker_id,
            on_event=on_kv_event,
            enable_prefix_caching=e.enable_prefix_caching,
        )
        # KV integrity plane: one quarantine shared by every host tier (a
        # block that failed verification is dropped everywhere and refused
        # re-admission until its TTL lapses, so it is recomputed instead)
        self.kv_quarantine = KvQuarantine()
        # offload tiers (G2 host memory, G3 disk): parked pool pages are
        # candidates, gathered once a round and copied to the host on the
        # copy stream behind compute. A deque: on_park appends and the
        # round drains with popleft
        self.offload: Optional[HostOffloadTier] = None
        self._offload_cands: deque = deque()
        self._crc_pool: Optional[ThreadPoolExecutor] = None
        # offload puts run on their own thread (_put_batch), FIFO; the tier
        # lock serialises them with the loop's onboards and clears, and a
        # clear bumps the generation so queued batches are dropped
        self._put_pool: Optional[ThreadPoolExecutor] = None
        self._puts: deque = deque()
        self._tier_lock = threading.RLock()
        self._offload_gen = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        if e.host_offload_pages > 0:
            page_shape = (2, c.num_layers, c.num_kv_heads, e.page_size,
                          c.head_dim)
            # the tiers store what the pool stores: int8 pages and a
            # (k/v, layer) scale each under kv_quant
            tier_dtype = torch.int8 if self.kv_quant else dtype
            scale_shape = (2, c.num_layers) if self.kv_quant else ()
            spill = None
            if e.disk_offload_pages > 0:
                spill = DiskOffloadTier(
                    e.disk_offload_pages, page_shape, tier_dtype,
                    path=e.disk_offload_path, scale_shape=scale_shape,
                    quarantine=self.kv_quarantine,
                    scrub_on_start=e.scrub_on_start)
            self.offload = HostOffloadTier(
                e.host_offload_pages, page_shape, tier_dtype, spill=spill,
                scale_shape=scale_shape, quarantine=self.kv_quarantine,
                pin_memory=self.device.type == "cuda")
            # a batch's crcs (offload puts, onboard verifies) are computed
            # side by side: a page's crc32 is the tiers' largest host cost
            self._crc_pool = ThreadPoolExecutor(
                min(8, os.cpu_count() or 1), thread_name_prefix="kv-crc")
            for tier in (self.offload, spill):
                if tier is not None:
                    tier.crc_pool = self._crc_pool
            self._put_pool = ThreadPoolExecutor(
                1, thread_name_prefix="kv-offload-put")
            self.allocator.on_park = (
                lambda p, h, par: self._offload_cands.append((p, h, par)))
        # offload and onboard figures (transfer_stats): pages, bytes, host
        # seconds, and the copies' device-timed events
        self._xstats = {"offload_pages": 0, "offload_bytes": 0,
                        "offload_host_s": 0.0, "offload_copy_s": 0.0,
                        "onboard_pages": 0, "onboard_bytes": 0,
                        "onboard_host_s": 0.0, "onboard_copy_s": 0.0}
        self._h2d_events: deque = deque()
        B = e.max_decode_slots
        self._B = B
        self._slots: list[Optional[_Request]] = [None] * B
        # lanes reserved by an in-progress (multi-chunk) prefill: occupied
        # but not decoding until the admission patch
        self._prefilling: dict[int, _Request] = {}
        # slot-state mirrors: live (decoding) lanes, speculating lanes
        # (parked, verify-driven), lanes that need the full sampler
        # (temperature or penalties) rather than argmax, and lanes whose
        # request asked for logprobs
        self._slot_active = np.zeros(B, bool)
        self._slot_spec = np.zeros(B, bool)
        self._slot_sampler = np.zeros(B, bool)
        self._slot_lp = np.zeros(B, bool)
        # each slot's context length as of the last dispatch (metrics)
        self._ctx_disp = np.ones(B, np.int64)
        # (active slots, want_lp, want_sample), cached until the next slot
        # change
        self._active_cache: Optional[tuple[list[int], bool, bool]] = None
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        self._dev = {
            "tokens": torch.zeros(B, **i32),
            "ctx": torch.ones(B, **i32),
            # live slots write their own ctx lane; freed slots write the
            # scratch lane B (protects lanes being re-prefilled)
            "dest": torch.full((B,), B, **i32),
            "counts": torch.zeros(B, c.vocab_size, **i32),
            # threefry keys (uint32 words in int64), set at admission
            "keys": torch.zeros(B, 2, dtype=torch.int64, device=dev),
            "temp": torch.zeros(B, **f32),
            "top_k": torch.zeros(B, **i32),
            "top_p": torch.ones(B, **f32),
            "freq": torch.zeros(B, **f32),
            "pres": torch.zeros(B, **f32),
            "rep": torch.ones(B, **f32),
        }
        if self.n_adapters > 0:
            # each slot's adapter id, read by the round to gather its rows
            self._dev["adapter"] = torch.zeros(B, **i32)
        # fused-seal width: sized for a full aligned burst (every slot
        # completing blocks the same round); larger bursts flush standalone
        self._seal_fuse_w = pow2_cover(max(
            B, B * e.flush_every // max(e.page_size, 1), 1))
        # the round and patch programs on this state (CUDA graphs on the
        # card, every one captured here)
        self.graphs = graphs.DeviceGraphs(c, e, self.params, self.ctx,
                                          self.ring, self.cache, self._dev,
                                          self._seal_fuse_w)
        self.graphs.prepare()
        # speculative decoding (spec/): the proposer, the verifier and the
        # acceptance counters; eligible slots bypass the fused round
        self.spec: Optional[SpecDecoder] = None
        if e.speculative != "off":
            self.spec = SpecDecoder(c, e, device=self.device,
                                    draft_config=draft_config,
                                    draft_params=draft_params,
                                    rng_seed=rng_seed)

        # prefix-commit event plane (subscribe_commits): callbacks fired on
        # the engine thread when the committed prefix grew
        self._commit_lock = threading.Lock()
        self._commit_cbs: list[Callable[[], None]] = []
        # G4 remote tier (kv_transfer.RemoteKvFetcher, set by the
        # launcher's --remote-kv): fetched pages wait in _host_ingest for
        # the loop to put them into G2 ahead of admission
        self.remote_kv: Any = None
        self.remote_onboard_blocks = 0
        self._host_ingest: queue_mod.Queue = queue_mod.Queue()
        # fleet prefix economy: the frontend's replica and holder digest
        # (kv_router/fleet.py FleetHints), set by apply_fleet_hints and
        # read by dedup admission and tier eviction; None until the first
        # hint push arrives
        self.fleet_hints: Any = None
        self._intake: queue_mod.Queue = queue_mod.Queue()
        # page transfer ops (export/import/clear), serviced by the loop
        self._xfer: queue_mod.Queue = queue_mod.Queue()
        self._xfer_streams: list[_ExportStream] = []
        # the loop's doorbell: intake and transfer ops ring it
        self._wake_evt = threading.Event()
        self._waiting: list[_Request] = []
        # overload plane (overload/): bounded admission over the
        # not-yet-prefilling backlog. The token counters are updated from
        # the intake (the caller's loop) and the engine thread, under
        # _wt_lock; reads for budget checks are advisory. The admission
        # queue waits feed the Retry-After hint
        self.telemetry = tmetrics.request_histograms(
            tmetrics.TelemetryRegistry(), engine=True)
        self._h_ttft = self.telemetry.get(tmetrics.TTFT[0])
        self._h_itl = self.telemetry.get(tmetrics.ITL[0])
        self._h_e2e = self.telemetry.get(tmetrics.E2E[0])
        self._h_queue = self.telemetry.get(tmetrics.QUEUE[0])
        self._h_round = self.telemetry.get(tmetrics.ROUND[0])
        # histogram snapshots for metrics(), refreshed at most every
        # 0.25 s (metrics() runs at the publish cadence and on scrapes)
        self._hist_snap: tuple[float, dict] = (0.0, {})
        # the flight ring of recent dispatches (/debug/flight), the round
        # attribution (/debug/prof, folded into PROF), and worker-side
        # SLO-breach capture for requests no in-process frontend owns
        self.flight = FlightRecorder(e.flight_recorder_events)
        self.prof = RoundProf(enabled=e.prof_attribution)
        PROF.configure(e.slo_ttft_target_s, e.slo_itl_target_s,
                       e.slo_objective)
        self._forensics = ForensicsCapture(
            sample_rate=e.forensics_sample_rate,
            ttft_target_s=e.slo_ttft_target_s,
            itl_target_s=e.slo_itl_target_s,
            engines_fn=lambda: [self])
        self.admission = AdmissionController(
            e.max_waiting_requests, e.max_waiting_prefill_tokens,
            queue_wait_s=lambda: self._h_queue.percentile(0.5))
        self._waiting_tokens = 0
        self._wt_lock = threading.Lock()
        # tenancy plane (tenancy/): per-tenant slices of the budgets and
        # fair-share weights; the per-tenant counters ride the same
        # ``counted`` flag and lock as _waiting_tokens
        self.tenant_quotas = TenantQuotas(
            e.tenant_max_waiting_requests,
            e.tenant_max_waiting_prefill_tokens, weights=e.tenant_weights)
        self._tenant_waiting: dict[str, int] = {}
        self._tenant_tokens: dict[str, int] = {}
        self.waiting_preemptions = 0  # waiting entries evicted by priority
        self.preempt_migrations = 0   # running streams force-migrated
        self._entries: list[_Entry] = []
        # sealed blocks awaiting the ctx->pool copy: (slot, start, page)
        self._seal_queue: list[tuple[int, int, int]] = []
        self._to_release: list[_Request] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        # graceful drain (resilience/drain.py): admissions refused once
        # set; the loop sets the event once nothing is in flight
        self._draining = False
        self._drained_evt = threading.Event()
        self.step_count = 0
        # flash-decode kernel launches made by this engine's rounds: on
        # the card, the launches recorded in a round's graph at its
        # capture, once per replay
        self.kernel_launches = 0
        # intake: deadline sheds, and the fair-queuing virtual clocks
        # (global, advanced at service start, and per tenant)
        self.sheds = 0
        self._vclock = 0.0
        self._tenant_vnow: dict[str, float] = {}
        # round pipelining (pipeline_stats): early dispatches, the rounds
        # in flight summed right after each, host time of pipelined
        # rounds and its part spent after the early dispatch, and why the
        # pipeline fell back to the strict order, per flush point
        self._pipe_dispatches = 0
        self._pipe_depth_sum = 0
        self._pipe_hidden_s = 0.0
        self._pipe_host_s = 0.0
        self.pipe_flushes: dict[str, int] = {
            "drain": 0, "admission": 0, "release": 0, "seal_overflow": 0,
            "spec": 0}
        self.dispatch_counts: dict[str, int] = {
            "round": 0, "round_seal": 0, "seal": 0, "patch": 0,
            "prefill": 0, "prefill_batch": 0, "load_ctx": 0,
            "sample_first": 0, "fetch": 0, "offload_gather": 0,
            "xfer_gather": 0, "xfer_scatter": 0,
            # the batched draft and the verify programs (the per-slot
            # draft loop's are in spec.stats()["spec_draft_dispatch_total"])
            "spec_draft": 0, "spec_verify": 0,
        }

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a stream sync:
        PyTorch's blocking host->device copy waits for every queued
        program, so it is staged in pinned memory and copied
        non-blocking (the caching host allocator keeps the staging
        buffer until the copy has run)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    # lifecycle

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._thread = threading.Thread(
            target=self._run_loop, name="torch-engine-loop", daemon=True)
        self._thread.start()

    async def stop(self) -> None:
        self._stop.set()
        self._wake_evt.set()
        if self._thread:
            await asyncio.to_thread(self._thread.join, 30.0)
        # transfer ops that raced in after the loop's own exit drain
        self._drain_xfer_queue()
        if self._put_pool is not None:
            # the puts still queued land before G3 closes
            await asyncio.to_thread(self._put_pool.shutdown)
            self._reap_puts()
        if self.offload is not None and self.offload.spill is not None:
            self.offload.spill.close()
        if self._crc_pool is not None:
            self._crc_pool.shutdown()

    # ---- graceful drain (resilience/drain.py DrainController contract) --

    def begin_drain(self) -> None:
        """Stop admitting: later generate() calls raise the retriable
        WorkerDrainingError; requests already accepted run to completion."""
        self._draining = True
        self._wake_evt.set()
        if not self._started:
            # the loop never ran: nothing can be in flight
            self._drained_evt.set()

    def drained(self) -> bool:
        return self._drained_evt.is_set()

    # ------------------------------------------------------------------
    # tenancy plane: resident adapters

    def install_adapter(self, adapter_id: int, weights: dict) -> None:
        """Install one fine-tune variant's LoRA factors into the resident
        bank (site -> {"a": [L, d_in, r], "b": [L, r, d_out]}), in place:
        the captured graphs read the new rows from their next replay."""
        bank = self.params.get("adapters")
        if bank is None:
            raise ValueError(
                "engine has no adapter bank (EngineConfig.lora_adapters=0)")
        set_adapter(bank, adapter_id, weights)

    # ------------------------------------------------------------------
    # AsyncEngine surface

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[LLMEngineOutput]:
        """Stream engine outputs (token-id deltas) for one request."""
        if self._draining:
            raise WorkerDrainingError(
                "worker draining: not admitting new requests")
        if len(request.token_ids) == 0:
            raise ValueError("empty prompt")
        if len(request.token_ids) >= self.ecfg.max_context:
            raise ValueError(
                f"prompt length {len(request.token_ids)} exceeds max context "
                f"{self.ecfg.max_context}")
        # ids from a client index the embedding table: one past its end
        # would fault the device, so it is refused here
        if not all(0 <= t < self.config.vocab_size for t in request.token_ids):
            raise ValueError(
                f"prompt token ids must be in [0, {self.config.vocab_size})")
        n_lp = request.output_options.logprobs
        if n_lp is not None and n_lp < 0:
            raise ValueError(f"logprobs must be >= 0, got {n_lp}")
        if request.multimodal or request.disagg:
            raise ValueError(
                "multimodal inputs and disaggregated prefill are not "
                "supported by the PyTorch engine yet")
        tenant = request.tenant or "default"
        adapter_id = int(request.adapter_id or 0)
        if adapter_id and not 0 < adapter_id < max(1, self.n_adapters):
            raise ValueError(
                f"adapter_id {adapter_id} out of range: engine bank has "
                f"{self.n_adapters} adapter slots")
        if request.deadline is not None and _wall_time() > request.deadline:
            # the deadline passed before intake: shed with zero tokens and
            # the DEADLINE finish, never an error (the client's budget ran
            # out, nothing failed)
            self.sheds += 1
            OVERLOAD.inc("dynamo_overload_shed_total")
            yield LLMEngineOutput(
                token_ids=[], finish_reason=FinishReason.DEADLINE,
                annotations={"shed": {"reason": "deadline",
                                      "queued_s": 0.0}})
            return
        # bounded admission: a full waiting queue refuses intake with the
        # retriable overload error (a router spills to a peer, the
        # frontend answers 429 + Retry-After). A HIGH-priority arrival is
        # admitted anyway: the loop restores the budget by evicting the
        # lowest-priority waiting entry (_enforce_bounds)
        if self.admission.bounded:
            waiting = (sum(1 for w in self._waiting if w.slot < 0)
                       + self._intake.qsize())
            with self._wt_lock:
                tokens = self._waiting_tokens
            try:
                self.admission.check(waiting, tokens)
            except EngineOverloadedError:
                if request.priority < PRIORITY_HIGH:
                    OVERLOAD.inc("dynamo_overload_rejected_total")
                    TENANT.inc("dynamo_tenant_rejected_total", tenant)
                    raise
        # the tenant's own slice: one tenant's storm exhausts its budget
        # (429 + a Retry-After from that tenant's own queue waits) before
        # it can crowd the global queue; HIGH priority is force-admitted
        # here too and paid for within the tenant
        if self.tenant_quotas.bounded:
            with self._wt_lock:
                t_waiting = self._tenant_waiting.get(tenant, 0)
                t_tokens = self._tenant_tokens.get(tenant, 0)
            try:
                self.tenant_quotas.check(tenant, t_waiting, t_tokens)
            except EngineOverloadedError:
                if request.priority < PRIORITY_HIGH:
                    OVERLOAD.inc("dynamo_overload_rejected_total")
                    TENANT.inc("dynamo_tenant_rejected_total", tenant)
                    raise
        TENANT.inc("dynamo_tenant_admitted_total", tenant)
        if not self._started:
            self.start()
        r = _Request(
            req=request,
            seq=TokenBlockSequence.from_tokens(
                request.token_ids, self.ecfg.page_size, salt=request.model),
            out=asyncio.Queue(),
            loop=asyncio.get_running_loop(),
            tokens=list(request.token_ids),
            tenant=tenant,
            trace_detail="trace_detail" in (request.annotations or []),
        )
        if self.remote_kv is not None and self.offload is not None:
            await self._remote_prefetch(r)
        r.counted = True
        with self._wt_lock:
            self._waiting_tokens += len(r.tokens)
            self._tenant_waiting[tenant] = (
                self._tenant_waiting.get(tenant, 0) + 1)
            self._tenant_tokens[tenant] = (
                self._tenant_tokens.get(tenant, 0) + len(r.tokens))
        self._intake.put(r)
        self._wake_evt.set()
        try:
            while True:
                item = await r.out.get()
                if isinstance(item, Exception):
                    raise item
                yield item
                if item.finished:
                    return
        finally:
            r.cancelled = True

    # ------------------------------------------------------------------
    # engine loop

    def _run_loop(self) -> None:
        last_idle_beat = 0.0
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    did_work = self._round()
                except Exception as exc:  # noqa: BLE001 — loop must survive
                    log.exception("engine round failed")
                    # the last dispatches before the failure: the
                    # postmortem the log alone never has
                    self.flight.dump(log, reason=repr(exc))
                    self._fail_all(RuntimeError("engine step failed; see logs"))
                    did_work = False
                if not did_work:
                    # idle heartbeat: busy rounds publish metrics
                    # themselves; an idle engine keeps beating so that
                    # silence on the metrics plane means wedged
                    now = time.monotonic()
                    if (self.on_metrics is not None
                            and now - last_idle_beat >= 0.5):
                        last_idle_beat = now
                        try:
                            self.on_metrics(self.metrics())
                        except Exception:  # noqa: BLE001 — never kill the loop
                            log.exception("idle metrics publish failed")
                    self._wake_evt.wait(timeout=0.02)
                    self._wake_evt.clear()
        self._drain_xfer_queue()

    def _round(self) -> bool:
        """One scheduling round. With ``round_pipeline`` and the pipeline
        clear (``_pipeline_clear``), the next decode round is dispatched
        FIRST, before this round's ready results are processed, so the
        processing below runs while the device executes. Otherwise (or
        with pipelining off) the strict order: process ready results,
        apply releases, admit (prefill), dispatch a decode round for the
        live slots. Seals queued by result processing ride the next
        round; they are flushed standalone only when nothing was
        dispatched, pipelining is off, or the queue outgrew the fused
        width."""
        e = self.ecfg
        prof = self.prof
        prof.begin_round()
        t_round = time.monotonic()
        prof.enter(_SEG_INTAKE)
        self._drain_intake()
        prof.enter(_SEG_SLOT_SCAN)
        self._enforce_bounds()
        in_flight = self._rounds_in_flight()
        dispatched = False
        t_pipe = 0.0
        if (e.round_pipeline and in_flight <= e.max_inflight_rounds
                and self._pipeline_clear()):
            active, want_lp, want_sample = self._active_slots()
            if active:
                prof.enter(_SEG_DISPATCH)
                self._dispatch_round(want_sample, want_lp)
                dispatched = True
                in_flight += 1
                self._pipe_dispatches += 1
                self._pipe_depth_sum += in_flight
                t_pipe = time.monotonic()
        prof.enter(_SEG_FETCH)
        self._process_entries(block=in_flight > e.max_inflight_rounds)
        # the reference puts landed offload pages into G2 while consuming
        # their fetch, so reaping the put thread's results is fetch time
        self._reap_puts()
        prof.enter(_SEG_RELEASES)
        self._apply_releases()
        # the reference's order: transfers, export streams, offloads (pool
        # readers, each flushing queued seals first), then admission
        prof.enter(_SEG_TRANSFER)
        xfer_work = self._process_transfers()
        stream_work = self._service_export_streams()
        prof.enter(_SEG_OFFLOAD)
        self._dispatch_offloads()
        self._drain_host_ingest()  # G4 pages land before admission
        prof.enter(_SEG_ADMIT)
        self._admit()
        prof.enter(_SEG_SLOT_SCAN)
        did_work = (dispatched or bool(self._entries) or xfer_work
                    or stream_work or bool(self._prefilling))
        if (not dispatched
                and self._rounds_in_flight() <= e.max_inflight_rounds):
            # the strict position: after every patch above
            active, want_lp, want_sample = self._active_slots()
            if active:
                prof.enter(_SEG_DISPATCH)
                self._dispatch_round(want_sample, want_lp)
                did_work = dispatched = True
        if self.spec is not None and self._slot_spec.any():
            prof.enter(_SEG_SPEC)
            if self._dispatch_spec():
                did_work = dispatched = True
        if self._seal_queue and (
                not e.round_pipeline or not dispatched
                or len(self._seal_queue) > self._seal_fuse_w):
            prof.enter(_SEG_SEAL_FLUSH)
            self._flush_seals()
            did_work = True
        if t_pipe:
            # host time after the early dispatch ran with it in flight
            now = time.monotonic()
            self._pipe_hidden_s += now - t_pipe
            self._pipe_host_s += now - t_round
        # fold the attribution and refresh the SLO burn rates at the
        # publish cadence, not once a round
        now = time.monotonic()
        if now - self._last_metrics_pub >= 0.1:
            self._last_metrics_pub = now
            prof.enter(_SEG_METRICS)
            PROF.fold(prof)
            PROF.fold_burn_rates(
                self._h_ttft.snapshot(), self._h_itl.snapshot(),
                e.slo_ttft_target_s, e.slo_itl_target_s, e.slo_objective)
            if self.on_metrics is not None:
                self.on_metrics(self.metrics())
        if (not dispatched and self._entries
                and self._intake.empty() and not self._waiting):
            # nothing to overlap with the in-flight copies: block on the
            # head entry instead of spinning
            prof.enter(_SEG_FETCH)
            self._process_entries(block=True)
        if not did_work:
            # waiting on an export stream's copy is fetch time too
            prof.enter(_SEG_FETCH)
            if self._wait_stream_copy():
                did_work = True
        if (self._draining
                and not self._entries and not self._waiting
                and not self._prefilling and self._intake.empty()
                and all(r is None for r in self._slots)):
            self._drained_evt.set()
        prof.end_round(record=did_work)
        return did_work

    def _rounds_in_flight(self) -> int:
        return sum(1 for en in self._entries if en.kind == "round")

    def _pipeline_clear(self) -> bool:
        """True when the next round may be dispatched before this round's
        results are processed: nothing pending may patch slot state under
        the in-flight rounds. Each False counts its flush point in
        ``pipe_flushes``: a drain (no round may be left in flight when
        the worker exits), an admission (waiting, mid-prefill or fresh
        intake), a pending release, a seal queue past the fused width, or
        a speculating slot."""
        if self._draining:
            self.pipe_flushes["drain"] += 1
            return False
        if self._waiting or self._prefilling or not self._intake.empty():
            self.pipe_flushes["admission"] += 1
            return False
        if self._to_release:
            self.pipe_flushes["release"] += 1
            return False
        if len(self._seal_queue) > self._seal_fuse_w:
            self.pipe_flushes["seal_overflow"] += 1
            return False
        if self.spec is not None and self._slot_spec.any():
            # verify results re-shape the next round
            self.pipe_flushes["spec"] += 1
            return False
        return True

    def _active_slots(self) -> tuple[list[int], bool, bool]:
        """(live slots, want_lp, want_sample) from the slot-state mirrors,
        cached until the next slot change."""
        if self._active_cache is None:
            idx = np.flatnonzero(self._slot_active)
            self._active_cache = (idx.tolist(),
                                  bool(self._slot_lp[idx].any()),
                                  bool(self._slot_sampler[idx].any()))
        return self._active_cache

    def pipeline_stats(self) -> dict:
        """Round-pipelining counters (the reference's keys): the mean
        rounds in flight right after an early dispatch, the share of a
        pipelined round's host time spent after its early dispatch (while
        the device runs it), and the fallbacks to the strict order by
        flush point."""
        n = self._pipe_dispatches
        return {
            "round_pipeline": bool(self.ecfg.round_pipeline),
            "pipelined_dispatches": n,
            "pipeline_depth": round(self._pipe_depth_sum / n, 4) if n else 0.0,
            "overlap_ratio": (
                round(self._pipe_hidden_s / self._pipe_host_s, 4)
                if self._pipe_host_s > 0 else 0.0),
            "pipe_flushes": dict(self.pipe_flushes),
        }

    def _drain_intake(self) -> None:
        while True:
            try:
                self._enqueue_waiting(self._intake.get_nowait())
            except queue_mod.Empty:
                return

    def _enqueue_waiting(self, r: _Request) -> None:
        """Weighted start-time fair queuing within a priority class; a
        high-priority arrival queues ahead of every lower-priority entry
        that has NOT started prefill (an entry holding a lane is active
        work, never jumped). Each request is stamped with a virtual
        finish time, its tenant's virtual clock advanced by its prompt
        length over the tenant's weight (``tenant_weights``, default 1),
        and goes before the first not-started same-priority entry with a
        LARGER stamp. A tenant's fresh arrival starts at the global
        virtual clock (advanced at service start, ``_prefill_begin``), so
        a storming tenant's backlog cannot hold it back; one tenant's
        stamps only grow, so its traffic stays FIFO."""
        t = r.tenant
        vstart = max(self._tenant_vnow.get(t, 0.0), self._vclock)
        r.vft = vstart + max(1, len(r.tokens)) / self.tenant_quotas.weight(t)
        self._tenant_vnow[t] = r.vft
        for i, w in enumerate(self._waiting):
            if w.prefill_pos >= 0:
                continue
            if r.req.priority > 0:
                jump = w.req.priority < r.req.priority
            else:
                jump = w.req.priority == r.req.priority and w.vft > r.vft
            if jump:
                self._waiting.insert(i, r)
                return
        self._waiting.append(r)

    def _slot_on(self, slot: int, r: _Request) -> None:
        """A slot becomes live. It needs the sampler if it samples OR
        carries penalties (the counts histogram must advance for them)."""
        so = r.req.sampling_options
        self._slot_active[slot] = True
        self._slot_spec[slot] = False
        self._slot_lp[slot] = r.req.output_options.logprobs is not None
        self._slot_sampler[slot] = (
            (so.temperature or 0.0) > 0.0
            or (so.frequency_penalty or 0.0) != 0.0
            or (so.presence_penalty or 0.0) != 0.0
            or (so.repetition_penalty or 1.0) != 1.0
        )
        self._active_cache = None

    def _slot_off(self, slot: int, spec: bool = False) -> None:
        """A slot leaves the fused round: finish, release, or with
        ``spec`` speculative admission (its lane stays parked)."""
        self._slot_active[slot] = False
        self._slot_spec[slot] = spec
        self._slot_sampler[slot] = False
        self._slot_lp[slot] = False
        self._active_cache = None

    # ---- dispatch side ----

    def _dispatch_round(self, want_sample: bool, want_lp: bool) -> None:
        """One round (``flush_every`` decode+sample steps, the ring->ctx
        flush and the pending seal batch: a graph replay on the card),
        then one stacked-token copy to the host (plus one packed-logprob
        copy when ``want_lp``), queued right behind it."""
        e = self.ecfg
        n = e.flush_every
        n_seal = min(len(self._seal_queue), self._seal_fuse_w)
        prev_seg = self.prof.push(_SEG_SEAL_ASM)
        seal = self._take_seal_batch(width=self._seal_fuse_w)
        self.prof.enter(prev_seg)
        t_disp = time.monotonic()
        self.kernel_launches += self.graphs.round(want_sample, want_lp, seal)
        self.dispatch_counts["round" if seal is None else "round_seal"] += 1
        if seal is not None:
            self._notify_commits()
        self.step_count += n
        active = self._slot_active
        self._ctx_disp[active] = np.minimum(self._ctx_disp[active] + n,
                                            e.max_context)
        if self.n_adapters:
            # which tenants' rounds gathered a variant's rows (inside the
            # same replay: no extra dispatch)
            seen: set[str] = set()
            for i in np.flatnonzero(active):
                r = self._slots[i]
                if r is not None and r.adapter_id and r.tenant not in seen:
                    seen.add(r.tenant)
                    TENANT.inc("dynamo_tenant_adapter_rounds_total",
                               r.tenant)
        self._count_kv_quant(n_seal)
        if self.kv_quant:
            # the ring flush requantized a window of scale groups a lane
            g = max(1, e.page_size)
            KV_QUANT.inc("dynamo_kv_quant_ctx_flush_groups_total",
                         self._B * min(-(-n // g) + 1, -(-e.max_context // g)))
        self.dispatch_counts["fetch"] += 1 + want_lp
        out = self.graphs.out
        self._entries.append(_Entry(
            kind="round", fetch=_Fetch(out["toks"]),
            lp_fetch=_Fetch(out["lp"]) if want_lp else None,
            # the snapshot leaves speculating slots out: their parked
            # lanes' columns are garbage (the filter must be made at
            # dispatch: a slot's spec flag may flip before processing)
            slots=[r if r is None or not r.spec else None
                   for r in self._slots],
            n_steps=n, t_dispatch=t_disp,
        ))
        self.flight.record(
            "round", slots=self._active_slots()[0], n_steps=n,
            # seals ride the round (seal_w: the batch's real width) and
            # its tokens come back in one copy, plus one for logprobs
            seal_w=n_seal if seal is not None else 0,
            fetches=1 + want_lp,
            spec_slots=np.flatnonzero(self._slot_spec).tolist(),
            dispatch_ms=round((time.monotonic() - t_disp) * 1e3, 3))

    def _dispatch_patch(
        self,
        clear_slots: list[int] = (),
        admit: Optional[dict[str, Any]] = None,
    ) -> None:
        """State patch (releases and one admission): one fixed-shape
        program on the device state (``graphs.run_patch``)."""
        self.dispatch_counts["patch"] += 1
        self.graphs.patch(graphs.pack_patch(self._B, clear_slots, admit),
                          admit["tok"] if admit is not None else None)

    # ---- speculative decoding (spec/): propose -> verify ----

    def _spec_rows(self, width: int
                   ) -> tuple[list[tuple[int, _Request, int]], bool]:
        """The spec-ready slots as (slot, request, history length) rows.
        A verify writes up to ``width`` rows at [N-1, N-1+width) (the
        chain's K_cap+1, a tree's budget): a slot where that no longer
        fits the region gets its last tokens from the fused round,
        checked before anything is packed (the round's width is not known
        yet, and the dense commit would clamp its start). Returns (rows,
        whether a slot was de-speculated)."""
        rows: list[tuple[int, _Request, int]] = []
        despec = False
        for slot, r in enumerate(self._slots):
            if (r is None or not r.spec or not r.spec_ready or r.finished
                    or r.cancelled or r.spec_inflight):
                continue
            n_hist = len(r.spec_tokens)
            if (n_hist - 1) + width > self.ecfg.max_context:
                self._despeculate(slot, r)
                despec = True
                continue
            rows.append((slot, r, n_hist))
        return rows, despec

    def _spec_knobs(self, rows: list[tuple[int, _Request, int]]):
        """Device tensors of the rows' keys, temperatures, top-k and
        top-p, and their penalties: None when no row carries any (the
        [n, V] counts upload and the row-by-row accept cost nothing on
        other rounds), else (counts [n, V], freq, pres, rep [n])."""
        n = len(rows)
        keys = np.zeros((n, 2), np.int64)
        temps = np.zeros(n, np.float32)
        top_ks = np.zeros(n, np.int32)
        top_ps = np.ones(n, np.float32)
        pen = None
        if any(r.spec_counts is not None for _, r, _ in rows):
            pen = (np.zeros((n, self.config.vocab_size), np.int32),
                   np.zeros(n, np.float32), np.zeros(n, np.float32),
                   np.ones(n, np.float32))
        for j, (_, r, _) in enumerate(rows):
            keys[j] = r.spec_keys
            kn = _sampling_knobs(r.req.sampling_options)
            temps[j], top_ks[j], top_ps[j] = kn["temp"], kn["top_k"], \
                kn["top_p"]
            if pen is not None and r.spec_counts is not None:
                pen[0][j] = r.spec_counts
                pen[1][j], pen[2][j], pen[3][j] = kn["freq"], kn["pres"], \
                    kn["rep"]
        dev = self._to_device
        return ((dev(keys), dev(temps), dev(top_ks), dev(top_ps)),
                None if pen is None else tuple(dev(a) for a in pen))

    def _dispatch_spec(self) -> bool:
        """Collect the spec-ready slots, draft K tokens for all of them
        (one batched draft program, or the host n-gram lookup), and
        dispatch one score + accept program over them. The verify writes
        K+1 KV rows a slot optimistically; the host commits only the
        accepted prefix (rollback is pointer truncation). K is the ROUND
        width: the bucketed max of the participants' effective K. Returns
        True if anything was dispatched."""
        if self.spec.tree:
            return self._dispatch_spec_tree()
        e = self.ecfg
        rows, despec = self._spec_rows(self.spec.k + 1)
        if not rows:
            return despec
        K = self.spec.round_k([self.spec.k_for(slot) for slot, _, _ in rows])
        toks = np.zeros((len(rows), K + 1), np.int32)
        slots = [slot for slot, _, _ in rows]
        q_starts = [n_hist - 1 for _, _, n_hist in rows]
        seq_lens = [n_hist + K for _, _, n_hist in rows]
        for j, (_, r, _) in enumerate(rows):
            toks[j, 0] = r.spec_tokens[-1]    # the pending token
        knobs, pen = self._spec_knobs(rows)
        t_disp = time.monotonic()
        drafted = None
        if self.spec.draft is not None and e.spec_batch_draft:
            # one batched draft; its [n, K] device result is spliced into
            # the verify's tokens on the device
            self.dispatch_counts["spec_draft"] += 1
            drafted = self.spec.propose_batch(
                [(slot, r.spec_tokens) for slot, r, _ in rows], K)
        else:
            parts = []
            for j, (slot, r, _) in enumerate(rows):
                proposal = self.spec.propose(slot, r.spec_tokens, K)
                if isinstance(proposal, list):    # n-gram: host tokens
                    toks[j, 1:] = proposal
                else:                             # per-slot draft
                    parts.append(proposal)
            if parts:
                drafted = torch.stack(parts)
        t_draft_end = time.monotonic()
        self.dispatch_counts["spec_verify"] += 1
        packed = self.spec.verify(
            self.params, self.ctx, self._to_device(toks), drafted, slots,
            q_starts, seq_lens, *knobs, penalties=pen)
        fetch = _Fetch(packed)
        t_verify_end = time.monotonic()
        self.flight.record(
            "spec_verify", slots=slots, k=K, fetches=1,
            dispatch_ms=round((t_verify_end - t_disp) * 1e3, 3))
        self._queue_spec_verify(rows, _Entry(
            kind="spec", fetch=fetch, rows=rows, n_steps=K,
            t_dispatch=t_disp,
            spec_host=(t_draft_end - t_disp, t_verify_end - t_draft_end)))
        return True

    def _queue_spec_verify(self, rows, entry: _Entry) -> None:
        """A verify was dispatched: its rows wait for ``entry``'s fetch."""
        self.dispatch_counts["fetch"] += 1
        for _, r, _ in rows:
            r.spec_ready = False
            r.spec_inflight = True
        self._entries.append(entry)

    def _dispatch_spec_tree(self) -> bool:
        """A tree-speculation round: at most one draft program and one
        verify, as the linear round, and one packed [n, 2D+4] fetch
        (tokens | accepted path | n_out | keys; verifier.spec_verify_tree).

        Each row packs a token tree (flat tokens and parent pointers,
        node 0 the pending token): the n-gram proposer's trie of its
        top-M continuations, built on the host, or the draft model's comb
        (M candidates a depth off a greedy spine) from one batched draft.
        The verify scores every node under the ancestor mask, walks the
        deepest surviving path on the device and commits only that
        path's KV rows. The round's depth D and fan M are the bucketed
        max of the slots' adaptive (k, m). Returns True if anything was
        dispatched."""
        T_cap = self.spec.tree_budget
        rows, despec = self._spec_rows(T_cap)
        if not rows:
            return despec
        K = self.spec.round_k([self.spec.k_for(slot) for slot, _, _ in rows])
        M = self.spec.round_m([self.spec.m_for(slot) for slot, _, _ in rows])
        draft_mode = self.spec.draft is not None
        # a comb packs exactly 1 + K*M nodes (the device draft is spliced
        # in whole), so M halves to fit the budget; a trie takes the whole
        # budget, so every trie has one verify shape
        while draft_mode and 1 + K * M > T_cap and M > 1:
            M //= 2
        T = 1 + K * M if draft_mode else T_cap
        n = len(rows)
        toks = np.zeros((n, T), np.int32)
        parents = np.full((n, T), -2, np.int32)   # -2: padding
        parents[:, 0] = -1                        # node 0: the root
        nodes_used = np.zeros(n, np.int32)
        slots = [slot for slot, _, _ in rows]
        q_starts = [n_hist - 1 for _, _, n_hist in rows]
        seq_lens = [n_hist - 1 + T for _, _, n_hist in rows]
        for j, (_, r, _) in enumerate(rows):
            toks[j, 0] = r.spec_tokens[-1]    # the pending token
        knobs, pen = self._spec_knobs(rows)
        t_disp = time.monotonic()
        drafted = None
        if draft_mode:
            # a comb is one batched draft's output (spine + top-M a level);
            # its [n, K*M] device result is spliced in on the device
            parents[:] = comb_parents(K, M)
            nodes_used[:] = T - 1
            self.dispatch_counts["spec_draft"] += 1
            drafted = self.spec.propose_batch_tree(
                [(slot, r.spec_tokens) for slot, r, _ in rows], K, M)
        else:
            for j, (slot, r, _) in enumerate(rows):
                tks, prs = self.spec.propose_tree(r.spec_tokens, K, M)
                m = min(len(tks), T - 1)
                toks[j, 1:1 + m] = tks[:m]
                parents[j, 1:1 + m] = prs[:m]
                nodes_used[j] = m
        t_draft_end = time.monotonic()
        self.dispatch_counts["spec_verify"] += 1
        packed = self.spec.verify_tree(
            self.params, self.ctx, self._to_device(toks), drafted,
            self._to_device(parents), slots, q_starts, seq_lens, *knobs, K,
            penalties=pen)
        fetch = _Fetch(packed)
        t_verify_end = time.monotonic()
        self.flight.record(
            "spec_verify_tree", slots=slots, k=K, m=M, nodes=T - 1,
            fetches=1,
            dispatch_ms=round((t_verify_end - t_disp) * 1e3, 3))
        self._queue_spec_verify(rows, _Entry(
            kind="spec_tree", fetch=fetch, rows=rows, n_steps=K,
            tree=(M, parents, nodes_used), t_dispatch=t_disp,
            spec_host=(t_draft_end - t_disp, t_verify_end - t_draft_end)))
        return True

    def _despeculate(self, slot: int, r: _Request,
                     gated: bool = False) -> None:
        """Hand a speculating slot back to the fused round: an admission
        patch restores the device state the fused path would carry
        (pending token, context length, keys, knobs) and the penalty
        counts are copied after it, so the continuation is what a fused
        run gives. ``gated`` marks an acceptance-gate despec: the stream
        keeps mirroring its sequence on the fused round and re-arms after
        ``spec_rearm_tokens`` fused tokens, a budget that doubles at each
        re-gate."""
        r.spec = False
        r.spec_ready = False
        if gated:
            r.spec_gated = True
            r.spec_rearm_left = (self.ecfg.spec_rearm_tokens
                                 * r.spec_gate_backoff)
            r.spec_gate_backoff *= 2
            SPEC.inc("dynamo_spec_tree_gated_despecs_total")
            self.spec.on_gated_despec(slot)
        else:
            self.spec.on_despec(slot)
        self._slot_on(slot, r)
        ctx = len(r.spec_tokens)
        self._ctx_disp[slot] = ctx
        self._dispatch_patch(admit=dict(
            slot=slot, ctx=ctx,
            tok=self._to_device(np.asarray([r.spec_tokens[-1]], np.int32)),
            keys=[int(k) for k in r.spec_keys],
            **_sampling_knobs(r.req.sampling_options)))
        if r.spec_counts is not None:
            # the patch zeroed the lane's counts: the fused continuation
            # must see the histogram the verifies advanced
            self._dev["counts"][slot].copy_(
                self._to_device(r.spec_counts.astype(np.int32)))

    def _process_spec(self, entry: _Entry, packed: np.ndarray) -> None:
        """Consume one verify result: emit each row's accepted prefix and
        bonus, advance the host history and keys, roll the draft KV back
        to the accepted length. Every verified token is emitted;
        acceptance is counted at the round's width, and the adaptive
        rate, the gate and the despec decision act on the next round."""
        K = entry.n_steps
        for j, (slot, r, hist_len) in enumerate(entry.rows):
            if not self._spec_live(slot, r):
                continue
            n = int(packed[j, K + 1])
            accepted = n - 1
            self.spec.on_result(slot, hist_len, accepted, K)
            r.spec_proposed += K
            r.spec_accepted += accepted
            self._land_spec(slot, r, [int(t) for t in packed[j, :n]],
                            packed[j, K + 2:K + 4], entry)

    def _process_spec_tree(self, entry: _Entry, packed: np.ndarray) -> None:
        """Consume one tree verify's packed [n, 2D+4] result: per row the
        accepted path's tokens and the bonus (cols [0, D]), the accepted
        node indices (cols [D+1, 2D]), n_out (col 2D+1) and the advanced
        key (cols 2D+2, 2D+3). Emission is the linear path's; on top, the
        branch histogram and the draft spine's rollback
        (SpecDecoder.on_result_tree) and the tree counters of the SPEC
        registry. Acceptance is counted in tokens a depth, comparable to
        the chain's at the same K."""
        D = entry.n_steps
        M, parents, nodes_used = entry.tree
        for j, (slot, r, hist_len) in enumerate(entry.rows):
            if not self._spec_live(slot, r):
                continue
            n = int(packed[j, 2 * D + 1])
            accepted = n - 1
            self.spec.on_result_tree(
                slot, hist_len, accepted, D, M, int(nodes_used[j]),
                [int(x) for x in packed[j, D + 1:D + 1 + accepted]],
                [int(x) for x in parents[j]])
            SPEC.inc("dynamo_spec_tree_nodes_total", int(nodes_used[j]))
            SPEC.inc("dynamo_spec_tree_accepted_path_len_total", accepted)
            r.spec_proposed += D
            r.spec_accepted += accepted
            self._land_spec(slot, r, [int(t) for t in packed[j, :n]],
                            packed[j, 2 * D + 2:2 * D + 4], entry)

    def _spec_live(self, slot: int, r: _Request) -> bool:
        """A verify row's result landed: is its request still the slot's
        and running? (A cancelled one finishes here.)"""
        r.spec_inflight = False
        if r.finished or self._slots[slot] is not r:
            return False
        if r.cancelled:
            self._finish(r, None)
            return False
        return True

    def _land_spec(self, slot: int, r: _Request, toks: list[int],
                   keys: np.ndarray, entry: _Entry) -> None:
        """Emit a verify row's tokens (the accepted ones and the bonus),
        advance the host history, counts and keys, then apply the gate
        and the despec decision, or ready the slot for the next round."""
        batch: list[int] = []
        finish: Optional[FinishReason] = None
        for tok in toks:
            finish = self._advance_token(r, tok)
            if finish is FinishReason.EOS:
                break  # the stop token itself is not emitted
            batch.append(tok)
            if finish is not None:
                break
        if batch:
            self._note_emit(r, len(batch), entry, "spec_verify_round")
        if batch or finish is not None:
            extra = ({"annotations": self._final_annotations(r)}
                     if finish is not None else {})
            r.emit(LLMEngineOutput(token_ids=batch, finish_reason=finish,
                                   **extra))
        if finish is not None:
            self._finish(r, None)
            return
        if r.spec_counts is not None:
            # every emitted token counts, as the fused sampler's
            # per-token advance does
            for t in toks:
                r.spec_counts[t] += 1
        r.spec_tokens.extend(toks)
        r.spec_keys = keys.copy()
        if self.spec.should_gate(slot):
            self._despeculate(slot, r, gated=True)
        elif self.spec.should_despec(slot):
            # acceptance collapsed: a verify costs a full forward for
            # about one token, worse than the fused round
            self._despeculate(slot, r)
        else:
            r.spec_ready = True
            self._ctx_disp[slot] = len(r.spec_tokens)

    def _spec_gated_advance(self, slot: int, r: _Request,
                            batch: list[int]) -> None:
        """Fused-round bookkeeping of a gated (or re-arming) stream: the
        host sequence and counts stay current, so speculation resumes
        where the fused round leaves off."""
        if batch:
            r.spec_tokens.extend(batch)
            if r.spec_counts is not None:
                for t in batch:
                    r.spec_counts[t] += 1
        if r.spec_rearm_wait > 0:
            # the re-arm drain: one more in-flight round that stepped this
            # lane is consumed; after the last, the clear patch has run in
            # stream order and the first verify may go
            r.spec_rearm_wait -= 1
            if r.spec_rearm_wait == 0:
                r.spec_ready = True
            return
        if self.ecfg.spec_rearm_tokens <= 0:
            return  # the gate is permanent
        r.spec_rearm_left -= len(batch)
        if r.spec_rearm_left <= 0:
            self._rearm_spec(slot, r)

    def _rearm_spec(self, slot: int, r: _Request) -> None:
        """Re-arm speculation on a gated stream: back to spec mode with
        the lane parked by a clear patch. Rounds already dispatched keep
        stepping the lane until that patch runs, so the first verify
        waits until every in-flight round whose snapshot holds the lane
        was consumed (their tokens are real; _spec_gated_advance mirrors
        them). The device key advanced privately on the fused round: the
        host reseeds from the stale key and the produced count, as the
        JAX version does (greedy streams never read it)."""
        r.spec = True
        r.spec_gated = False
        r.spec_ready = False
        self.spec.on_rearm(slot)
        self._slot_off(slot, spec=True)
        self._dispatch_patch(clear_slots=[slot])
        self._ctx_disp[slot] = len(r.spec_tokens)
        stale = [int(k) for k in r.spec_keys]
        fold = (r.produced * 2654435761 + 0x9E3779B9) & 0xFFFFFFFF
        r.spec_keys = np.asarray([stale[0] ^ fold, stale[1] ^ (fold >> 1)],
                                 np.int64)
        r.spec_rearm_wait = sum(
            1 for en in self._entries
            if en.kind == "round" and en.slots[slot] is r)
        if r.spec_rearm_wait == 0:
            r.spec_ready = True

    def _spec_annotations(self, r: _Request) -> dict:
        """A request's speculation counters on its finishing output."""
        if r.spec_proposed <= 0:
            return {}
        return {"spec": {
            "proposed": r.spec_proposed,
            "accepted": r.spec_accepted,
            "acceptance_rate": r.spec_accepted / r.spec_proposed,
        }}

    # ---- block sealing (ctx -> pool prefix-cache copies) ----

    def _queue_seal(self, r: _Request, position: int,
                    block_hash: int, parent_hash: int) -> None:
        """Copy-commit one sealed block into the prefix cache. Best-effort:
        a full pool skips the commit — the prefix cache is a cache."""
        got = self.allocator.allocate(1)
        if got is None:
            return
        page = got[0]
        if not self.allocator.commit(page, block_hash, parent_hash):
            self.allocator.free([page])  # duplicate hash: already cached
            return
        self._seal_queue.append((r.slot, position * self.ecfg.page_size, page))
        # release our reference: the page parks in the LRU (prefix-hittable)
        # once the copy is dispatched — one stream keeps that order
        self.allocator.free([page])

    def _seal_prefilled(self, r: _Request, limit: Optional[int] = None) -> None:
        """Copy-commit the prompt blocks fully covered by prefill so far
        (beyond what was prefix-matched)."""
        ps = self.ecfg.page_size
        done_blocks = min(
            r.prefill_pos // ps if limit is None else limit,
            len(r.seq.blocks),
        )
        for blk in r.seq.blocks[r.sealed_prefix:done_blocks]:
            self._queue_seal(r, blk.position, blk.block_hash, blk.parent_hash)
        if done_blocks > r.sealed_prefix:
            # the blocks are MATCHABLE once _queue_seal committed them:
            # notify now, not when their copy dispatches (a prefill-only
            # engine dispatches no round to carry them, and the disagg
            # export stream would wait out its safety timeout a chunk).
            # Every pool reader of the loop flushes queued seals first
            self._notify_commits()
        r.sealed_prefix = max(r.sealed_prefix, done_blocks)

    def _take_seal_batch(self, width: Optional[int] = None):
        """Pop + pad the pending seal queue as (slots, starts, pages) int32
        arrays (padding rows -> scratch page 0), or None. With ``width``
        at most that many entries are taken, padded to exactly it;
        without, the whole queue at a pow2-bucketed width."""
        if not self._seal_queue:
            return None
        if width is None:
            batch = self._seal_queue
            self._seal_queue = []
            w = pow2_cover(len(batch))
        else:
            batch = self._seal_queue[:width]
            self._seal_queue = self._seal_queue[width:]
            w = width
        arr = np.zeros((3, w), np.int32)  # padding -> scratch page 0
        for i, (s, st, pg) in enumerate(batch):
            arr[:, i] = (s, st, pg)
        return arr

    def _flush_seals(self) -> None:
        """Dispatch the pending ctx->pool seal copies standalone. Stream
        order makes this safe: the sealed positions were written by
        already-dispatched programs, and any admission that reads these
        pool pages is dispatched after this."""
        n_seal = len(self._seal_queue)
        arr = self._take_seal_batch()
        if arr is None:
            return
        self.dispatch_counts["seal"] += 1
        slots, starts, pages = self._to_device(arr)
        llama.seal_blocks(self.cache, self.ctx, slots, starts, pages,
                          self.ecfg.page_size)
        self._count_kv_quant(n_seal)
        self._notify_commits()

    def _count_kv_quant(self, n_seal: int) -> None:
        """An int8 pool's sealed pages: raw int8 moves (the ctx region
        shares the pool's representation)."""
        if self.kv_quant and n_seal:
            KV_QUANT.inc("dynamo_kv_quant_ctx_seal_raw_pages_total", n_seal)

    # ---- page I/O (offload, onboard, transfers): exactly n pages ----

    def _gather_pages(self, pages: list[int], page_major: bool = True):
        """Whole pool pages gathered on the device, in stream order after
        every program dispatched before: page-major ``(data [n, 2, L,
        kvh, ps, hd], scales [n, 2, L] or None)`` for the host tiers (a
        page is one run of bytes), else in the wire's layout ``(data [2,
        L, kvh, n, ps, hd], scales [2, L, n] or None)``."""
        ids = self._to_device(np.asarray(pages, np.int64))
        if self.kv_quant:
            data, scales = llama.gather_pages_q(self.cache, ids)
        else:
            data, scales = llama.gather_pages(self.cache, ids), None
        if not page_major:
            return data, scales
        return (data.permute(3, 0, 1, 2, 4, 5).contiguous(),
                scales.permute(2, 0, 1).contiguous()
                if scales is not None else None)

    def _fetch_pages(self, pages: list[int], page_major: bool = True
                     ) -> tuple:
        """``_gather_pages`` copied to the host on the copy stream:
        (data fetch, scales fetch or None, page_major)."""
        data, scales = self._gather_pages(pages, page_major)
        self.dispatch_counts["fetch"] += 1
        return (_Fetch(data, self._copy_stream),
                _Fetch(scales, self._copy_stream) if scales is not None
                else None, page_major)

    @staticmethod
    def _host_pages(data_f: _Fetch, scales_f: Optional[_Fetch],
                    page_major: bool = True):
        """A fetched gather in the reference's layout: ``[2, L, kvh, n,
        ps, hd]`` (a view of a page-major host buffer, or the contiguous
        buffer of a wire-layout gather), or a QuantizedPages bundle for an
        int8 pool."""
        data, scales = data_f.wait(), scales_f.wait() if scales_f else None
        if page_major:
            data = data.permute(1, 2, 3, 0, 4, 5)
            scales = scales.permute(1, 2, 0) if scales is not None else None
        return data if scales is None else QuantizedPages(data, scales)

    def _scatter_pages(self, pages: list[int], data: torch.Tensor,
                       scales: Optional[torch.Tensor],
                       page_major: bool = True) -> None:
        """Page-major host pages ``[n, 2, L, kvh, ps, hd]`` (scales ``[n,
        2, L]``), or with ``page_major`` False pages in the wire's layout
        ``[2, L, kvh, n, ps, hd]`` (scales ``[2, L, n]``), into pool
        ``pages``, IN PLACE (the round graphs captured the pool). The
        host->device copy runs on the compute stream, so it precedes every
        later program (an admission's load_ctx_pages); pinned sources stay
        alive until it ran (the caching host allocator records the
        copy)."""
        self.dispatch_counts["xfer_scatter"] += 1
        ids = self._to_device(np.asarray(pages, np.int64))
        if self.device.type == "cuda":
            self._fold_h2d()
            data = data.pin_memory()   # no copy when already pinned
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record()
            dev = data.to(self.device, non_blocking=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            self._h2d_events.append(
                (t0, t1, dev.numel() * dev.element_size()))
            if scales is not None:
                scales = scales.pin_memory().to(self.device,
                                                non_blocking=True)
        else:
            dev = data
        if page_major:
            dev = dev.permute(1, 2, 3, 0, 4, 5)
            scales = scales.permute(1, 2, 0) if scales is not None else None
        if self.kv_quant:
            llama.scatter_pages_q(self.cache, ids, dev, scales)
        else:
            llama.scatter_pages(self.cache, ids, dev)

    def _fold_h2d(self) -> None:
        """Fold the timed host->device copies that have run into the
        onboard figures."""
        with self._tier_lock:
            ev = self._h2d_events
            while ev and ev[0][1].query():
                t0, t1, n = ev.popleft()
                self._xstats["onboard_copy_s"] += t0.elapsed_time(t1) / 1e3
                self._xstats["onboard_bytes"] += n

    def _scatter_host(self, pages: list[int], data: Any) -> None:
        """Host pages in the reference's layout (``[2, L, kvh, n, ps,
        hd]`` or a QuantizedPages bundle) into the pool, converted to what
        this pool stores (a dense payload into an int8 pool quantizes, a
        bundle into a dense pool dequantizes)."""
        data = to_pool_dtype(data, self.kv_quant, self.cache["k"].dtype)
        if self.kv_quant:
            self._scatter_pages(pages, data.data.contiguous(),
                                data.scales.contiguous(), page_major=False)
        else:
            self._scatter_pages(pages, data.contiguous(), None,
                                page_major=False)

    # ---- offload (G2/G3 tiers) ----

    def _dispatch_offloads(self) -> None:
        """Gather the park candidates that still hold their block and copy
        them to the host behind compute. Runs BEFORE admission, so a
        same-round allocation cannot recycle a candidate between its
        validation and the gather (stream order would protect the gather's
        read anyway; validation avoids wasted copies)."""
        if self.offload is None or not self._offload_cands:
            return
        batch: list[tuple[int, int, int]] = []
        while len(batch) < self.ecfg.offload_batch:
            try:
                cand = self._offload_cands.popleft()
            except IndexError:
                break
            page, h, _parent = cand
            if h in self.offload:
                continue
            if self.allocator.page_for_hash(h) != page:
                continue  # evicted or recycled since parking
            batch.append(cand)
        if not batch:
            return
        if self._seal_queue:
            # the gather reads the pool: queued seal copies first
            self._flush_seals()
        t_disp = time.monotonic()
        self.dispatch_counts["offload_gather"] += 1
        data_f, scales_f, _ = self._fetch_pages([p for p, _, _ in batch])
        self.flight.record(
            "g2_offload", pages=len(batch),
            dispatch_ms=round((time.monotonic() - t_disp) * 1e3, 3))
        self._entries.append(_Entry(
            kind="offload", fetch=data_f, lp_fetch=scales_f,
            hashes=[h for _, h, _ in batch],
            parents=[par for _, _, par in batch]))

    def _put_offloaded(self, entry: _Entry) -> None:
        """An offload batch landed on the host: its puts into G2 (each
        page's crc, the copy into its slot, G2's spill into G3) go to the
        put thread, off the engine loop; the batch carries the tiers'
        generation, so a clear drops it."""
        data = self._host_pages(entry.fetch, entry.lp_fetch)
        xs = self._xstats
        for f in (entry.fetch, entry.lp_fetch):
            if f is not None and f.timing is not None:
                xs["offload_bytes"] += f.host.numel() * f.host.element_size()
                xs["offload_copy_s"] += f.timing[0].elapsed_time(
                    f.timing[1]) / 1e3
        self._puts.append(self._put_pool.submit(
            self._put_batch, entry.hashes, entry.parents, data,
            self._offload_gen))

    def _put_batch(self, hashes: list[int], parents: list[int], data: Any,
                   gen: int) -> None:
        """On the put thread: mint the batch's crcs side by side, then put
        page by page under the tier lock (the engine loop's onboards take
        it between pages)."""
        t0 = time.perf_counter()
        scales = None
        if isinstance(data, QuantizedPages):
            data, scales = data.data, data.scales
        crcs = page_checksums(data, scales, self._crc_pool)
        for i, (h, parent) in enumerate(zip(hashes, parents)):
            with self._tier_lock:
                if gen != self._offload_gen:
                    return  # cleared since the batch was gathered
                self.offload.put_one(
                    h, parent, data[:, :, :, i],
                    scales[..., i] if scales is not None else None, crcs[i])
        with self._tier_lock:
            self._xstats["offload_host_s"] += time.perf_counter() - t0
            self._xstats["offload_pages"] += len(hashes)

    def _reap_puts(self) -> None:
        """Drop the finished puts, raising a put thread's failure here."""
        while self._puts and self._puts[0].done():
            self._puts.popleft().result()

    def offloads_pending(self) -> int:
        """Offload work not yet in the tiers: park candidates, batches
        whose copy is in flight, and batches queued or running on the put
        thread."""
        return (len(self._offload_cands)
                + sum(en.kind == "offload" for en in list(self._entries))
                + sum(not f.done() for f in list(self._puts)))

    def _onboard_from_host(
        self, hashes: list[int], matched_pages: list[int]
    ) -> list[int]:
        """Extend a G1 prefix match with the contiguous run the host tiers
        hold: allocate pages, and chunk by chunk gather the run on the
        host, verify it against its crcs and scatter it into the pool,
        then commit the pages under the same chained hashes. A block that
        fails verification is quarantined (dropped from every tier,
        refused re-admission), and it and the rest of the run are left to
        prefill: corruption costs latency, never wrong tokens."""
        if self.offload is None:
            return matched_pages
        with self._tier_lock:
            return matched_pages + self._onboard_run(
                hashes[len(matched_pages):])

    def _onboard_run(self, hashes: list[int]) -> list[int]:
        """``_onboard_from_host`` under the tier lock: the pool pages the
        run landed in, committed."""
        run = self.offload.lookup_run(hashes)
        if not run:
            return []
        pages = self.allocator.allocate(len(run))
        if pages is None:
            return []
        t0 = time.perf_counter()
        cp = self.ecfg.kv_transfer_chunk_pages or len(pages)
        good = len(run)
        pin = self.device.type == "cuda"
        for i in range(0, len(pages), cp):
            chunk = run[i:i + cp]
            hs = [h for h, _ in chunk]
            stage = torch.empty((len(hs),) + self.offload.page_shape,
                                dtype=self.offload.dtype, pin_memory=pin)
            data = self.offload.gather(hs, out=stage)
            scales = self.offload.gather_scales(hs)
            # verify BEFORE the scatter: corrupt tier bytes never reach
            # the device pool
            bad = self.offload.verify_pages(hs, data, scales)
            k = bad[0] if bad else len(chunk)
            if k:
                self._scatter_pages(
                    pages[i:i + k], stage[:k],
                    scales.permute(2, 0, 1)[:k].contiguous()
                    if scales is not None else None)
            if bad:
                # the chained run must stay contiguous: everything from
                # the first bad block on is recomputed as prefill
                for j in bad:
                    self.kv_quarantine.add(hs[j])
                    self.offload.drop_everywhere(hs[j])
                good = i + k
                KV_INTEGRITY.inc("dynamo_kv_integrity_recomputed_total",
                                 len(run) - good)
                log.warning(
                    "KV integrity: %d corrupt block(s) in onboard run "
                    "quarantined; %d of %d blocks recomputed as prefill",
                    len(bad), len(run) - good, len(run))
                break
        if good < len(run):
            self.allocator.free(pages[good:])
            pages, run = pages[:good], run[:good]
        for pg, (h, parent) in zip(pages, run):
            self.allocator.commit(pg, h, parent)
        xs = self._xstats
        xs["onboard_host_s"] += time.perf_counter() - t0
        xs["onboard_pages"] += len(pages)
        return pages

    def transfer_stats(self) -> dict:
        """Offload and onboard figures since the engine was built: pages,
        host ms a page (offload: the put thread's crc, copy into G2 and
        spill into G3; onboard: the engine loop's gather, verify and copy
        dispatch), and on the card the copies' device-timed GB/s (offload:
        the copy stream's D2H; onboard: the H2D on the compute stream).
        Synchronises the device."""
        if self._h2d_events:
            torch.cuda.synchronize(self.device)
        with self._tier_lock:
            self._fold_h2d()
            xs = dict(self._xstats)

        def per_page(s, n):
            return s * 1e3 / n if n else None

        return {
            "offload_pages": xs["offload_pages"],
            "offload_host_ms_per_page": per_page(xs["offload_host_s"],
                                                 xs["offload_pages"]),
            "d2h_gb_s": (xs["offload_bytes"] / xs["offload_copy_s"] / 1e9
                         if xs["offload_copy_s"] else None),
            "onboard_pages": xs["onboard_pages"],
            "onboard_host_ms_per_page": per_page(xs["onboard_host_s"],
                                                 xs["onboard_pages"]),
            "h2d_gb_s": (xs["onboard_bytes"] / xs["onboard_copy_s"] / 1e9
                         if xs["onboard_copy_s"] else None),
        }

    # ---- page transfers (thread-safe; serviced by the engine loop) ----

    def export_pages(self, page_ids: list[int]):
        """Whole pool pages on the host: ``[2, L, kvh, n, ps, hd]`` (a
        QuantizedPages bundle of int8 pages and scales for an int8 pool).
        Blocks the caller until the loop services it at a round boundary
        (in stream order with the rounds in flight)."""
        return self._xfer_op("export", page_ids, None)

    def import_pages(self, page_ids: list[int], data: Any) -> None:
        """Scatter host pages into the pool (the inverse of
        export_pages)."""
        self._xfer_op("import", page_ids, data)

    def export_pages_by_hash(self, hashes: list[int]) -> tuple[int, Any]:
        """The longest committed run of the chained-hash prefix this pool
        holds, as (found, pages or None)."""
        return self._xfer_op("export_hash", [int(h) for h in hashes], None)

    def export_pages_stream(self, page_ids: list[int], chunk_pages: int = 0,
                            inflight: int = 0):
        """Chunked export: an iterator of host pages ``[2, L, kvh,
        <=chunk_pages, ps, hd]`` covering ``page_ids`` in order. The loop
        keeps ``inflight`` chunk copies in flight and serves between
        chunks, so host staging is O(chunk)."""
        out_q = self._start_stream("export_stream", list(page_ids),
                                   chunk_pages, inflight)
        return self._consume_stream(out_q)

    def export_hash_stream(self, hashes: list[int], chunk_pages: int = 0,
                           inflight: int = 0) -> tuple[int, Any]:
        """export_pages_by_hash, chunked: (found, chunk iterator)."""
        out_q = self._start_stream("export_hash_stream",
                                   [int(h) for h in hashes], chunk_pages,
                                   inflight)
        first = self._next_stream_item(out_q)  # ("found", k) | Exception
        if isinstance(first, Exception):
            raise first
        return int(first[1]), self._consume_stream(out_q)

    def clear_kv_blocks(self) -> int:
        """Drop every reusable cached page of every tier (G1 LRU, G2, G3):
        the /clear_kv_blocks operation (reference
        http/service/clear_kv_blocks.rs). Pages in use survive. Returns
        the pages dropped."""
        return self._xfer_op("clear", [], None)

    def _start_stream(self, kind: str, ids: list[int], chunk_pages: int,
                      inflight: int) -> queue_mod.Queue:
        if self._stop.is_set():
            raise RuntimeError("engine stopped")
        if not self._started:
            self.start()
        e = self.ecfg
        chunk_pages = int(chunk_pages or e.kv_transfer_chunk_pages
                          or max(len(ids), 1))
        inflight = max(1, int(inflight or e.kv_transfer_inflight_chunks))
        out_q: queue_mod.Queue = queue_mod.Queue()
        self._xfer.put((kind, ids, (chunk_pages, inflight, out_q),
                        threading.Event(), {}))
        self._wake_evt.set()
        return out_q

    def _wait_bounded(self, poll: Callable[[], Any], what: str) -> Any:
        """Poll (1 s slices) until ``poll`` returns something other than
        None, within ``xfer_op_timeout_s``; once the engine stops, within
        a 10 s grace."""
        deadline = time.monotonic() + self.ecfg.xfer_op_timeout_s
        stop_grace: Optional[float] = None
        while True:
            got = poll()
            if got is not None:
                return got
            now = time.monotonic()
            if self._stop.is_set():
                if stop_grace is None:
                    stop_grace = now + 10.0
                elif now > stop_grace:
                    raise RuntimeError(f"engine stopped during page {what}")
            elif now > deadline:
                raise TimeoutError(f"page {what} timed out")

    def _next_stream_item(self, out_q: queue_mod.Queue) -> Any:
        def poll():
            try:
                item = out_q.get(timeout=1.0)
            except queue_mod.Empty:
                return None
            # the pull freed an in-flight slot: ring the doorbell so a
            # throttled stream dispatches its next chunk now
            self._wake_evt.set()
            return item

        return self._wait_bounded(poll, "export stream")

    def _consume_stream(self, out_q: queue_mod.Queue):
        while True:
            item = self._next_stream_item(out_q)
            if item is _STREAM_EOS:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def _xfer_op(self, kind: str, page_ids: list[int], data: Any) -> Any:
        if self._stop.is_set():
            raise RuntimeError("engine stopped")
        if not self._started:
            self.start()
        done = threading.Event()
        box: dict[str, Any] = {}
        self._xfer.put((kind, list(page_ids), data, done, box))
        self._wake_evt.set()
        # an op in flight at a stop completes and reports its real
        # result; only the wait is bounded
        self._wait_bounded(lambda: True if done.wait(1.0) else None, kind)
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _process_transfers(self) -> bool:
        """Service the queued transfer ops; True when one was (transfer
        traffic is work: it keeps the loop from its idle sleep)."""
        processed = False
        while True:
            try:
                kind, ids, data, done, box = self._xfer.get_nowait()
            except queue_mod.Empty:
                return processed
            processed = True
            if kind != "import" and self._seal_queue:
                # pool readers must see the queued seal copies: a commit
                # is matchable before its copy is dispatched
                self._flush_seals()
            try:
                if kind == "export":
                    self.dispatch_counts["xfer_gather"] += 1
                    box["result"] = self._host_pages(
                        *self._fetch_pages(ids, page_major=False))
                elif kind == "export_stream":
                    chunk_pages, inflight, out_q = data
                    self._xfer_streams.append(_ExportStream(
                        ids=ids, chunk_pages=chunk_pages, inflight=inflight,
                        out_q=out_q))
                elif kind == "export_hash_stream":
                    # resolve and pin here; the stream drops the pins once
                    # every gather is dispatched
                    chunk_pages, inflight, out_q = data
                    pages = self.allocator.match_prefix(ids)
                    out_q.put(("found", len(pages)))
                    if not pages:
                        out_q.put(_STREAM_EOS)
                    else:
                        self._xfer_streams.append(_ExportStream(
                            ids=pages, chunk_pages=chunk_pages,
                            inflight=inflight, out_q=out_q,
                            free_pages=pages))
                elif kind == "export_hash":
                    pages = self.allocator.match_prefix(ids)
                    if not pages:
                        box["result"] = (0, None)
                    else:
                        self.dispatch_counts["xfer_gather"] += 1
                        out = self._host_pages(
                            *self._fetch_pages(pages, page_major=False))
                        self.allocator.free(pages)
                        box["result"] = (len(pages), out)
                elif kind == "clear":
                    n = self.allocator.clear()
                    self._offload_cands.clear()  # parked refs now stale
                    if self.offload is not None:
                        with self._tier_lock:
                            n += self.offload.clear()
                            # batches in flight or on the put thread would
                            # repopulate the tiers after the clear
                            self._offload_gen += 1
                        self._entries = [en for en in self._entries
                                         if en.kind != "offload"]
                    box["result"] = n
                else:
                    self._scatter_host(ids, data)
                    box["result"] = None
            except Exception as exc:  # noqa: BLE001 — surfaced to the caller
                box["error"] = exc
                if kind in ("export_stream", "export_hash_stream"):
                    data[2].put(exc)
                    data[2].put(_STREAM_EOS)
            finally:
                done.set()

    def _service_export_streams(self) -> bool:
        """Advance every chunked export a little (once a round): hand
        ready chunks to their consumers and dispatch new gathers up to
        the in-flight depth; reclaim a stream that moved nothing for the
        idle timeout. True if any stream made progress."""
        if not self._xfer_streams:
            return False
        if self._seal_queue:
            self._flush_seals()  # stream gathers read the pool
        now = time.monotonic()
        keep: list[_ExportStream] = []
        progressed = False
        for st in self._xfer_streams:
            try:
                moved = self._advance_stream(st)
            except Exception as exc:  # noqa: BLE001 — to the consumer
                self._end_stream(st, exc)
                progressed = True
                continue
            if moved:
                st.last_progress = now
                progressed = True
            if st.pos >= len(st.ids) and not st.pending:
                st.out_q.put(_STREAM_EOS)
                progressed = True
            elif (not moved and now - st.last_progress
                    > self.ecfg.kv_transfer_stream_idle_timeout_s):
                # the consumer vanished mid-stream: release the page pins
                # now rather than holding them for the op's deadline
                self._end_stream(st, RuntimeError("export stream abandoned"))
                progressed = True
            else:
                keep.append(st)
        self._xfer_streams = keep
        return progressed

    def _wait_stream_copy(self) -> bool:
        """With nothing else to do, block on the oldest chunk copy an
        export stream waits for, rather than the idle sleep (up to 20 ms
        a chunk of a disagg push or a G4 fetch); True if there was one."""
        for st in self._xfer_streams:
            if st.pending and st.out_q.qsize() < st.inflight:
                for f in st.pending[0][:2]:
                    if f is not None:
                        f.wait()
                return True
        return False

    def _end_stream(self, st: _ExportStream, exc: Exception) -> None:
        if st.free_pages is not None:
            self.allocator.free(st.free_pages)
            st.free_pages = None
        st.out_q.put(exc)
        st.out_q.put(_STREAM_EOS)

    def _advance_stream(self, st: _ExportStream) -> bool:
        progressed = False
        # ready heads, bounded by the consumer's pull so a stalled peer
        # cannot grow host staging without bound
        while (st.pending and all(f is None or f.ready()
                                  for f in st.pending[0][:2])
               and st.out_q.qsize() < st.inflight):
            st.out_q.put(self._host_pages(*st.pending.popleft()))
            progressed = True
        while (st.pos < len(st.ids) and len(st.pending) < st.inflight
               and st.out_q.qsize() < st.inflight):
            chunk = st.ids[st.pos: st.pos + st.chunk_pages]
            self.dispatch_counts["xfer_gather"] += 1
            st.pending.append(self._fetch_pages(chunk, page_major=False))
            st.pos += len(chunk)
            progressed = True
        if st.pos >= len(st.ids) and st.free_pages is not None:
            # every gather is dispatched: stream order protects the
            # reads, so the pins go now
            self.allocator.free(st.free_pages)
            st.free_pages = None
        return progressed

    def _drain_xfer_queue(self) -> None:
        """Fail the queued transfer ops (an op in flight finishes and
        reports its real result) and close the streams in flight."""
        while True:
            try:
                kind, _ids, data, done, box = self._xfer.get_nowait()
            except queue_mod.Empty:
                break
            box["error"] = RuntimeError("engine stopped")
            if kind in ("export_stream", "export_hash_stream"):
                data[2].put(box["error"])
                data[2].put(_STREAM_EOS)
            done.set()
        for st in self._xfer_streams:
            st.out_q.put(RuntimeError("engine stopped"))
            st.out_q.put(_STREAM_EOS)
        self._xfer_streams = []

    # ---- prefix-commit event plane ----

    def subscribe_commits(self, cb: Callable[[], None]) -> None:
        """Register a callback fired on the engine thread whenever the
        committed prefix grew: sealed blocks became matchable
        (_seal_prefilled) or a seal batch's pool copies were dispatched.
        Exporting on this signal is safe in stream order: every pool
        reader of the loop flushes queued seal copies first. Callbacks
        must be cheap and must not block (bounce to your own loop)."""
        with self._commit_lock:
            if cb not in self._commit_cbs:
                self._commit_cbs.append(cb)

    def unsubscribe_commits(self, cb: Callable[[], None]) -> None:
        with self._commit_lock:
            if cb in self._commit_cbs:
                self._commit_cbs.remove(cb)

    def _notify_commits(self) -> None:
        with self._commit_lock:
            cbs = list(self._commit_cbs)
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — never kill the loop
                log.exception("commit listener failed")

    # ---- G4 remote tier (kv_transfer.RemoteKvFetcher) ----

    async def _remote_prefetch(self, r: _Request) -> None:
        """Before intake: when the prompt's block-hash run is not covered
        by G1/G2/G3, ask the peer workers for it (G4). Fetched pages are
        queued for the engine loop to put into the G2 host tier, where the
        onboard path (_onboard_from_host) picks them up at admission: the
        remote tier needs no scatter of its own. The coverage checks here
        are hints read from another thread; a stale answer costs one
        wasted fetch or one recompute, never correctness."""
        ps = self.ecfg.page_size
        matchable = r.seq.blocks[: max(0, (len(r.tokens) - 1) // ps)]
        if not matchable:
            return
        i = self.allocator.cached_prefix_len(
            [b.block_hash for b in matchable])
        off = self.offload
        with self._tier_lock:
            while i < len(matchable) and (
                    matchable[i].block_hash in off
                    or (off.spill is not None
                        and matchable[i].block_hash in off.spill)):
                i += 1
        missing = matchable[i:]
        if not missing:
            return
        # dedup-by-hash admission: consult the fleet hint digest before
        # probing. The fleet-known holders are probed first; a miss none
        # of whose blocks the fleet hot set knows skips the probe round
        # (recomputing a prefix unique to this worker is the right call,
        # probing every peer for it is wasted wire)
        holder_hint: Optional[list[str]] = None
        hints = self.fleet_hints
        if (self.ecfg.kv_dedup_admission and hints is not None
                and hints.applied):
            known = [h for b in missing
                     for h in hints.holders(b.block_hash)]
            if known:
                # dedupe in first-seen order (leading blocks first)
                holder_hint = list(dict.fromkeys(known))
            elif all(hints.replicas(b.block_hash) is None
                     for b in missing):
                KV_FLEET.inc("dynamo_kv_fleet_dedup_skipped_probes_total")
                return
        t_fetch = time.monotonic()
        chunk_spans: list[dict] = []
        t_prev = t_fetch

        def land(offset: int, arr: Any) -> None:
            # one chunk into the ingest queue at once: G2 fills while
            # later chunks are still on the wire. An int8 peer's bundle
            # lands as-is in an int8 tier; a payload of the other mode
            # converts here. Each chunk is a g4_chunk child span
            nonlocal t_prev
            n = int(arr.shape[3])
            sub = missing[offset:offset + n]
            payload = to_pool_dtype(arr, self.kv_quant, off.dtype)
            if not isinstance(payload, QuantizedPages):
                payload = payload.to(off.dtype)
            self._host_ingest.put(([b.block_hash for b in sub],
                                   [b.parent_hash for b in sub], payload))
            self._wake_evt.set()
            chunk_spans.append(_span_dict("g4_chunk", t_prev, blocks=n,
                                          offset=offset))
            t_prev = time.monotonic()

        try:
            # every fetch path (streamed, a probe's full reply, the
            # monolithic race) delivers its pages through land
            found, _ = await self.remote_kv.fetch(
                [b.block_hash for b in missing], on_chunk=land,
                holders=holder_hint)
        except Exception:  # noqa: BLE001 — G4 is best-effort
            log.exception("G4 remote fetch failed")
            return
        if not found:
            return
        # every fetched block is a prefill block this worker did not
        # recompute: the dedup economy's headline counter
        KV_FLEET.inc("dynamo_kv_fleet_recompute_avoided_blocks_total",
                     int(found))
        # the peer-pool fetch with its chunk children, on the request's
        # worker-side spans
        sp = _span_dict("g4_fetch", t_fetch, blocks=int(found),
                        requested=len(missing),
                        chunks=max(len(chunk_spans), 1))
        if chunk_spans:
            sp["children"] = chunk_spans
        r.trace_spans.append(sp)

    def _drain_host_ingest(self) -> None:
        """Put the G4 pages fetched so far into G2 (on the loop, before
        admission, so a request's own fetch is in G2 when it is begun)."""
        while True:
            try:
                hashes, parents, data = self._host_ingest.get_nowait()
            except queue_mod.Empty:
                return
            crcs = page_checksums(data, pool=self._crc_pool)
            with self._tier_lock:
                n = self.offload.put_batch(hashes, parents, data,
                                           checksums=crcs)
                self.remote_onboard_blocks += n
                if n and CHAOS.fire("corrupt_prefetch"):
                    # rot a landed page AFTER its crc was sealed at put
                    # (silent corruption of fetched content): the
                    # onboard verify must quarantine it before it can
                    # reach the device pool
                    self.offload.rot_page(hashes[0])

    def apply_fleet_hints(self, digest: dict) -> None:
        """The frontend's hint push (kv_router/prefetch.py): keep the
        fleet replica and holder digest for dedup admission and wire the
        replica counts into G2/G3 eviction. The hint maps are swapped
        whole, so the engine thread evicting beside a push sees the old
        digest or the new one, never a torn one."""
        from dynamo_tpu_torch.kv_router.fleet import FleetHints

        if self.fleet_hints is None:
            self.fleet_hints = FleetHints(digest)
        else:
            self.fleet_hints.apply(digest)
        if self.offload is not None:
            self.offload.fleet_replicas = self.fleet_hints.replicas
            if self.offload.spill is not None:
                self.offload.spill.fleet_replicas = self.fleet_hints.replicas

    async def prefetch_hashes(
        self, hashes: list[int], parents: Optional[list[int]] = None
    ) -> int:
        """The fleet's replication push (kv_router/prefetch.py): pull the
        given chained-hash run from peer pools into the G2 host tier
        AHEAD of demand. Blocks held in G1/G2/G3 are skipped; the fetched
        pages ride the same ingest queue as demand G4 fetches (so
        ``corrupt_prefetch`` guards them too). The loop is started here if
        it is not running yet, so a cold worker's warm-start pages land
        before its first request (the JAX package's wait in the queue
        until then). Returns the blocks fetched."""
        off = self.offload
        if self.remote_kv is None or off is None or not hashes:
            return 0
        if not self._started:
            self.start()
        if parents is None:
            # best-effort chain: within the run each block's parent is
            # its predecessor; the head's true parent is unknown here
            parents = [0, *hashes[:-1]]
        par = dict(zip(hashes, parents))
        with self._tier_lock:
            missing = [
                h for h in hashes
                if h not in off
                and (off.spill is None or h not in off.spill)
                and self.allocator.page_for_hash(h) is None
            ]
        if not missing:
            return 0

        def land(offset: int, arr: Any) -> None:
            sub = missing[offset:offset + int(arr.shape[3])]
            payload = to_pool_dtype(arr, self.kv_quant, off.dtype)
            if not isinstance(payload, QuantizedPages):
                payload = payload.to(off.dtype)
            self._host_ingest.put((sub, [par[h] for h in sub], payload))
            self._wake_evt.set()

        try:
            found, _ = await self.remote_kv.fetch(missing, on_chunk=land)
        except Exception:  # noqa: BLE001 — prefetch is best-effort
            log.exception("fleet prefetch fetch failed")
            return 0
        found = int(found or 0)
        if found:
            KV_FLEET.inc("dynamo_kv_fleet_prefetched_blocks_total", found)
        return found

    # ---- load metrics ----

    def metrics(self) -> ForwardPassMetrics:
        """The worker's load metrics (reference ``TpuEngine.metrics``):
        slots, waiting requests, pool occupancy and hit rate, the G2/G3
        tiers' occupancy, and the speculation counters with the effective
        K's distribution over the speculating slots. Fields of planes not
        ported stay at their defaults."""
        a = self.allocator
        e = self.ecfg
        # "gpu cache usage" is the live serving occupancy (the ctx
        # region's tokens), floored by pool pressure: the pool holds
        # parked prefix blocks, so its own usage reads ~0 under load
        live_tokens = sum(int(self._ctx_disp[i])
                          for i, r in enumerate(self._slots) if r is not None)
        ctx_usage = live_tokens / float(self._B * e.max_context)
        num_waiting = (sum(1 for r in self._waiting if r.slot < 0)
                       + self._intake.qsize())
        with self._wt_lock:
            waiting_tokens = self._waiting_tokens
            t_waiting = dict(self._tenant_waiting)
            t_tokens = dict(self._tenant_tokens)
        # the overload gauges, and the tenant-sliced backlog gauges
        OVERLOAD.set("dynamo_overload_queue_depth", num_waiting)
        OVERLOAD.set("dynamo_overload_queue_tokens", waiting_tokens)
        for t in set(t_waiting) | set(t_tokens):
            TENANT.set("dynamo_tenant_queue_depth", t, t_waiting.get(t, 0))
            TENANT.set("dynamo_tenant_queue_tokens", t, t_tokens.get(t, 0))
        KV_QUANT.set("dynamo_kv_pool_capacity_blocks", a.total_pages)
        off = self.offload
        spill = off.spill if off is not None else None
        sp = self.spec
        k_mean = k_p50 = k_p95 = 0.0
        if sp is not None:
            k_mean, k_p50, k_p95 = sp.effective_k_dist(
                np.flatnonzero(self._slot_spec))
            SPEC.set("dynamo_spec_accept_rate", sp.acceptance_rate())
        return ForwardPassMetrics(
            worker_id=e.worker_id,
            histograms=self._histograms_snapshot(),
            worker_stats=WorkerStats(
                request_active_slots=(sum(r is not None for r in self._slots)
                                      + len(self._prefilling)),
                request_total_slots=self._B,
                num_requests_waiting=num_waiting,
                num_waiting_prefill_tokens=waiting_tokens,
                max_waiting_requests=e.max_waiting_requests,
                max_waiting_prefill_tokens=e.max_waiting_prefill_tokens,
                spec_proposed_total=sp.proposed_total if sp else 0,
                spec_accepted_total=sp.accepted_total if sp else 0,
                spec_acceptance_rate=sp.acceptance_rate() if sp else 0.0,
                spec_effective_k=k_mean,
                spec_effective_k_p50=k_p50,
                spec_effective_k_p95=k_p95,
                spec_tree_nodes_total=sp.tree_nodes_total if sp else 0,
                spec_tree_accepted_path_len_total=(
                    sp.tree_path_len_total if sp else 0),
                spec_gated_despecs_total=(
                    sp.gated_despec_total if sp else 0),
            ),
            kv_stats=KvStats(
                kv_active_blocks=a.active_pages,
                kv_total_blocks=a.total_pages,
                gpu_cache_usage_perc=max(a.usage(), ctx_usage),
                gpu_prefix_cache_hit_rate=a.hit_rate(),
                host_blocks=len(off) if off is not None else 0,
                host_total_blocks=off.num_pages if off is not None else 0,
                host_onboard_hits=off.onboard_hits if off is not None else 0,
                disk_blocks=len(spill) if spill is not None else 0,
                disk_total_blocks=spill.num_pages if spill is not None else 0,
            ),
        )

    def _histograms_snapshot(self) -> dict:
        """The latency histograms' snapshot, refreshed at most every
        0.25 s (the publisher's own throttle)."""
        now = time.monotonic()
        t, snap = self._hist_snap
        if now - t >= 0.25:
            snap = self.telemetry.snapshot()
            self._hist_snap = (now, snap)
        return snap

    def tenant_debug(self) -> dict:
        """Per-tenant quota, backlog and metric view: the engine half of
        /debug/tenants (runtime/system_server.py; the frontend adds its
        own metric slice)."""
        with self._wt_lock:
            t_waiting = dict(self._tenant_waiting)
            t_tokens = dict(self._tenant_tokens)
        quotas = self.tenant_quotas.snapshot()
        metrics_snap = TENANT.snapshot()
        tenants: dict[str, dict[str, Any]] = {}
        for t in (set(t_waiting) | set(t_tokens) | set(quotas)
                  | set(metrics_snap)):
            tenants[t] = {
                "waiting_requests": t_waiting.get(t, 0),
                "waiting_prefill_tokens": t_tokens.get(t, 0),
                **(quotas.get(t) or {}),
                "metrics": metrics_snap.get(t, {}),
            }
        return {
            "bounded": self.tenant_quotas.bounded,
            "max_waiting_requests": self.ecfg.tenant_max_waiting_requests,
            "max_waiting_prefill_tokens": (
                self.ecfg.tenant_max_waiting_prefill_tokens),
            "n_adapters": self.n_adapters,
            "tenants": tenants,
        }

    # ---- admission / prefill ----

    def _admit(self) -> None:
        now = _wall_time()
        kept = []
        for r in self._waiting:
            if r.cancelled:
                self._abort_prefill(r)
            elif (r.prefill_pos < 0 and r.req.deadline is not None
                    and now > r.req.deadline):
                # a still-WAITING request past its deadline would only
                # prefill dead work; one that started is always served
                self._shed_waiting(r, "deadline")
            else:
                kept.append(r)
        self._waiting = kept
        self._maybe_preempt_running()
        # bounded prefill budget per round: a long prompt advances one
        # chunk at a time with decode rounds in between
        budget = max(1, self.ecfg.prefill_chunks_per_round)
        while budget > 0 and self._waiting:
            group, width = self._collect_prefill_group(budget)
            if not group:
                return  # head is blocked on a free lane
            if len(group) == 1:
                budget -= 1
                if self._prefill_step(group[0], width):
                    self._waiting.remove(group[0])
                continue
            budget -= len(group)
            for r in self._batch_prefill_group(group, width):
                self._waiting.remove(r)

    # ---- overload plane: budgets, shedding, preemption ----

    def _uncount_waiting(self, r: _Request) -> None:
        """Drop a request's prompt from the waiting backlog's counters
        (idempotent: the first lane acquisition or queue exit wins)."""
        if not r.counted:
            return
        r.counted = False
        t = r.tenant
        with self._wt_lock:
            self._waiting_tokens -= len(r.tokens)
            self._tenant_waiting[t] = max(
                0, self._tenant_waiting.get(t, 0) - 1)
            self._tenant_tokens[t] = max(
                0, self._tenant_tokens.get(t, 0) - len(r.tokens))

    def _shed_waiting(self, r: _Request, reason: str) -> None:
        """Drop a still-WAITING request. A ``deadline`` shed finishes
        cleanly (zero tokens and the DEADLINE finish: the budget ran out,
        nothing failed); a preemption or budget shed surfaces the
        retriable overload error, so a router re-routes it."""
        self._uncount_waiting(r)
        r.finished = True
        if reason == "deadline":
            self.sheds += 1
            OVERLOAD.inc("dynamo_overload_shed_total")
            r.emit(LLMEngineOutput(
                token_ids=[], finish_reason=FinishReason.DEADLINE,
                annotations={"shed": {
                    "reason": "deadline",
                    "queued_s": round(time.monotonic() - r.enqueue_time, 3),
                }}))
            return
        t = r.tenant
        TENANT.inc("dynamo_tenant_shed_total", t)
        if self.tenant_quotas.bounded:
            # the pressure is the tenant's, so the hint is too: its own
            # queue-wait p50 x its own backlog depth
            with self._wt_lock:
                t_waiting = self._tenant_waiting.get(t, 0)
            retry = self.tenant_quotas.retry_after_s(t, t_waiting)
        else:
            retry = self.admission.retry_after_s(
                sum(1 for w in self._waiting if w.slot < 0))
        r.emit(EngineOverloadedError(
            f"request shed while waiting ({reason})",
            retry_after_s=retry, tenant=t))

    def _evict_waiting(self, cands: list[_Request], what: str) -> None:
        """Evict the lowest-priority, newest of ``cands`` (the not-started
        waiting entries over a budget): a preemption when a higher
        priority waits among them, else a bounce of the newest arrival
        (the budget stays honest either way)."""
        lo = min(r.req.priority for r in cands)
        hi = max(r.req.priority for r in cands)
        victim = max((r for r in cands if r.req.priority == lo),
                     key=lambda r: r.enqueue_time)
        if lo < hi:
            self.waiting_preemptions += 1
            OVERLOAD.inc("dynamo_overload_preempted_total")
            self._shed_waiting(victim, "preempted by priority" + (
                f" ({what})" if what != "queue budget" else ""))
        else:
            OVERLOAD.inc("dynamo_overload_rejected_total")
            self._shed_waiting(victim, f"{what} exceeded")
        self._waiting.remove(victim)

    def _enforce_bounds(self) -> None:
        """Restore the admission budgets after a HIGH-priority arrival
        was force-admitted past them: evict the lowest-priority, newest
        waiting entry until the backlog fits. The tenant budgets first:
        a tenant's overflow is paid for within that tenant."""
        self._enforce_tenant_bounds()
        adm = self.admission
        if not adm.bounded:
            return
        while True:
            cands = [r for r in self._waiting
                     if r.prefill_pos < 0 and not r.cancelled
                     and not r.finished]
            with self._wt_lock:
                tokens = self._waiting_tokens
            over = ((adm.max_waiting_requests
                     and len(cands) > adm.max_waiting_requests)
                    or (adm.max_waiting_prefill_tokens
                        and tokens > adm.max_waiting_prefill_tokens))
            if not over or not cands:
                return
            self._evict_waiting(cands, "queue budget")

    def _enforce_tenant_bounds(self) -> None:
        """The per-tenant half of _enforce_bounds: the victim is always
        the offending tenant's own lowest-priority, newest waiting entry,
        never another tenant's work."""
        tq = self.tenant_quotas
        if not tq.bounded:
            return
        while True:
            by_tenant: dict[str, list[_Request]] = {}
            for r in self._waiting:
                if r.prefill_pos < 0 and not r.cancelled and not r.finished:
                    by_tenant.setdefault(r.tenant, []).append(r)
            for rs in by_tenant.values():
                toks = sum(len(r.tokens) for r in rs)
                if ((tq.max_waiting_requests
                     and len(rs) > tq.max_waiting_requests)
                        or (tq.max_waiting_prefill_tokens
                            and toks > tq.max_waiting_prefill_tokens)):
                    self._evict_waiting(rs, "tenant budget")
                    break
            else:
                return

    def _maybe_preempt_running(self) -> None:
        """The running half of priority preemption (``preempt_running``):
        a HIGH-priority request blocked on a lane force-evicts the
        lowest-priority RUNNING stream. Its client stream fails with the
        retriable PreemptedError, a router replays it on a peer
        (exactly-once, greedy token-identical: a migration), and the
        freed lane admits the high-priority request in a later round. At
        most one victim a round; a lane mid-prefill is never preempted
        (its replay would waste the prefill and free no decode lane
        yet)."""
        if not self.ecfg.preempt_running:
            return
        hp = next((r for r in self._waiting
                   if r.prefill_pos < 0 and not r.cancelled
                   and r.req.priority > 0), None)
        if hp is None or self._free_slot() is not None:
            return
        victims = [v for v in self._slots
                   if v is not None and not v.finished and not v.cancelled
                   and v.req.priority < hp.req.priority]
        if not victims:
            return
        # tenant-confined: with tenant budgets, a victim comes from a
        # tenant over its own budget whenever one holds a lane
        if self.tenant_quotas.bounded:
            with self._wt_lock:
                tw = dict(self._tenant_waiting)
                tt = dict(self._tenant_tokens)
            over = [v for v in victims if self.tenant_quotas.over_budget(
                tw.get(v.tenant, 0), tt.get(v.tenant, 0))]
            if over:
                victims = over
        lo = min(v.req.priority for v in victims)
        victim = max((v for v in victims if v.req.priority == lo),
                     key=lambda v: v.enqueue_time)
        self.preempt_migrations += 1
        OVERLOAD.inc("dynamo_overload_preempt_migrations_total")
        log.warning("preempting running request %s (priority %d) for "
                    "high-priority arrival %s", victim.req.request_id,
                    victim.req.priority, hp.req.request_id)
        victim.emit(PreemptedError(
            "preempted by a higher-priority request; stream migrates"))
        self._finish(victim, None)

    def _chunk_width(self, remaining: int) -> int:
        """Padded (bucketed, page-aligned) width of the next chunk for a
        request with `remaining` unprefilled tokens."""
        e = self.ecfg
        ps = e.page_size
        max_chunk = ((e.prefill_buckets[-1] + ps - 1) // ps) * ps
        pad_t = e.bucket_for(min(remaining, max_chunk)) or max_chunk
        return ((pad_t + ps - 1) // ps) * ps

    def _collect_prefill_group(
        self, budget: int
    ) -> tuple[list[_Request], int]:
        """A FIFO prefix of the waiting queue whose next chunks share one
        bucket width. Requests are *begun* (lane + prefix match) as they
        are considered — a member whose bucket diverges stays begun and
        leads the next group. Returns (group, T)."""
        e = self.ecfg
        group: list[_Request] = []
        width = 0
        cap = min(budget, max(1, e.prefill_batch_max))
        for r in self._waiting:
            if len(group) >= cap:
                break
            if r.prefill_pos < 0:
                if self._free_slot() is None:
                    break
                self._prefill_begin(r)
            t = self._chunk_width(len(r.tokens) - r.prefill_pos)
            if not group:
                width = t
                cap = min(cap, max(1, e.prefill_token_budget // t))
            elif t != width:
                break
            group.append(r)
        return group, width

    def _batch_prefill_group(
        self, group: list[_Request], width: int
    ) -> list[_Request]:
        """One batched prefill for the group's next chunks; finishes the
        requests whose prompts complete and returns them."""
        K = len(group)
        toks = np.zeros((K, width), np.int32)
        slots, q_starts, seq_lens = [], [], []
        for i, r in enumerate(group):
            start = r.prefill_pos
            chunk = r.tokens[start: start + width]
            toks[i, : len(chunk)] = chunk
            slots.append(r.slot)
            q_starts.append(start)
            seq_lens.append(start + len(chunk))
        # attend only the prior context any row can see: keys at or past
        # a row's q_start are masked, so a wider window changes nothing
        ctx_span = max(q_starts)
        t_disp = time.monotonic()
        self.dispatch_counts["prefill_batch"] += 1
        logits = llama.batch_prefill(
            self.config, self.params, self.ctx,
            self._to_device(toks),
            slots, q_starts, seq_lens, ctx_span,
            adapter_ids=[r.adapter_id for r in group],
        )
        self.flight.record(
            "prefill_batch", slots=slots, width=width,
            dispatch_ms=round((time.monotonic() - t_disp) * 1e3, 3))
        done: list[_Request] = []
        for i, r in enumerate(group):
            r.prefill_pos = seq_lens[i]
            if r.prefill_pos < len(r.tokens):
                self._seal_prefilled(r)  # mid-prompt blocks seal per chunk
                continue  # next chunk in a later round
            self._finish_prefill(r, logits[i])
            done.append(r)
        return done

    def _prefill_step(self, r: _Request, width: int) -> bool:
        """One chunk of a request prefilled alone (llama.prefill, the
        reference's path for a group of one); on the final chunk, finish
        the prefill. Returns True when the request is done."""
        start = r.prefill_pos
        chunk = r.tokens[start: start + width]
        toks = np.zeros(width, np.int32)
        toks[: len(chunk)] = chunk
        t_disp = time.monotonic()
        self.dispatch_counts["prefill"] += 1
        logits = llama.prefill(
            self.config, self.params, self.ctx, self._to_device(toks),
            r.slot, start, start + len(chunk), r.adapter_id)
        self.flight.record(
            "prefill", slots=[r.slot], tokens=len(chunk), start=start,
            dispatch_ms=round((time.monotonic() - t_disp) * 1e3, 3))
        r.prefill_pos = start + len(chunk)
        if r.prefill_pos < len(r.tokens):
            self._seal_prefilled(r)  # earlier chunks' blocks seal now
            return False
        self._finish_prefill(r, logits)
        return True

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None and i not in self._prefilling:
                return i
        return None

    def _abort_prefill(self, r: _Request) -> None:
        """Release a half-prefilled request's lane reservation."""
        self._uncount_waiting(r)
        if r.slot >= 0 and self._prefilling.get(r.slot) is r:
            del self._prefilling[r.slot]
        r.slot = -1
        r.prefill_pos = -1

    def _prefill_begin(self, r: _Request) -> None:
        """Start a request's prefill: reserve a lane, prefix-match and copy
        the matched run pool -> ctx. Seals queued by other requests are
        flushed first — their pages are matchable but maybe not copied."""
        ps = self.ecfg.page_size
        self._flush_seals()
        slot = self._free_slot()
        r.slot = slot
        self._prefilling[slot] = r
        # the request holds a lane: active work now, not the backlog
        self._uncount_waiting(r)
        # fair queuing: service start advances the global virtual clock
        # to this request's stamp, so later arrivals start from here
        self._vclock = max(self._vclock, r.vft)
        if r.t_prefill_start is None:
            r.t_prefill_start = time.monotonic()
            wait = r.t_prefill_start - r.enqueue_time
            rid = r.req.request_id or None
            self._h_queue.observe(wait, exemplar_id=rid)
            self.tenant_quotas.note_queue_wait(r.tenant, wait)
            TENANT.observe("dynamo_tenant_request_queue_seconds", r.tenant,
                           wait)
            r.trace_spans.append(_span_dict("queue", r.enqueue_time))
        hashes = r.seq.block_hashes()
        matchable = hashes[: max(0, (len(r.tokens) - 1) // ps)]
        matched_pages = self.allocator.match_prefix(matchable)
        # a miss in HBM continues from the host tiers (scattered into the
        # pool ahead of the load below, in stream order)
        t_onboard = time.monotonic()
        g1_matched = len(matched_pages)
        matched_pages = self._onboard_from_host(matchable, matched_pages)
        if len(matched_pages) > g1_matched:
            r.trace_spans.append(_span_dict(
                "g2_onboard", t_onboard,
                blocks=len(matched_pages) - g1_matched))
        usable_pages = matched_pages[: self.ecfg.max_context // ps]
        r.matched_blocks = len(usable_pages)
        if usable_pages:
            padded = np.zeros(pow2_cover(len(usable_pages)), np.int64)
            padded[: len(usable_pages)] = usable_pages  # pad: scratch page 0
            self.dispatch_counts["load_ctx"] += 1
            llama.load_ctx_pages(self.ctx, self.cache, slot,
                                 self._to_device(padded))
            if self.kv_quant:
                KV_QUANT.inc("dynamo_kv_quant_ctx_admit_raw_pages_total",
                             len(usable_pages))
        if matched_pages:
            # copy dispatched: stream order lets us drop the refs now
            self.allocator.free(matched_pages)
        r.prefill_pos = len(usable_pages) * ps
        r.sealed_prefix = len(usable_pages)  # matched blocks: already cached

    def _finish_prefill(self, r: _Request, logits: torch.Tensor) -> None:
        """Prefill tail: commit the prompt blocks, sample the first token
        on the device, activate the slot."""
        e = self.ecfg
        if r.t_prefill_start is not None:
            r.trace_spans.append(_span_dict(
                "prefill", r.t_prefill_start, prompt_tokens=len(r.tokens),
                matched_blocks=r.matched_blocks, slot=r.slot))
        self._seal_prefilled(r, limit=len(r.seq.blocks))
        so = r.req.sampling_options
        slot = r.slot
        if so.seed is not None:
            # seeded: keys derived from the seed alone (reproducible)
            first_key = [_FIRST_TOKEN_KEY_TAG, so.seed & 0xFFFFFFFF]
            step_keys = [0, so.seed & 0xFFFFFFFF]
        else:
            # unseeded: fresh entropy, so two identical prompts do not
            # sample identically
            step_keys = np.frombuffer(os.urandom(8), np.uint32).tolist()
            first_key = [_FIRST_TOKEN_KEY_TAG ^ step_keys[0], step_keys[1]]
        knobs = _sampling_knobs(so)
        # the first token: sampler knobs only, no penalties (nothing
        # generated yet)
        sp1 = sampling.default_params(1, self.device)
        sp1.temperature.fill_(knobs["temp"])
        sp1.top_k.fill_(knobs["top_k"])
        sp1.top_p.fill_(knobs["top_p"])
        counts1 = torch.zeros(1, self.config.vocab_size, dtype=torch.int32,
                              device=self.device)
        key1 = self._to_device(np.asarray([first_key], np.int64))
        self.dispatch_counts["sample_first"] += 1
        first_tok = sampling.sample_step(
            logits[None], counts1, sp1, e.max_top_k, key1)
        want_lp = r.req.output_options.logprobs is not None
        first_lp = (sampling.pack_logprobs(*sampling.compute_logprobs(
            logits[None], first_tok, e.max_logprobs)) if want_lp else None)
        del self._prefilling[slot]
        self._slots[slot] = r
        self._ctx_disp[slot] = len(r.tokens) + 1
        more = r.max_new_tokens(e.max_context) > 1
        # speculation is confined to the base model (adapter 0): the draft
        # and verify programs carry no adapter
        if (more and self.spec is not None and r.adapter_id == 0
                and self.spec.eligible(r.req)):
            # speculative admission: the lane stays PARKED (as a freed
            # slot's); the slot advances through verify dispatches once
            # its first token has landed (_process_first marks it ready)
            r.spec = True
            self._slot_off(slot, spec=True)
            r.spec_keys = np.asarray(step_keys, np.int64)
            if self.spec.penalized(r.req):
                r.spec_counts = np.zeros(self.config.vocab_size, np.int32)
        elif more:
            self._slot_on(slot, r)
            self._dispatch_patch(admit=dict(
                slot=slot, ctx=len(r.tokens) + 1, tok=first_tok,
                keys=step_keys, adapter=r.adapter_id, **knobs))
        # else the first token is the last: the lane stays parked and no
        # decode round runs for it (a disagg prefill worker's
        # max_tokens=1 jobs); the slot is released once that token is
        # processed
        self.dispatch_counts["fetch"] += 1 + want_lp
        self._entries.append(_Entry(
            kind="first", fetch=_Fetch(first_tok),
            lp_fetch=_Fetch(first_lp) if want_lp else None,
            request=r))

    # ---- processing side (lagged results) ----

    def _process_entries(self, block: bool = False) -> None:
        # first-token entries are independent of round order: consume
        # them as soon as their copy lands (the TTFT lever)
        remaining = []
        for entry in self._entries:
            if entry.kind != "round" and entry.fetch.ready():
                self._consume_entry(entry)
            else:
                remaining.append(entry)
        self._entries = remaining
        while self._entries:
            entry = self._entries[0]
            if not block and not entry.fetch.ready():
                return
            self._entries.pop(0)
            self._consume_entry(entry)
            block = False  # at most one blocking wait

    def _consume_entry(self, entry: _Entry) -> None:
        if entry.kind == "offload":
            self._put_offloaded(entry)
            return
        data = entry.fetch.numpy()
        if entry.t_dispatch:
            # dispatch to result on the host (the wait above included)
            self._h_round.observe(time.monotonic() - entry.t_dispatch)
        lp = (self._unpack_lp(entry.lp_fetch.numpy())
              if entry.lp_fetch is not None else None)
        if entry.kind == "first":
            if lp is not None:
                lp = (float(lp[0][0]), lp[1][0], lp[2][0])
            self._process_first(entry.request, int(data[0]), lp)
        elif entry.kind == "spec":
            self._process_spec(entry, data)
        elif entry.kind == "spec_tree":
            self._process_spec_tree(entry, data)
        else:
            self._process_round(entry, data, lp)

    def _unpack_lp(self, packed: np.ndarray):
        """Split packed logprob rows [..., 1+2K] back into (chosen,
        top_ids, top_lps) — the inverse of sampling.pack_logprobs."""
        K = self.ecfg.max_logprobs
        return (packed[..., 0], packed[..., 1:1 + K].astype(np.int32),
                packed[..., 1 + K:])

    def _lp_pairs(self, r: _Request, ids, lps) -> list[list]:
        n = min(int(r.req.output_options.logprobs), self.ecfg.max_logprobs)
        return [[int(i), float(v)] for i, v in zip(ids[:n], lps[:n])]

    def _lp_payload(self, r: _Request, lp) -> dict:
        """LLMEngineOutput logprob fields for one emitted token."""
        if lp is None or r.req.output_options.logprobs is None:
            return {}
        chosen, ids, lps = lp
        return {"log_probs": [float(chosen)],
                "top_logprobs": [self._lp_pairs(r, ids, lps)]}

    def _process_first(self, r: _Request, tok: int, lp=None) -> None:
        if r.cancelled or r.finished:
            self._finish(r, None)
            return
        if r.first_token_time is None:
            r.first_token_time = time.monotonic()
            r.t_last_emit = r.first_token_time
            ttft = r.first_token_time - r.enqueue_time
            self._h_ttft.observe(ttft, exemplar_id=r.req.request_id or None)
            TENANT.observe("dynamo_tenant_request_ttft_seconds", r.tenant,
                           ttft)
        sc = r.req.stop_conditions
        if not sc.ignore_eos and tok in (sc.stop_token_ids or []) and (
            sc.min_tokens is None or r.produced >= sc.min_tokens
        ):
            self._finish(r, FinishReason.EOS)
            return
        r.last_token = tok
        r.produced += 1
        r.emit(LLMEngineOutput(token_ids=[tok], **self._lp_payload(r, lp)))
        if r.produced >= r.max_new_tokens(self.ecfg.max_context):
            self._finish(r, FinishReason.LENGTH)
        elif r.spec:
            # the host knows the pending token: speculation can start
            r.spec_tokens = list(r.tokens) + [tok]
            r.spec_ready = True

    def _process_round(self, entry: _Entry, toks: np.ndarray,
                       lp_arrs=None) -> None:
        """Consume one round's stacked tokens (and unpacked logprobs),
        emitting one batched output per request per round."""
        for slot, r in enumerate(entry.slots):
            # identity check doubles as the epoch: a recycled slot holds
            # a different _Request object than the snapshot
            if r is None or r.finished or self._slots[slot] is not r:
                continue
            if r.cancelled:
                self._finish(r, None)
                continue
            batch: list[int] = []
            lp_chosen: list[float] = []
            lp_top: list[list] = []
            with_lp = (lp_arrs is not None
                       and r.req.output_options.logprobs is not None)
            finish: Optional[FinishReason] = None
            for step in range(entry.n_steps):
                tok = int(toks[step, slot])
                finish = self._advance_token(r, tok)
                if finish is FinishReason.EOS:
                    break  # the stop token itself is not emitted
                batch.append(tok)
                if with_lp:
                    lp_chosen.append(float(lp_arrs[0][step, slot]))
                    lp_top.append(self._lp_pairs(
                        r, lp_arrs[1][step, slot], lp_arrs[2][step, slot]))
                if finish is not None:
                    break
            if batch:
                self._note_emit(r, len(batch), entry, "decode_round")
            if batch or finish is not None:
                extra = {}
                if lp_chosen:
                    extra = {"log_probs": lp_chosen, "top_logprobs": lp_top}
                if finish is not None:
                    extra["annotations"] = self._final_annotations(r)
                r.emit(LLMEngineOutput(
                    token_ids=batch, finish_reason=finish, **extra))
            if finish is not None:
                self._finish(r, None)
                continue
            if r.spec_gated or r.spec_rearm_wait > 0:
                self._spec_gated_advance(slot, r, batch)

    def _advance_token(
        self, r: _Request, tok: int
    ) -> Optional[FinishReason]:
        """Per-token state advance (sealing, stop detection, budget).
        Returns the finish reason when this token ENDS the request (EOS:
        token not emitted; LENGTH: token emitted as the last one)."""
        sc = r.req.stop_conditions
        # copy-commit the block completed by the previous token (stream
        # order: those positions were written by dispatched steps)
        if r.last_token >= 0:
            for blk in r.seq.extend([r.last_token]):
                self._queue_seal(
                    r, blk.position, blk.block_hash, blk.parent_hash)
        if not sc.ignore_eos and tok in (sc.stop_token_ids or []) and (
            sc.min_tokens is None or r.produced >= sc.min_tokens
        ):
            return FinishReason.EOS
        r.last_token = tok
        r.produced += 1
        if r.produced >= r.max_new_tokens(self.ecfg.max_context):
            return FinishReason.LENGTH
        return None

    def _note_emit(self, r: _Request, n_tokens: int, entry: _Entry,
                   kind: str) -> None:
        """Telemetry of one emitted batch: its per-token gap into the ITL
        histogram (the batch lands together: the gap is the wait split
        over its tokens, one observation a batch) and a capped round
        span, kept as a raw tuple until the request finishes."""
        now = time.monotonic()
        if r.t_last_emit is not None:
            gap = (now - r.t_last_emit) / n_tokens
            self._h_itl.observe(gap, n_tokens,
                                exemplar_id=r.req.request_id or None)
            if len(r.itl_gaps) < 4096:
                r.itl_gaps.append((gap, n_tokens))
        r.t_last_emit = now
        r.decode_rounds += 1
        cap = _MAX_ROUND_SPANS_DETAIL if r.trace_detail else _MAX_ROUND_SPANS
        if (len(r.trace_spans) + len(r.round_spans) < cap
                and entry.t_dispatch):
            r.round_spans.append((kind, entry.t_dispatch,
                                  now - entry.t_dispatch, n_tokens,
                                  entry.spec_host))

    def _final_annotations(self, r: _Request) -> dict:
        """Annotations of the FINISHING output: the speculation counters,
        the request's timing (TTFT, ITL p50/p95, queue, E2E), and its
        worker-side spans, which the frontend merges into its tree. When
        no in-process frontend owns the trace (a remote worker), the spans
        are recorded in this process's store and the breach decision runs
        here."""
        prev_seg = self.prof.push(_SEG_ANNOTATE)
        try:
            return self._final_annotations_inner(r)
        finally:
            self.prof.enter(prev_seg)

    def _final_annotations_inner(self, r: _Request) -> dict:
        ann = self._spec_annotations(r)
        rid = r.req.request_id
        e2e = time.monotonic() - r.enqueue_time
        self._h_e2e.observe(e2e, exemplar_id=rid or None)
        timing: dict[str, Any] = {
            "e2e_s": round(e2e, 6),
            "output_tokens": r.produced,
            "decode_rounds": r.decode_rounds,
        }
        if r.first_token_time is not None:
            timing["ttft_s"] = round(r.first_token_time - r.enqueue_time, 6)
        if r.t_prefill_start is not None:
            timing["queue_s"] = round(r.t_prefill_start - r.enqueue_time, 6)
        for key, q in (("itl_p50_s", 0.50), ("itl_p95_s", 0.95)):
            v = tmetrics.weighted_percentile(r.itl_gaps, q)
            if v is not None:
                timing[key] = round(v, 6)
        ann["timing"] = timing
        ann["cached_blocks"] = r.matched_blocks
        if r.round_spans:
            # the round spans as dicts, their unix starts anchored off the
            # shared monotonic clock
            wall_now = time.time()
            mono_now = time.monotonic()
            for kind, t0, dur, n_toks, spec_host in r.round_spans:
                sp: dict[str, Any] = {
                    "name": kind,
                    "start_s": round(wall_now - (mono_now - t0), 6),
                    "duration_s": round(dur, 6),
                    "attrs": {"tokens": n_toks},
                }
                if spec_host is not None:
                    # a verify round's draft and verify host walls
                    draft_s, verify_s = spec_host
                    t0_w = sp["start_s"]
                    sp["children"] = [
                        Span("spec_draft", t0_w, draft_s).to_dict(),
                        Span("spec_verify", t0_w + draft_s,
                             verify_s).to_dict(),
                    ]
                r.trace_spans.append(sp)
            r.round_spans = []
        if r.trace_spans:
            ann["trace"] = {"spans": list(r.trace_spans)}
            # no trace of this id in the process (active or finished):
            # no frontend here owns it. (The reference asks has_active,
            # so a migrated request's first attempt finishing late on
            # its killed worker overwrites the frontend's finished tree)
            if rid and TRACES.get(rid) is None:
                TRACES.record_remote(rid, r.trace_spans)
                self._forensics.worker_finish(
                    rid, timing=timing, worker_id=str(self.ecfg.worker_id),
                    trace_spans=r.trace_spans)
        return ann

    def _finish(
        self, r: _Request, reason: Optional[FinishReason],
    ) -> None:
        """Mark finished on the host; the slot is reclaimed by a release
        patch at the next round boundary."""
        if r.finished:
            return
        r.finished = True
        if r.slot >= 0 and self._slots[r.slot] is r:
            self._slot_off(r.slot)  # out of the dispatch set immediately
        if reason is not None:
            r.emit(LLMEngineOutput(
                token_ids=[], finish_reason=reason,
                annotations=self._final_annotations(r)))
        self._to_release.append(r)

    def _apply_releases(self) -> None:
        # also sweep cancelled requests that never got a finish event
        for slot, r in enumerate(self._slots):
            if r is not None and r.cancelled and not r.finished:
                r.finished = True
                self._slot_off(slot)
                self._to_release.append(r)
        if not self._to_release:
            return
        clear_slots = []
        for r in self._to_release:
            if r.slot >= 0 and self._slots[r.slot] is r:
                clear_slots.append(r.slot)
                self._slots[r.slot] = None
                self._slot_off(r.slot)
                self._ctx_disp[r.slot] = 1
                if self.spec is not None and r.spec:
                    self.spec.release(r.slot)  # stale draft KV state
            r.slot = -1
        self._to_release = []
        if clear_slots:
            self._dispatch_patch(clear_slots=clear_slots)

    def _fail_all(self, err: Exception) -> None:
        for r in self._slots:
            if r is not None:
                r.emit(err)
                r.finished = True
        self._slots = [None] * self._B
        self._slot_active[:] = False
        self._slot_spec[:] = False
        self._slot_sampler[:] = False
        self._slot_lp[:] = False
        self._active_cache = None
        if self.spec is not None:
            for i in range(self._B):
                self.spec.release(i)
        for r in self._waiting:
            r.emit(err)
            self._abort_prefill(r)
        self._waiting = []
        self._prefilling = {}
        self._entries = []
        self._seal_queue = []
