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
  - Intake follows the reference's overload rules that no knob turns on:
    a request whose deadline has passed is shed with zero tokens and the
    DEADLINE finish, at intake or while it still waits; a high-priority
    arrival queues ahead of every not-started lower-priority entry; and
    entries of one priority are ordered per tenant by start-time fair
    queuing, every tenant at weight 1 (one tenant stays FIFO).
  - Prefill runs batched per prefill bucket (batch_prefill); a group of
    one runs the single-request prefill (llama.prefill), as the
    reference does. The first token is sampled on the device with its
    own key stream and patched into the slot without a host round trip.

Not ported yet (ROADMAP.md): speculation, offload tiers, the transfer
plane, tenant quotas and adapters, overload budgets and preemption,
multimodal, w8a16, MoE.
"""
from __future__ import annotations

import asyncio
import logging
import os
import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine import graphs, sampling
from dynamo_tpu_torch.engine.cache import PageAllocator
from dynamo_tpu_torch.engine.config import EngineConfig, pow2_cover
from dynamo_tpu_torch.kv_router.protocols import KvCacheEvent
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger(__name__)

_FIRST_TOKEN_KEY_TAG = 0x46697273  # distinct PRNG stream for first tokens


def _wall_time() -> float:
    """Unix time: the clock request deadlines are stamped in."""
    return time.time()


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
    non-blocking copy, and the CUDA event recorded after it. CPU results
    are copied at once."""

    def __init__(self, src: torch.Tensor):
        self.event = None
        if src.is_cuda:
            self.host = torch.empty(src.shape, dtype=src.dtype,
                                    pin_memory=True)
            self.host.copy_(src, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = src.clone()

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclass
class _Entry:
    """One in-flight fetch: a round of stacked step tokens or a request's
    prefill first token, with its packed logprobs when asked for."""

    kind: str                      # "round" | "first"
    fetch: _Fetch
    lp_fetch: Optional[_Fetch] = None
    # round: the slot snapshot at dispatch
    slots: list[Optional[_Request]] = field(default_factory=list)
    n_steps: int = 0
    # first:
    request: Optional[_Request] = None


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
        self.allocator = PageAllocator(
            e.num_pages, e.page_size,
            worker_id=e.worker_id,
            on_event=on_kv_event,
            enable_prefix_caching=e.enable_prefix_caching,
        )
        B = e.max_decode_slots
        self._B = B
        self._slots: list[Optional[_Request]] = [None] * B
        # lanes reserved by an in-progress (multi-chunk) prefill: occupied
        # but not decoding until the admission patch
        self._prefilling: dict[int, _Request] = {}
        # slot-state mirrors: live (decoding) lanes, lanes that need the
        # full sampler (temperature or penalties) rather than argmax, and
        # lanes whose request asked for logprobs
        self._slot_active = np.zeros(B, bool)
        self._slot_sampler = np.zeros(B, bool)
        self._slot_lp = np.zeros(B, bool)
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

        self._intake: queue_mod.Queue = queue_mod.Queue()
        self._wake_evt = threading.Event()
        self._waiting: list[_Request] = []
        self._entries: list[_Entry] = []
        # sealed blocks awaiting the ctx->pool copy: (slot, start, page)
        self._seal_queue: list[tuple[int, int, int]] = []
        self._to_release: list[_Request] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False
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
            "admission": 0, "release": 0, "seal_overflow": 0}
        self.dispatch_counts: dict[str, int] = {
            "round": 0, "round_seal": 0, "seal": 0, "patch": 0,
            "prefill": 0, "prefill_batch": 0, "load_ctx": 0,
            "sample_first": 0, "fetch": 0,
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

    # ------------------------------------------------------------------
    # AsyncEngine surface

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[LLMEngineOutput]:
        """Stream engine outputs (token-id deltas) for one request."""
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
        if request.adapter_id or request.multimodal or request.disagg:
            raise ValueError(
                "LoRA adapters, multimodal inputs and disaggregated "
                "prefill are not supported by the PyTorch engine yet")
        if request.deadline is not None and _wall_time() > request.deadline:
            # the deadline passed before intake: shed with zero tokens and
            # the DEADLINE finish, never an error (the client's budget ran
            # out, nothing failed)
            self.sheds += 1
            yield LLMEngineOutput(
                token_ids=[], finish_reason=FinishReason.DEADLINE,
                annotations={"shed": {"reason": "deadline",
                                      "queued_s": 0.0}})
            return
        if not self._started:
            self.start()
        r = _Request(
            req=request,
            seq=TokenBlockSequence.from_tokens(
                request.token_ids, self.ecfg.page_size, salt=request.model),
            out=asyncio.Queue(),
            loop=asyncio.get_running_loop(),
            tokens=list(request.token_ids),
            tenant=request.tenant or "default",
        )
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
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    did_work = self._round()
                except Exception:  # noqa: BLE001 — engine loop must survive
                    log.exception("engine round failed")
                    self._fail_all(RuntimeError("engine step failed; see logs"))
                    did_work = False
                if not did_work:
                    self._wake_evt.wait(timeout=0.02)
                    self._wake_evt.clear()

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
        t_round = time.monotonic()
        self._drain_intake()
        in_flight = self._rounds_in_flight()
        dispatched = False
        t_pipe = 0.0
        if (e.round_pipeline and in_flight <= e.max_inflight_rounds
                and self._pipeline_clear()):
            active, want_lp, want_sample = self._active_slots()
            if active:
                self._dispatch_round(want_sample, want_lp)
                dispatched = True
                in_flight += 1
                self._pipe_dispatches += 1
                self._pipe_depth_sum += in_flight
                t_pipe = time.monotonic()
        self._process_entries(block=in_flight > e.max_inflight_rounds)
        self._apply_releases()
        self._admit()
        did_work = dispatched or bool(self._entries) or bool(self._prefilling)
        if (not dispatched
                and self._rounds_in_flight() <= e.max_inflight_rounds):
            # the strict position: after every patch above
            active, want_lp, want_sample = self._active_slots()
            if active:
                self._dispatch_round(want_sample, want_lp)
                did_work = dispatched = True
        if self._seal_queue and (
                not e.round_pipeline or not dispatched
                or len(self._seal_queue) > self._seal_fuse_w):
            self._flush_seals()
            did_work = True
        if t_pipe:
            # host time after the early dispatch ran with it in flight
            now = time.monotonic()
            self._pipe_hidden_s += now - t_pipe
            self._pipe_host_s += now - t_round
        if (not dispatched and self._entries
                and self._intake.empty() and not self._waiting):
            # nothing to overlap with the in-flight copies: block on the
            # head entry instead of spinning
            self._process_entries(block=True)
        return did_work

    def _rounds_in_flight(self) -> int:
        return sum(1 for en in self._entries if en.kind == "round")

    def _pipeline_clear(self) -> bool:
        """True when the next round may be dispatched before this round's
        results are processed: nothing pending may patch slot state under
        the in-flight rounds. Each False counts its flush point in
        ``pipe_flushes``: an admission (waiting, mid-prefill or fresh
        intake), a pending release, or a seal queue past the fused
        width."""
        if self._waiting or self._prefilling or not self._intake.empty():
            self.pipe_flushes["admission"] += 1
            return False
        if self._to_release:
            self.pipe_flushes["release"] += 1
            return False
        if len(self._seal_queue) > self._seal_fuse_w:
            self.pipe_flushes["seal_overflow"] += 1
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
        """Start-time fair queuing within a priority class; a
        high-priority arrival queues ahead of every lower-priority entry
        that has NOT started prefill (an entry holding a lane is active
        work, never jumped). Each request is stamped with a virtual
        finish time, its tenant's virtual clock advanced by its prompt
        length (every tenant's weight is 1 until quotas are ported), and
        goes before the first not-started same-priority entry with a
        LARGER stamp. A tenant's fresh arrival starts at the global
        virtual clock (advanced at service start, ``_prefill_begin``), so
        a storming tenant's backlog cannot hold it back; one tenant's
        stamps only grow, so its traffic stays FIFO."""
        t = r.tenant
        vstart = max(self._tenant_vnow.get(t, 0.0), self._vclock)
        r.vft = vstart + max(1, len(r.tokens))
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
        self._slot_lp[slot] = r.req.output_options.logprobs is not None
        self._slot_sampler[slot] = (
            (so.temperature or 0.0) > 0.0
            or (so.frequency_penalty or 0.0) != 0.0
            or (so.presence_penalty or 0.0) != 0.0
            or (so.repetition_penalty or 1.0) != 1.0
        )
        self._active_cache = None

    def _slot_off(self, slot: int) -> None:
        self._slot_active[slot] = False
        self._slot_sampler[slot] = False
        self._slot_lp[slot] = False
        self._active_cache = None

    # ---- dispatch side ----

    def _dispatch_round(self, want_sample: bool, want_lp: bool) -> None:
        """One round (``flush_every`` decode+sample steps, the ring->ctx
        flush and the pending seal batch: a graph replay on the card),
        then one stacked-token copy to the host (plus one packed-logprob
        copy when ``want_lp``), queued right behind it."""
        n = self.ecfg.flush_every
        seal = self._take_seal_batch(width=self._seal_fuse_w)
        self.kernel_launches += self.graphs.round(want_sample, want_lp, seal)
        self.dispatch_counts["round" if seal is None else "round_seal"] += 1
        self.step_count += n
        self.dispatch_counts["fetch"] += 1 + want_lp
        out = self.graphs.out
        self._entries.append(_Entry(
            kind="round", fetch=_Fetch(out["toks"]),
            lp_fetch=_Fetch(out["lp"]) if want_lp else None,
            slots=list(self._slots), n_steps=n,
        ))

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
        arr = self._take_seal_batch()
        if arr is None:
            return
        self.dispatch_counts["seal"] += 1
        slots, starts, pages = self._to_device(arr)
        llama.seal_blocks(self.cache, self.ctx, slots, starts, pages,
                          self.ecfg.page_size)

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
                self._shed_waiting(r)
            else:
                kept.append(r)
        self._waiting = kept
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

    def _shed_waiting(self, r: _Request) -> None:
        """Drop a waiting request whose deadline passed: zero tokens and
        the DEADLINE finish (the budget ran out, nothing failed)."""
        r.finished = True
        self.sheds += 1
        r.emit(LLMEngineOutput(
            token_ids=[], finish_reason=FinishReason.DEADLINE,
            annotations={"shed": {
                "reason": "deadline",
                "queued_s": round(time.monotonic() - r.enqueue_time, 3),
            }}))

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
        self.dispatch_counts["prefill_batch"] += 1
        logits = llama.batch_prefill(
            self.config, self.params, self.ctx,
            self._to_device(toks),
            slots, q_starts, seq_lens, ctx_span,
        )
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
        self.dispatch_counts["prefill"] += 1
        logits = llama.prefill(
            self.config, self.params, self.ctx, self._to_device(toks),
            r.slot, start, start + len(chunk))
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
        r.t_prefill_start = time.monotonic()
        # fair queuing: service start advances the global virtual clock
        # to this request's stamp, so later arrivals start from here
        self._vclock = max(self._vclock, r.vft)
        hashes = r.seq.block_hashes()
        matchable = hashes[: max(0, (len(r.tokens) - 1) // ps)]
        matched_pages = self.allocator.match_prefix(matchable)
        usable_pages = matched_pages[: self.ecfg.max_context // ps]
        r.matched_blocks = len(usable_pages)
        if usable_pages:
            padded = np.zeros(pow2_cover(len(usable_pages)), np.int64)
            padded[: len(usable_pages)] = usable_pages  # pad: scratch page 0
            self.dispatch_counts["load_ctx"] += 1
            llama.load_ctx_pages(self.ctx, self.cache, slot,
                                 self._to_device(padded))
        if matched_pages:
            # copy dispatched: stream order lets us drop the refs now
            self.allocator.free(matched_pages)
        r.prefill_pos = len(usable_pages) * ps
        r.sealed_prefix = len(usable_pages)  # matched blocks: already cached

    def _finish_prefill(self, r: _Request, logits: torch.Tensor) -> None:
        """Prefill tail: commit the prompt blocks, sample the first token
        on the device, activate the slot."""
        e = self.ecfg
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
        knobs = dict(
            temp=float(so.temperature or 0.0),
            top_k=int(so.top_k or 0),
            top_p=float(so.top_p if so.top_p is not None else 1.0),
            freq=float(so.frequency_penalty or 0.0),
            pres=float(so.presence_penalty or 0.0),
            rep=float(so.repetition_penalty or 1.0),
        )
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
        self._slot_on(slot, r)
        self._dispatch_patch(admit=dict(
            slot=slot, ctx=len(r.tokens) + 1, tok=first_tok,
            keys=step_keys, **knobs))
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
        data = entry.fetch.numpy()
        lp = (self._unpack_lp(entry.lp_fetch.numpy())
              if entry.lp_fetch is not None else None)
        if entry.kind == "first":
            if lp is not None:
                lp = (float(lp[0][0]), lp[1][0], lp[2][0])
            self._process_first(entry.request, int(data[0]), lp)
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

    def _final_annotations(self, r: _Request) -> dict:
        now = time.monotonic()
        timing: dict[str, Any] = {
            "e2e_s": now - r.enqueue_time,
            "output_tokens": r.produced,
        }
        if r.first_token_time is not None:
            timing["ttft_s"] = r.first_token_time - r.enqueue_time
        if r.t_prefill_start is not None:
            timing["queue_s"] = r.t_prefill_start - r.enqueue_time
        return {"timing": timing, "cached_blocks": r.matched_blocks}

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
        self._slot_sampler[:] = False
        self._slot_lp[:] = False
        self._active_cache = None
        for r in self._waiting:
            r.emit(err)
            self._abort_prefill(r)
        self._waiting = []
        self._prefilling = {}
        self._entries = []
        self._seal_queue = []
