"""Mocker: a deterministic fake engine with simulated paged-KV and timing
(the port's copy of the JAX package's mocker.py).

The reference calls this the keystone of its CPU test strategy
(lib/llm/src/mocker/engine.rs:60 MockVllmEngine, mocker/kv_manager.rs,
mocker/scheduler.rs:197, MockEngineArgs mocker/protocols.rs:72-94): a fake
engine that behaves like the real one — continuous batching, paged-KV
allocation with prefix reuse and LRU eviction, preemption under pressure,
per-step timing scaled by ``speedup_ratio`` — while publishing REAL
KvCacheEvents and ForwardPassMetrics. It lets the router, disagg path,
planner, frontend, and fault-injection tests run on CPU with no model.

This implementation reuses the engine's actual host-side state machinery:
`PageAllocator` (same events, same LRU/refcount semantics) and
`TokenBlockSequence` (same chained xxh3 block hashes the KV router indexes),
so mocker-driven router tests validate real hash parity.

Generated tokens are deterministic: step i of a request yields
``prompt[(i + len(prompt)) % len(prompt)]`` — stable across runs and
schedulings, like the reference's deterministic mock outputs.

One deliberate difference from the JAX package's mocker: a decode step
is due one step after the previous one was due (``_step_wait``), not a
step after the loop came back to sleep, so the host's wake-up time does
not lengthen every step and a mocker calibrated from a profile
(tools/calibrate_mocker.py) keeps the profiled cadence.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncIterator, Callable, Optional

from dynamo_tpu_torch.engine.cache import PageAllocator
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    KvStats,
    WorkerStats,
)
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.telemetry import metrics as tmetrics
from dynamo_tpu_torch.telemetry.metrics import (
    TelemetryRegistry,
    request_histograms,
)
from dynamo_tpu_torch.tokens import TokenBlockSequence


@dataclass
class MockerArgs:
    """Knobs of the simulated engine (reference MockEngineArgs
    mocker/protocols.rs:72-94: num_gpu_blocks, block_size, speedup_ratio,
    max_num_seqs, watermark...)."""

    num_pages: int = 128
    page_size: int = 16
    max_decode_slots: int = 8
    max_pages_per_seq: int = 64
    # simulated timing (wall-clock sleeps, divided by speedup_ratio)
    prefill_time_per_token_s: float = 0.00005
    decode_time_per_step_s: float = 0.002
    speedup_ratio: float = 1.0
    enable_prefix_caching: bool = True
    worker_id: str = "mocker"
    # overload plane (dynamo_tpu_torch/overload/): bounded admission budgets
    # over the waiting queue (0 = unbounded), so router/frontend
    # overload paths test on CPU. Unlike TorchEngine the bound applies to
    # every priority class (no preemption machinery here).
    max_waiting_requests: int = 0
    max_waiting_prefill_tokens: int = 0
    # tenancy plane (dynamo_tpu_torch/tenancy/): per-tenant admission budgets
    # over the waiting queue (0 = unbounded) and fair-share weights —
    # the same knobs as TorchEngine, so quota/fairness paths test on CPU
    tenant_max_waiting_requests: int = 0
    tenant_max_waiting_prefill_tokens: int = 0
    tenant_weights: Optional[dict] = None


@dataclass
class _MockRequest:
    req: PreprocessedRequest
    seq: TokenBlockSequence
    out: asyncio.Queue
    orig_prompt: list[int] = field(default_factory=list)  # pre-preemption
    pages: list[int] = field(default_factory=list)
    produced: int = 0
    last_token: int = -1
    cancelled: bool = False
    prefilling: bool = False
    enqueue_time: float = field(default_factory=time.monotonic)
    # forensics/timeline anchors (mocker-clock monotonic seconds)
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None

    # current (possibly restart-extended) prompt — kept separate from
    # req.token_ids so preemption never mutates the caller's request object
    prompt: list[int] = field(default_factory=list)
    # SFQ virtual finish stamp (tenancy fair share — same scheme as
    # TorchEngine._enqueue_waiting)
    vft: float = 0.0


class MockerEngine:
    """AsyncEngine-contract fake engine; single asyncio loop, no threads."""

    def __init__(
        self,
        args: Optional[MockerArgs] = None,
        *,
        on_kv_event: Optional[Callable[[KvCacheEvent], None]] = None,
        on_metrics: Optional[Callable[[ForwardPassMetrics], None]] = None,
        clock: Optional["Clock"] = None,
    ):
        from dynamo_tpu_torch.fleetsim.clock import REAL_CLOCK

        self.args = args or MockerArgs()
        self.on_metrics = on_metrics
        # every sim-visible timestamp (queue waits, deadlines, idle-beat
        # cadence, simulated prefill/decode sleeps) reads THIS clock, so
        # a fleetsim VirtualClock compresses the whole engine; the real
        # clock default keeps production behavior byte-identical
        self.clock = clock or REAL_CLOCK
        self.allocator = PageAllocator(
            self.args.num_pages,
            self.args.page_size,
            worker_id=self.args.worker_id,
            on_event=on_kv_event,
            enable_prefix_caching=self.args.enable_prefix_caching,
        )
        self._waiting: list[_MockRequest] = []
        self._active: list[_MockRequest] = []
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._draining = False
        self._last_idle_beat = 0.0
        self._step_due = float("-inf")   # when the last decode step was due
        self.step_count = 0
        self.tokens_generated = 0
        self.preemptions = 0
        # overload plane: bounded admission + deadline shedding, with a
        # load-derived Retry-After from recently observed queue waits
        from dynamo_tpu_torch.overload.admission import AdmissionController

        self._queue_waits: deque = deque(maxlen=32)
        # latency histograms on the SAME canonical ladders as the real
        # engine (fleet merge sums only identical ladders), shipped in
        # ForwardPassMetrics.histograms so fleet-feed / planner / bench
        # paths exercise on CPU; exemplars carry request ids
        self.telemetry = request_histograms(TelemetryRegistry(),
                                            engine=True)
        self._h_ttft = self.telemetry.get(tmetrics.TTFT[0])
        self._h_e2e = self.telemetry.get(tmetrics.E2E[0])
        self._h_queue = self.telemetry.get(tmetrics.QUEUE[0])
        self.admission = AdmissionController(
            self.args.max_waiting_requests,
            self.args.max_waiting_prefill_tokens,
            queue_wait_s=lambda: (
                sum(self._queue_waits) / len(self._queue_waits)
                if self._queue_waits else None
            ),
        )
        # tenancy plane: per-tenant budgets + tenant-sliced metrics,
        # mirroring TorchEngine so CPU tests exercise the same contract
        from dynamo_tpu_torch.tenancy import TenantQuotas

        self.tenant_quotas = TenantQuotas(
            self.args.tenant_max_waiting_requests,
            self.args.tenant_max_waiting_prefill_tokens,
            weights=self.args.tenant_weights,
        )
        # SFQ virtual clocks (same scheme as TorchEngine): per-tenant
        # finish stamps self-pace a storming tenant's backlog behind its
        # own stamps; single-tenant traffic degenerates to exact FIFO
        self._tenant_vnow: dict[str, float] = {}
        self._vclock = 0.0
        self.sheds = 0

    # ------------------------------------------------------------------
    # lifecycle

    def start(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop yet; generate() starts the task lazily
        if self._task is None or self._task.done():
            self._task = loop.create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def clear_kv_blocks(self) -> int:
        return self.allocator.clear()

    # ---- graceful drain (resilience/drain.py DrainController contract) --

    def begin_drain(self) -> None:
        self._draining = True

    def drained(self) -> bool:
        return self._draining and not self._active and not self._waiting

    # ------------------------------------------------------------------
    # AsyncEngine surface

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[LLMEngineOutput]:
        if self._draining:
            from dynamo_tpu_torch.resilience.drain import WorkerDrainingError

            raise WorkerDrainingError(
                "worker draining: not admitting new requests"
            )
        if self._task is None or self._task.done():
            self.start()
        if not request.token_ids:
            raise ValueError("empty prompt")
        tenant = getattr(request, "tenant", "") or "default"
        if (request.deadline is not None
                and self.clock.time() > request.deadline):
            from dynamo_tpu_torch.overload.metrics import OVERLOAD
            from dynamo_tpu_torch.tenancy import TENANT

            self.sheds += 1
            OVERLOAD.inc("dynamo_overload_shed_total")
            TENANT.inc("dynamo_tenant_shed_total", tenant)
            yield LLMEngineOutput(
                token_ids=[], finish_reason=FinishReason.DEADLINE,
                annotations={"shed": {"reason": "deadline",
                                      "queued_s": 0.0}},
            )
            return
        # the bound applies to EVERY priority class here: the mocker has
        # no waiting-entry preemption, so force-admitting high-priority
        # traffic would leave its queue unbounded (priority preemption
        # is a TorchEngine feature — see engine.py _enforce_bounds)
        if self.admission.bounded:
            from dynamo_tpu_torch.overload.metrics import OVERLOAD
            from dynamo_tpu_torch.tenancy import TENANT

            waiting = len(self._waiting)
            tokens = sum(len(w.prompt) for w in self._waiting)
            try:
                self.admission.check(waiting, tokens)
            except Exception:
                OVERLOAD.inc("dynamo_overload_rejected_total")
                TENANT.inc("dynamo_tenant_rejected_total", tenant)
                raise
        if self.tenant_quotas.bounded:
            from dynamo_tpu_torch.overload.metrics import OVERLOAD
            from dynamo_tpu_torch.tenancy import TENANT

            t_waiting = sum(1 for w in self._waiting
                            if self._tenant_of(w) == tenant)
            t_tokens = sum(len(w.prompt) for w in self._waiting
                           if self._tenant_of(w) == tenant)
            try:
                self.tenant_quotas.check(tenant, t_waiting, t_tokens)
            except Exception:
                OVERLOAD.inc("dynamo_overload_rejected_total")
                TENANT.inc("dynamo_tenant_rejected_total", tenant)
                raise
        from dynamo_tpu_torch.tenancy import TENANT as _TENANT

        _TENANT.inc("dynamo_tenant_admitted_total", tenant)
        r = _MockRequest(
            req=request,
            seq=TokenBlockSequence.from_tokens(
                request.token_ids, self.args.page_size, salt=request.model
            ),
            out=asyncio.Queue(),
            orig_prompt=list(request.token_ids),
            prompt=list(request.token_ids),
            enqueue_time=self.clock.monotonic(),
        )
        # weighted fair-share enqueue: stamp a virtual finish time and
        # insert before the first waiting entry with a larger stamp
        cost = max(1, len(request.token_ids))
        vft = (max(self._tenant_vnow.get(tenant, 0.0), self._vclock)
               + cost / self.tenant_quotas.weight(tenant))
        r.vft = vft
        self._tenant_vnow[tenant] = vft
        for i, wr in enumerate(self._waiting):
            # never jump a preempted restart (it holds produced tokens)
            if wr.produced == 0 and wr.vft > vft:
                self._waiting.insert(i, r)
                break
        else:
            self._waiting.append(r)
        self._wake.set()
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
            self._wake.set()

    @staticmethod
    def _tenant_of(r: _MockRequest) -> str:
        return getattr(r.req, "tenant", "") or "default"

    def tenant_debug(self) -> dict:
        """Same shape as TorchEngine.tenant_debug — tools/tenant_stats.py
        and the system server's /debug/tenants read either engine."""
        from dynamo_tpu_torch.tenancy import TENANT

        q = self.tenant_quotas
        tenants: dict[str, dict] = {}
        snap = TENANT.snapshot()
        qsnap = q.snapshot()
        names = ({self._tenant_of(w) for w in self._waiting}
                 | {self._tenant_of(w) for w in self._active}
                 | set(qsnap) | set(snap))
        for t in sorted(names):
            tenants[t] = {
                "waiting_requests": sum(
                    1 for w in self._waiting if self._tenant_of(w) == t),
                "waiting_prefill_tokens": sum(
                    len(w.prompt) for w in self._waiting
                    if self._tenant_of(w) == t),
                **qsnap.get(t, {}),
                "metrics": snap.get(t, {}),
            }
        return {
            "bounded": q.bounded,
            "max_waiting_requests": q.max_waiting_requests,
            "max_waiting_prefill_tokens": q.max_waiting_prefill_tokens,
            "n_adapters": 0,
            "tenants": tenants,
        }

    def metrics(self) -> ForwardPassMetrics:
        from dynamo_tpu_torch.tenancy import TENANT

        by_tenant: dict[str, list] = {}
        for w in self._waiting:
            by_tenant.setdefault(self._tenant_of(w), []).append(w)
        for t, ws in by_tenant.items():
            TENANT.set("dynamo_tenant_queue_depth", t, len(ws))
            TENANT.set("dynamo_tenant_queue_tokens", t,
                       sum(len(w.prompt) for w in ws))
        a = self.allocator
        return ForwardPassMetrics(
            worker_id=self.args.worker_id,
            worker_stats=WorkerStats(
                request_active_slots=len(self._active),
                request_total_slots=self.args.max_decode_slots,
                num_requests_waiting=len(self._waiting),
                num_waiting_prefill_tokens=sum(
                    len(w.prompt) for w in self._waiting
                ),
                max_waiting_requests=self.args.max_waiting_requests,
                max_waiting_prefill_tokens=(
                    self.args.max_waiting_prefill_tokens
                ),
            ),
            kv_stats=KvStats(
                kv_active_blocks=a.active_pages,
                kv_total_blocks=a.total_pages,
                gpu_cache_usage_perc=a.usage(),
                gpu_prefix_cache_hit_rate=a.hit_rate(),
            ),
            histograms={
                name: self.telemetry.get(name).snapshot()
                for name, _ in (tmetrics.TTFT, tmetrics.ITL,
                                tmetrics.E2E, tmetrics.QUEUE)
            },
        )

    # ------------------------------------------------------------------
    # simulated engine loop

    def _idle_beat(self) -> None:
        """Heartbeat while idle: the health plane's soft leases
        (resilience/health.py heartbeat_ttl_s) read metrics-stream
        silence as wedged, so an idle engine must keep publishing —
        same contract as TorchEngine's idle heartbeat."""
        if self.on_metrics is None:
            return
        now = self.clock.monotonic()
        if now - self._last_idle_beat >= 0.5:
            self._last_idle_beat = now
            self.on_metrics(self.metrics())

    async def _run(self) -> None:
        a = self.args
        self._last_idle_beat = 0.0
        while True:
            self._sweep_cancelled()
            self._admit()
            if not self._active:
                self._wake.clear()
                self._idle_beat()
                if not self._waiting:
                    # bounded park so the idle heartbeat keeps ticking.
                    # NOT asyncio.wait_for: on 3.10 a stop() cancel that
                    # races the wake future's completion is SWALLOWED by
                    # wait_for and the loop becomes uncancellable;
                    # asyncio.wait propagates outer cancellation always.
                    waiter = asyncio.ensure_future(self._wake.wait())
                    try:
                        # park timeout is 0.5s of ENGINE time (idle beats
                        # must keep their cadence under compression)
                        await asyncio.wait(
                            {waiter}, timeout=self.clock.to_wall(0.5)
                        )
                    finally:
                        if not waiter.done():
                            waiter.cancel()
                else:
                    # waiting but unadmittable (page pressure): idle-tick
                    await self.clock.sleep(
                        a.decode_time_per_step_s / a.speedup_ratio
                    )
                continue
            # one simulated decode step for the whole batch
            await self._step_wait(a.decode_time_per_step_s / a.speedup_ratio)
            self.step_count += 1
            for r in list(self._active):
                self._decode_one(r)
            if self.on_metrics is not None:
                self.on_metrics(self.metrics())

    async def _step_wait(self, step_s: float) -> None:
        """Sleep out one decode step, due one step after the previous one
        was due (the reference sleeps ``step_s`` from now): the loop's
        wake-up and bookkeeping no longer lengthen every step, so a busy
        host keeps the configured cadence (on an H100's host the relative
        sleep ran 9.14 ms steps at 11.3: NVIDIA H100 80GB HBM3, 700.00 W).
        A loop more than a step behind
        starts afresh rather than catching up in a burst."""
        now = self.clock.monotonic()
        due = self._step_due + step_s
        if due <= now:
            due = now + step_s if now - due >= step_s else due
        self._step_due = due
        await self.clock.sleep(due - now)

    def _sweep_cancelled(self) -> None:
        for r in list(self._active):
            if r.cancelled:
                self._release(r)
        self._waiting = [r for r in self._waiting if not r.cancelled]

    def _admit(self) -> None:
        a = self.args
        # deadline-aware shedding: drop still-WAITING requests whose
        # deadline passed (zero tokens, DEADLINE finish) — never one
        # that already produced output (preemption re-queues those)
        now = self.clock.time()
        kept = []
        for r in self._waiting:
            if (r.produced == 0 and not r.prefilling
                    and r.req.deadline is not None
                    and now > r.req.deadline):
                from dynamo_tpu_torch.overload.metrics import OVERLOAD

                self.sheds += 1
                OVERLOAD.inc("dynamo_overload_shed_total")
                r.out.put_nowait(LLMEngineOutput(
                    token_ids=[], finish_reason=FinishReason.DEADLINE,
                    annotations={"shed": {
                        "reason": "deadline",
                        "queued_s": round(
                            self.clock.monotonic() - r.enqueue_time, 3),
                    }},
                ))
            else:
                kept.append(r)
        self._waiting = kept
        while self._waiting and len(self._active) < a.max_decode_slots:
            r = self._waiting[0]
            ps = a.page_size
            hashes = r.seq.block_hashes()
            matched = self.allocator.match_prefix(
                hashes[: max(0, (len(r.prompt) - 1) // ps)]
            )
            n_pages = (len(r.prompt) + ps - 1) // ps
            if n_pages > min(self.allocator.total_pages, a.max_pages_per_seq):
                # can never fit: fail instead of blocking the queue forever
                self.allocator.free(matched)
                self._waiting.pop(0)
                r.out.put_nowait(ValueError("prompt does not fit page table"))
                continue
            fresh = self.allocator.allocate(n_pages - len(matched))
            if fresh is None:
                self.allocator.free(matched)
                return  # head-of-line blocks until space frees
            r.pages = matched + fresh
            r.prefilling = True
            r.admit_time = self.clock.monotonic()
            # the admitted stamp advances the global virtual clock, so
            # later arrivals can't be stamped into the served past
            self._vclock = max(self._vclock, r.vft)
            wait = r.admit_time - r.enqueue_time
            self._queue_waits.append(wait)
            self._h_queue.observe(
                wait, exemplar_id=r.req.request_id or None)
            from dynamo_tpu_torch.tenancy import TENANT

            t = self._tenant_of(r)
            self.tenant_quotas.note_queue_wait(t, wait)
            TENANT.observe("dynamo_tenant_request_queue_seconds", t, wait,
                           exemplar_id=r.req.request_id or None)
            self._waiting.pop(0)
            self._active.append(r)
            # simulated prefill cost for the non-cached suffix
            n_uncached = len(r.prompt) - len(matched) * ps
            delay = n_uncached * a.prefill_time_per_token_s / a.speedup_ratio
            # commit complete prompt blocks (prefix-shareable immediately)
            for blk in r.seq.blocks[len(matched):]:
                if blk.position < len(r.pages):
                    self.allocator.commit(
                        r.pages[blk.position], blk.block_hash, blk.parent_hash
                    )
            asyncio.get_running_loop().create_task(
                self._emit_first(r, delay)
            )

    async def _emit_first(self, r: _MockRequest, delay: float) -> None:
        if delay > 0:
            await self.clock.sleep(delay)
        r.prefilling = False
        if r.cancelled or r not in self._active:
            return  # preempted mid-prefill; readmission re-schedules
        self._emit_token(r, self._next_token(r))

    def _next_token(self, r: _MockRequest) -> int:
        # derived from the ORIGINAL prompt + absolute step index, so the
        # stream is identical regardless of preemption/restart scheduling
        p = r.orig_prompt
        return p[(r.produced + len(p)) % len(p)]

    def _decode_one(self, r: _MockRequest) -> None:
        a = self.args
        if r not in self._active:
            return  # preempted/released earlier in this same round
        if r.prefilling or r.produced == 0:
            return  # still in simulated prefill
        # seal/commit the block completed by the previous emitted token;
        # clear last_token afterwards so a preemption between sealing and
        # the next emission doesn't re-append it to the restart prompt
        if r.last_token >= 0:
            for blk in r.seq.extend([r.last_token]):
                if blk.position < len(r.pages):
                    self.allocator.commit(
                        r.pages[blk.position], blk.block_hash, blk.parent_hash
                    )
            r.last_token = -1
        # grow the page table for the next position; total context derives
        # from the ORIGINAL prompt (preemption folds generated tokens into
        # r.prompt, but produced already counts them)
        total = len(r.orig_prompt) + r.produced
        need_pages = total // a.page_size + 1
        while len(r.pages) < min(need_pages, a.max_pages_per_seq):
            got = self.allocator.allocate(1)
            if got is None:
                if not self._try_preempt(exclude=r):
                    self._preempt(r)
                    return
                continue
            r.pages.extend(got)
        self._emit_token(r, self._next_token(r))

    def _lp_fields(self, r: _MockRequest, tok: int) -> dict:
        """Synthetic-but-shaped logprobs when the request asks for them —
        lets HTTP-level logprob plumbing be tested without a real model."""
        n = r.req.output_options.logprobs
        if n is None:
            return {}
        pairs = [[tok + i, -0.1 - 1.0 * i] for i in range(max(int(n), 1))]
        return {"log_probs": [-0.1], "top_logprobs": [pairs[: int(n)]]}

    def _finish_annotations(self, r: _MockRequest) -> dict:
        """Timing + worker trace spans for the finishing output — the
        same annotation shapes TorchEngine._final_annotations ships, so
        the frontend's forensics/request-stats paths join mocker
        requests identically (span starts anchored off the shared
        clock's monotonic->wall offset)."""
        now_m = self.clock.monotonic()
        now_w = self.clock.time()

        def wall(t_mono: float) -> float:
            return round(now_w - (now_m - t_mono), 6)

        e2e = now_m - r.enqueue_time
        self._h_e2e.observe(e2e, exemplar_id=r.req.request_id or None)
        timing: dict = {"e2e_s": round(e2e, 6),
                        "output_tokens": r.produced}
        spans: list[dict] = []
        if r.admit_time is not None:
            q = r.admit_time - r.enqueue_time
            timing["queue_s"] = round(q, 6)
            spans.append({"name": "queue", "start_s": wall(r.enqueue_time),
                          "duration_s": round(q, 6), "attrs": {}})
        if r.first_token_time is not None:
            timing["ttft_s"] = round(r.first_token_time - r.enqueue_time, 6)
            if r.admit_time is not None:
                spans.append({
                    "name": "prefill", "start_s": wall(r.admit_time),
                    "duration_s": round(
                        r.first_token_time - r.admit_time, 6),
                    "attrs": {"tokens": len(r.orig_prompt)},
                })
            spans.append({
                "name": "decode", "start_s": wall(r.first_token_time),
                "duration_s": round(now_m - r.first_token_time, 6),
                "attrs": {"tokens": r.produced},
            })
        return {"timing": timing, "trace": {"spans": spans}}

    def _emit_token(self, r: _MockRequest, tok: int) -> None:
        sc = r.req.stop_conditions
        if r.produced == 0:
            r.first_token_time = self.clock.monotonic()
            self._h_ttft.observe(
                r.first_token_time - r.enqueue_time,
                exemplar_id=r.req.request_id or None)
            from dynamo_tpu_torch.tenancy import TENANT

            TENANT.observe(
                "dynamo_tenant_request_ttft_seconds", self._tenant_of(r),
                r.first_token_time - r.enqueue_time,
                exemplar_id=r.req.request_id or None)
        r.produced += 1
        self.tokens_generated += 1
        hit_eos = (
            not sc.ignore_eos
            and tok in (sc.stop_token_ids or [])
            and (sc.min_tokens is None or r.produced >= sc.min_tokens)
        )
        if hit_eos:
            r.out.put_nowait(
                LLMEngineOutput(token_ids=[], finish_reason=FinishReason.EOS,
                                annotations=self._finish_annotations(r))
            )
            self._release(r)
            return
        r.last_token = tok
        if sc.max_tokens is not None and r.produced >= sc.max_tokens:
            r.out.put_nowait(
                LLMEngineOutput(
                    token_ids=[tok], finish_reason=FinishReason.LENGTH,
                    annotations=self._finish_annotations(r),
                    **self._lp_fields(r, tok),
                )
            )
            self._release(r)
            return
        r.out.put_nowait(
            LLMEngineOutput(token_ids=[tok], **self._lp_fields(r, tok))
        )

    def _release(self, r: _MockRequest) -> None:
        self.allocator.free(r.pages)
        r.pages = []
        if r in self._active:
            self._active.remove(r)

    def _try_preempt(self, exclude: Optional[_MockRequest] = None) -> bool:
        """Preempt the most recently admitted active request (LIFO, like the
        engine and the reference mocker's eviction of the youngest)."""
        victims = [r for r in self._active if r is not exclude and r.produced > 0]
        if not victims:
            return False
        self._preempt(max(victims, key=lambda r: r.enqueue_time))
        return True

    def _preempt(self, victim: _MockRequest) -> None:
        self.preemptions += 1
        self.allocator.free(victim.pages)
        victim.pages = []
        new_prompt = victim.seq.tokens + (
            [victim.last_token] if victim.last_token >= 0 else []
        )
        victim.prompt = new_prompt
        victim.seq = TokenBlockSequence.from_tokens(
            new_prompt, self.args.page_size, salt=victim.req.model
        )
        victim.last_token = -1
        if victim in self._active:
            self._active.remove(victim)
        self._waiting.insert(0, victim)
