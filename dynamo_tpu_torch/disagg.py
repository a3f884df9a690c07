"""Disaggregated prefill/decode (a copy of the JAX package's disagg.py;
reference disagg_router.rs:25-120, examples/llm/components/
prefill_worker.py:157-211, utils/prefill_queue.py:27-49).

A decode worker that receives a request decides, against a store-watched
threshold and the depth of the global prefill queue, whether to prefill
locally or to enqueue a RemotePrefillRequest; a prefill worker pops it,
runs the prefill, and streams the KV pages into the decode worker's
pre-allocated pages over the block-transfer plane (kv_transfer.py) as
the prefill advances. The decode worker commits the pages under their
chained block hashes, so its engine's ordinary admission matches them as
a prefix hit and computes only the sub-page tail: the engine stays
disagg-unaware, and any failure or timeout falls back to a local prefill,
counted in ``remote_fallbacks`` and ``dynamo_disagg_fallback_total``.

The prefill queue and the done notifications ride the store's durable
FIFO queues. Job and config JSON are the JAX package's, so either
package's prefill worker takes the other's jobs.

The decode wrapper passes a graceful drain through to its engine and
refuses a draining request before the remote-prefill decision; the
``stall_stream`` chaos point wedges a prefill worker's chunk push (the
decode side's timeout then falls back to a local prefill).

Left out: the ``remote_prefill``/``kv_chunk``/``disagg_kv_transfer`` spans
and the stream timeline (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.kv_transfer import (
    PageStreamWriter,
    get_descriptor,
    write_remote_pages,
)
from dynamo_tpu_torch.kv_transfer_metrics import KV_TRANSFER
from dynamo_tpu_torch.resilience.chaos import CHAOS
from dynamo_tpu_torch.resilience.drain import WorkerDrainingError
from dynamo_tpu_torch.protocols.common import (
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger(__name__)


def disagg_conf_key(namespace: str) -> str:
    return f"dynamo://{namespace}/_disagg/conf"


def prefill_queue_name(namespace: str) -> str:
    return f"{namespace}.prefill"


def prefill_done_queue(namespace: str, request_id: str) -> str:
    return f"{namespace}.prefill_done.{request_id}"


@dataclass
class DisaggConfig:
    """Store-watched disagg thresholds (DisaggRouterConf,
    disagg_router.rs:25-35)."""

    max_local_prefill_length: int = 512
    max_prefill_queue_size: int = 16

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "DisaggConfig":
        return cls(**json.loads(s))


async def set_disagg_config(kv: KvClient, namespace: str,
                            conf: DisaggConfig) -> None:
    await kv.put(disagg_conf_key(namespace), conf.to_json())


class DisaggConfigWatcher:
    """Live view of the disagg config (disagg_router.rs:38-120). A missing
    key reads as the defaults."""

    def __init__(self, kv: KvClient, namespace: str,
                 default: Optional[DisaggConfig] = None):
        self.kv = kv
        self.namespace = namespace
        self.current = default or DisaggConfig()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "DisaggConfigWatcher":
        watch = await self.kv.watch_prefix(disagg_conf_key(self.namespace))
        for _, v, _ in watch.initial:
            self._apply(v)
        self._task = asyncio.get_running_loop().create_task(
            self._follow(watch))
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _follow(self, watch) -> None:
        async for ev in watch:
            if ev.get("event") == "put":
                self._apply(ev.get("value"))

    def _apply(self, value: Optional[str]) -> None:
        if not value:
            return
        try:
            self.current = DisaggConfig.from_json(value)
            log.info("disagg config updated: %s", self.current)
        except (ValueError, TypeError):
            log.warning("bad disagg config value ignored: %r", value)


@dataclass
class RemotePrefillRequest:
    """One prefill job on the queue (worker.py:187-196): the tokens, and
    which of the decode worker's pages to fill (blocks first_block ..
    first_block + len(dst_pages) of the prompt's chained blocks)."""

    request_id: str
    token_ids: list[int]
    salt: str                      # block-hash salt (= the model name)
    dst_worker_id: str             # blockset descriptor key in the store
    dst_pages: list[int]           # decode-side pre-allocated page ids
    first_block: int
    done_queue: str
    # unix time after which the decode side has given up (local
    # fallback): workers drop expired jobs. 0 = never expires
    expires_at: float = 0.0

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "RemotePrefillRequest":
        return cls(**json.loads(s))


# ---------------------------------------------------------------------------
# prefill worker


class PrefillWorker:
    """Consumes the prefill queue: prefills locally and STREAMS the KV
    pages into the decode worker's pool chunk by chunk while the prefill
    still computes, then notifies on the done queue.

    The engine commits complete prompt blocks after every prefill chunk
    (TorchEngine._seal_prefilled) and fires its commit event; this worker
    subscribes to it and exports and ships each new run of blocks as a
    stream frame, so the transfer rides behind compute and host staging
    is O(chunk). ``commit_wakeups`` and ``timeout_wakeups`` count what
    woke the stream. With ``kv_transfer_chunk_pages == 0`` in the
    engine's config, the prefill runs whole and its pages go as one
    write.

    One prefill runs at a time, so each is a group of one as in the
    reference's serial loop; the next job is popped as soon as the
    current job's prefill has ended, while its pages may still be on the
    wire (a queue of jobs no longer waits out each job's transfer)."""

    def __init__(self, rt: DistributedRuntime, engine: Any,
                 namespace: str = "dynamo", poll_timeout_s: float = 1.0,
                 stream_poll_s: float = 0.002):
        self.rt = rt
        self.engine = engine
        self.namespace = namespace
        self.poll_timeout_s = poll_timeout_s
        # cadence of the committed-prefix poll while prefill runs without
        # a commit event, and the unit of the safety timeout with one
        self.stream_poll_s = stream_poll_s
        self.jobs_handled = 0
        self.jobs_failed = 0
        self.jobs_expired = 0
        self.commit_wakeups = 0
        self.timeout_wakeups = 0
        self._commit_evt: Optional[asyncio.Event] = None
        self._commit_cb: Optional[Any] = None
        # chunk-pipeline figures: transfer seconds spent while the
        # prefill was STILL computing count as hidden
        self.chunks_streamed = 0
        self.transfer_seconds_total = 0.0
        self.transfer_seconds_hidden = 0.0
        # cross-host clock-skew grace before a job counts as expired
        self.expiry_skew_s = 5.0
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        # set while no job's prefill runs; jobs whose pages still stream
        self._prefill_idle = asyncio.Event()
        self._prefill_idle.set()
        self._jobs: set[asyncio.Task] = set()

    @property
    def transfer_overlap_ratio(self) -> Optional[float]:
        if self.transfer_seconds_total <= 0:
            return None
        return self.transfer_seconds_hidden / self.transfer_seconds_total

    async def start(self) -> "PrefillWorker":
        start = getattr(self.engine, "start", None)
        if start is not None:
            start()
        subscribe = getattr(self.engine, "subscribe_commits", None)
        if subscribe is not None:
            # the engine thread's commit event, bounced to this loop
            loop = asyncio.get_running_loop()
            evt = asyncio.Event()
            self._commit_evt = evt

            def on_commit() -> None:
                loop.call_soon_threadsafe(evt.set)

            self._commit_cb = on_commit
            subscribe(on_commit)
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self) -> None:
        self._stopping = True
        if self._commit_cb is not None:
            unsub = getattr(self.engine, "unsubscribe_commits", None)
            if unsub is not None:
                unsub(self._commit_cb)
            self._commit_cb = None
        for task in [self._task, *self._jobs]:
            if task is not None:
                task.cancel()
        self._task = None

    async def _wait_progress(self, gen_task, pending_task) -> None:
        """Park until the committed prefix may have grown: the engine's
        commit event (a commit fired between waits stays latched in the
        Event), the prefill or export task finishing, or a safety timeout
        of 5x the poll cadence, at least 10 ms (a lost edge costs about
        one round). Without a commit event, the fixed-cadence sleep."""
        if self._commit_evt is None:
            await asyncio.sleep(self.stream_poll_s)
            return
        if gen_task.done():
            # every block is committed: only the export in flight moves
            # this stream (the commit event is left to the next job's
            # prefill)
            if pending_task is not None:
                await asyncio.wait({pending_task}, timeout=max(
                    self.stream_poll_s * 5, 0.01))
            return
        evt_task = asyncio.ensure_future(self._commit_evt.wait())
        wait_set = {evt_task}
        for t in (gen_task, pending_task):
            if t is not None and not t.done():
                wait_set.add(t)
        done, _ = await asyncio.wait(
            wait_set, timeout=max(self.stream_poll_s * 5, 0.01),
            return_when=asyncio.FIRST_COMPLETED)
        if evt_task in done:
            self.commit_wakeups += 1
            self._commit_evt.clear()
        else:
            # leave the latch alone: a commit that fired while a task
            # woke us must wake the NEXT wait at once
            evt_task.cancel()
            if not done:
                self.timeout_wakeups += 1

    async def _loop(self) -> None:
        queue = prefill_queue_name(self.namespace)
        while not self._stopping:
            await self._prefill_idle.wait()
            try:
                raw = await self.rt.kv.qpop(queue,
                                            timeout_s=self.poll_timeout_s)
            except (ConnectionError, OSError):
                await asyncio.sleep(0.5)
                continue
            if raw is None:
                continue
            try:
                job = RemotePrefillRequest.from_json(raw)
            except (ValueError, TypeError):
                log.warning("malformed prefill job dropped: %.200r", raw)
                continue
            if job.expires_at and time.time() > (job.expires_at
                                                 + self.expiry_skew_s):
                # the decode side already fell back: skip the wasted
                # prefill and the done-queue push nobody pops
                self.jobs_expired += 1
                log.info("dropping expired prefill job %s", job.request_id)
                continue
            self._prefill_idle.clear()
            task = asyncio.get_running_loop().create_task(self._run(job))
            self._jobs.add(task)
            task.add_done_callback(self._jobs.discard)

    async def _run(self, job: RemotePrefillRequest) -> None:
        released = False

        def release() -> None:
            """This job's prefill has ended (or never started): once."""
            nonlocal released
            if not released:
                released = True
                self._prefill_idle.set()

        try:
            await self._handle(job, release)
            self.jobs_handled += 1
        except Exception as e:  # noqa: BLE001 — report, keep consuming
            self.jobs_failed += 1
            log.exception("prefill job %s failed", job.request_id)
            try:
                await self.rt.kv.qpush(job.done_queue, json.dumps(
                    {"ok": False, "error": str(e)}))
            except (ConnectionError, OSError):
                pass
        finally:
            release()

    async def _handle(self, job: RemotePrefillRequest,
                      release=lambda: None) -> None:
        t0 = time.monotonic()
        ps = self.engine.ecfg.page_size
        n_blocks = job.first_block + len(job.dst_pages)
        seq = TokenBlockSequence.from_tokens(job.token_ids, ps, salt=job.salt)
        hashes = seq.block_hashes()[:n_blocks]
        chunk_pages = int(getattr(self.engine.ecfg,
                                  "kv_transfer_chunk_pages", 0))

        # the prefill through the engine (one sampled token, discarded:
        # the decode side samples its own first token after its tail
        # prefill); the engine commits each chunk's complete blocks AS
        # PREFILL ADVANCES
        req = PreprocessedRequest(token_ids=list(job.token_ids),
                                  model=job.salt)
        req.stop_conditions.max_tokens = 1
        req.stop_conditions.ignore_eos = True

        async def run_prefill() -> None:
            try:
                async for _ in self.engine.generate(req):
                    pass
            finally:
                release()  # the next job may start its prefill

        # the descriptor BEFORE prefill: the stream starts mid-compute
        desc = await get_descriptor(self.rt.kv, self.namespace,
                                    job.dst_worker_id)
        if desc is None:
            raise RuntimeError(
                f"no blockset descriptor for {job.dst_worker_id}")
        chunks = 1
        overlap: Optional[float] = None
        if chunk_pages <= 0:
            n_send = await self._push_monolithic(job, hashes, run_prefill,
                                                 desc)
        else:
            n_send, chunks, overlap = await self._push_stream(
                job, hashes, run_prefill, desc, chunk_pages)
        msg: dict[str, Any] = {
            "ok": True, "blocks": n_send, "chunks": chunks,
            "prefill_ms": (time.monotonic() - t0) * 1e3,
        }
        if overlap is not None:
            msg["overlap_ratio"] = round(overlap, 4)
        await self.rt.kv.qpush(job.done_queue, json.dumps(msg))
        log.info("remote prefill %s: %d tokens, %d blocks (%d chunks) -> %s "
                 "in %.1f ms (overlap %s)", job.request_id,
                 len(job.token_ids), n_send, chunks, job.dst_worker_id,
                 msg["prefill_ms"],
                 f"{overlap:.2f}" if overlap is not None else "n/a")

    async def _push_monolithic(self, job: RemotePrefillRequest,
                               hashes: list[int], run_prefill, desc) -> int:
        """``kv_transfer_chunk_pages == 0``: the whole prefill, one
        gather, one blob on the wire."""
        await run_prefill()
        src_pages = self.engine.allocator.match_prefix(hashes)
        try:
            # under cache pressure some blocks may already be evicted:
            # send the contiguous run still held from first_block on
            have = src_pages[job.first_block:]
            n_send = min(len(have), len(job.dst_pages))
            if n_send == 0:
                raise RuntimeError("prefilled blocks evicted before export")
            data = await asyncio.to_thread(self.engine.export_pages,
                                           have[:n_send])
        finally:
            self.engine.allocator.free(src_pages)
        await write_remote_pages(desc.host, desc.port,
                                 job.dst_pages[:n_send], data,
                                 job_id=job.request_id)
        return n_send

    async def _push_stream(
        self, job: RemotePrefillRequest, hashes: list[int], run_prefill,
        desc, chunk_pages: int,
    ) -> tuple[int, int, Optional[float]]:
        """Chunk-pipelined push: follow the committed prefix while the
        prefill runs; export and ship every newly complete run of
        ``chunk_pages`` blocks as one stream frame (a sub-chunk remainder
        goes once prefill finishes). The decode side scatters each frame
        on arrival and acks at eof. Returns (blocks sent, chunks, overlap
        ratio)."""
        first = job.first_block
        n_blocks = len(hashes)
        alloc = self.engine.allocator
        gen_task = asyncio.get_running_loop().create_task(run_prefill())
        writer = PageStreamWriter(desc.host, desc.port,
                                  job_id=job.request_id)
        sent = first                   # blocks written to the wire
        chunks = 0
        xfer_total = 0.0
        xfer_hidden = 0.0
        evicted = False
        # the sender's double buffer: one export dispatched beyond the
        # chunk being written, so the gather and copy of run i+1 overlap
        # run i's wire drain. (lo, hi, t_start, task)
        pending: Optional[tuple] = None
        t_pf_end: Optional[float] = None  # first observation of done
        try:
            while True:
                prefill_done = gen_task.done()
                if prefill_done:
                    if t_pf_end is None:
                        t_pf_end = time.monotonic()
                    await gen_task  # surface prefill failures
                avail = min(alloc.cached_prefix_len(hashes), n_blocks)
                exported_to = pending[1] if pending is not None else sent
                if (pending is None and not evicted
                        and (avail - exported_to >= chunk_pages
                             or (prefill_done and avail > exported_to))):
                    hi = min(exported_to + chunk_pages, avail)
                    pending = (exported_to, hi, time.monotonic(),
                               asyncio.ensure_future(self._export_run(
                                   hashes, exported_to, hi)))
                    continue
                if pending is not None and pending[3].done():
                    lo, hi, tc, task = pending
                    pending = None
                    data = await task
                    if data is None:
                        evicted = True  # evicted under pressure mid-stream
                        continue
                    # dispatch the NEXT export before awaiting this
                    # chunk's drain: that order is the double buffer
                    avail = min(alloc.cached_prefix_len(hashes), n_blocks)
                    if (avail - hi >= chunk_pages
                            or (gen_task.done() and avail > hi)):
                        hi2 = min(hi + chunk_pages, avail)
                        pending = (hi, hi2, time.monotonic(),
                                   asyncio.ensure_future(self._export_run(
                                       hashes, hi, hi2)))
                    await writer.write_chunk(
                        job.dst_pages[lo - first: hi - first], data)
                    dur = time.monotonic() - tc
                    xfer_total += dur
                    if t_pf_end is None:
                        xfer_hidden += dur  # the whole hop behind compute
                    else:
                        # a straddling hop: the part before prefill ended
                        xfer_hidden += min(dur, max(0.0, t_pf_end - tc))
                    chunks += 1
                    sent = hi
                    # mid-stream chaos (stall_stream): a wedged link; the
                    # decode side's timeout must fire and fall back
                    await CHAOS.maybe_stall("stall_stream",
                                            writer.chunks_sent)
                    continue
                if pending is None and (evicted
                                        or (prefill_done and avail <= sent)):
                    break
                await self._wait_progress(
                    gen_task, pending[3] if pending is not None else None)
            if sent <= first:
                raise RuntimeError("prefilled blocks evicted before export")
            # drain() returns when the KERNEL has the bytes, not the peer;
            # the eof ack comes once the receiver read and scattered every
            # chunk, so the commit wait is the wire's tail: count it
            t_commit = time.monotonic()
            await writer.commit()
            tail = time.monotonic() - t_commit
            xfer_total += tail
            if t_pf_end is None:
                xfer_hidden += tail
            else:
                xfer_hidden += min(tail, max(0.0, t_pf_end - t_commit))
        finally:
            if pending is not None:
                pending[3].cancel()
            await writer.close()
            if not gen_task.done():
                gen_task.cancel()
            elif not gen_task.cancelled():
                gen_task.exception()  # retrieved, never left unread
        self.chunks_streamed += chunks
        self.transfer_seconds_total += xfer_total
        self.transfer_seconds_hidden += xfer_hidden
        overlap = xfer_hidden / xfer_total if xfer_total > 0 else None
        return sent - first, chunks, overlap

    async def _export_run(self, hashes: list[int], lo: int, hi: int):
        """Pin and gather blocks [lo, hi) of the chained run; None when
        the run is no longer fully committed (evicted under pressure).
        The gather goes through export_pages_stream: the engine loop
        dispatches it with an asynchronous copy and goes on running
        prefill while the copy completes (this worker thread waits on the
        chunk queue)."""

        def pin_and_export():
            pages = self.engine.allocator.match_prefix(hashes[:hi])
            try:
                if len(pages) < hi:
                    return None
                return next(iter(self.engine.export_pages_stream(
                    pages[lo:hi], chunk_pages=hi - lo)))
            finally:
                self.engine.allocator.free(pages)

        return await asyncio.to_thread(pin_and_export)


# ---------------------------------------------------------------------------
# decode-side wrapper


class DisaggDecodeEngine:
    """An engine wrapper with the conditional-disagg decision in front of
    a TorchEngine (worker.py:199-248):

    remote iff  (prompt_len - cached_prefix_tokens) > max_local_prefill_length
            and prefill_queue_len < max_prefill_queue_size

    On the remote path the transferred blocks enter the local prefix
    cache before intake, so the wrapped engine computes only the sub-page
    tail. It delegates ``allocator``, ``on_metrics``, ``start``, ``stop``,
    ``metrics`` and the drain contract, so register_llm serves it as the
    engine."""

    def __init__(self, engine: Any, rt: DistributedRuntime,
                 namespace: str = "dynamo", worker_id: str = "",
                 conf: Optional[DisaggConfigWatcher] = None,
                 prefill_timeout_s: float = 60.0):
        self.engine = engine
        self.rt = rt
        self.namespace = namespace
        self.worker_id = worker_id
        self.conf = conf
        self.prefill_timeout_s = prefill_timeout_s
        # live remote-prefill jobs: a write for a job not in here is
        # REJECTED (a stale job must not scribble over pages freed on
        # fallback and given to another request). The lock guards only
        # the sets, never device I/O; a fallback racing an in-flight
        # write leaves the page free to the writer
        self._jobs_lock = threading.Lock()
        self._pending_jobs: set[str] = set()
        self._in_write: set[str] = set()
        self._deferred_free: dict[str, list[int]] = {}
        self.remote_prefills = 0
        self.local_prefills = 0
        self.remote_fallbacks = 0
        self.last_transfer_chunks = 0
        self.last_overlap_ratio: Optional[float] = None
        # the last remote job's done message (blocks, chunks, prefill_ms,
        # overlap_ratio)
        self.last_done: Optional[dict] = None
        self._draining = False

    @property
    def allocator(self):
        return self.engine.allocator

    @property
    def on_metrics(self):
        return self.engine.on_metrics

    @on_metrics.setter
    def on_metrics(self, sink):
        self.engine.on_metrics = sink

    def start(self) -> None:
        start = getattr(self.engine, "start", None)
        if start is not None:
            start()

    # graceful-drain passthrough (resilience/drain.py contract): the
    # wrapper keeps its own flag so generate() refuses BEFORE the
    # remote-prefill decision; a draining worker would otherwise pay a
    # whole cross-worker KV transfer for a request it then refuses
    def begin_drain(self) -> None:
        self._draining = True
        begin = getattr(self.engine, "begin_drain", None)
        if begin is not None:
            begin()

    def drained(self) -> bool:
        fn = getattr(self.engine, "drained", None)
        return bool(fn()) if fn is not None else True

    async def stop(self) -> None:
        await self.engine.stop()

    def metrics(self):
        return self.engine.metrics()

    def guarded_import(self, pages, data, job_id=None) -> None:
        """The transfer server's write hook: scatter only while the job
        is pending. The scatter runs OUTSIDE the jobs lock (holding it
        across the engine's import would stall the event loop's own
        acquisitions for the whole transfer)."""
        if job_id is None:
            self.engine.import_pages(pages, data)
            return
        with self._jobs_lock:
            if job_id not in self._pending_jobs:
                raise RuntimeError(f"job {job_id} cancelled; write rejected")
            self._in_write.add(job_id)
        try:
            self.engine.import_pages(pages, data)
        finally:
            with self._jobs_lock:
                self._in_write.discard(job_id)
                late_free = self._deferred_free.pop(job_id, None)
            if late_free is not None:
                # the fallback cancelled the job mid-write: the write
                # landed in pages still held for it; release them now
                self.engine.allocator.free(late_free)

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[LLMEngineOutput]:
        if self._draining:
            raise WorkerDrainingError(
                "worker draining: not admitting new requests")
        if await self._maybe_remote_prefill(request):
            self.remote_prefills += 1
        else:
            self.local_prefills += 1
        async for out in self.engine.generate(request):
            yield out

    async def _should_remote(self, request: PreprocessedRequest,
                             n_cached_blocks: int) -> bool:
        conf = self.conf.current if self.conf else DisaggConfig()
        ps = self.engine.ecfg.page_size
        effective = len(request.token_ids) - n_cached_blocks * ps
        if effective <= conf.max_local_prefill_length:
            return False
        try:
            qlen = await self.rt.kv.qlen(prefill_queue_name(self.namespace))
        except (ConnectionError, OSError):
            return False
        return qlen < conf.max_prefill_queue_size

    async def _maybe_remote_prefill(self, request: PreprocessedRequest
                                    ) -> bool:
        """Try the remote path; True if the prefix cache was warmed
        remotely. Any failure falls back to local prefill, counted."""
        alloc = self.engine.allocator
        ps = self.engine.ecfg.page_size
        tokens = request.token_ids
        n_blocks = max(0, (len(tokens) - 1) // ps)
        if n_blocks == 0:
            return False
        seq = TokenBlockSequence.from_tokens(tokens, ps, salt=request.model)
        hashes = seq.block_hashes()[:n_blocks]
        # blocks cached locally need no transfer (a peek that counts no
        # hit: the engine's admission match does the counted lookup)
        m = alloc.cached_prefix_len(hashes)
        if not await self._should_remote(request, m):
            return False
        if m >= n_blocks:
            return False
        dst = alloc.allocate(n_blocks - m)
        if dst is None:
            return False  # no room: admission deals with it
        rid = request.request_id
        done_q = prefill_done_queue(self.namespace, rid)
        job = RemotePrefillRequest(
            request_id=rid, token_ids=list(tokens), salt=request.model,
            dst_worker_id=self.worker_id, dst_pages=dst, first_block=m,
            done_queue=done_q,
            expires_at=time.time() + self.prefill_timeout_s)
        with self._jobs_lock:
            self._pending_jobs.add(rid)
        settled = False  # the success path committed and freed dst
        try:
            await self.rt.kv.qpush(prefill_queue_name(self.namespace),
                                   job.to_json())
            raw = await self.rt.kv.qpop(done_q,
                                        timeout_s=self.prefill_timeout_s)
            resp = json.loads(raw) if raw else None
            if not resp or not resp.get("ok"):
                raise RuntimeError((resp or {}).get(
                    "error", "remote prefill timed out"))
            n_got = int(resp.get("blocks", 0))
            self.last_transfer_chunks = int(resp.get("chunks", 1))
            self.last_overlap_ratio = resp.get("overlap_ratio")
            self.last_done = resp
            with self._jobs_lock:
                self._pending_jobs.discard(rid)
            # the transferred blocks under their chained hashes: the
            # engine's admission prefix match picks them up
            committed = []
            for pg, blk in zip(dst[:n_got], seq.blocks[m:m + n_got]):
                if alloc.commit(pg, blk.block_hash, blk.parent_hash):
                    committed.append(pg)
            alloc.free(dst)  # committed pages park in the LRU, the rest free
            settled = True
            return bool(committed)
        except Exception:  # noqa: BLE001 — disagg is best-effort, counted
            self.remote_fallbacks += 1
            KV_TRANSFER.inc("dynamo_disagg_fallback_total")
            log.exception("remote prefill failed for %s; local fallback", rid)
            return False
        finally:
            if not settled:
                # the except path and CancelledError (the client dropped
                # while awaiting the done queue): cancel the job and free
                # its pages once; a guarded write in flight frees them
                # after its scatter
                with self._jobs_lock:
                    self._pending_jobs.discard(rid)
                    if rid in self._in_write:
                        self._deferred_free[rid] = dst
                        dst = None
                if dst is not None:
                    alloc.free(dst)
