"""KV-aware router: pick the worker with the warmest prefix, stream from it
(the port's copy of the JAX package's kv_router/router.py).

Parity: reference kv_router.rs — KvRouter (:100) find_best_match;
KvPushRouter (:242-304) wraps routing as an AsyncEngine: choose a worker,
annotate the request with ``estimated_prefix_hit_num_blocks``, direct-route,
track generated tokens per request (push) and free on completion.

Workers are anything with the AsyncEngine ``generate()`` contract — local
engines or remote endpoint clients from the distributed runtime.

Resilience (dynamo_tpu_torch/resilience/): routing consults a per-worker
circuit-breaker tracker; a worker unreachable before the first token is
evicted and the request re-routes; a worker dying MID-STREAM triggers live
migration — the request is rebuilt as prompt + emitted tokens and replayed
as a prefill on a healthy worker, with exactly-once token delivery (greedy
output is token-identical to an uninterrupted run).

Overload: a worker that refuses admission (``EngineOverloadedError``) is
healthy: the request spills to the next-best peer with no breaker
strike, and the load view cools the worker down for its Retry-After. A
``PreemptedError`` (a running request evicted by a higher-priority one)
is a deliberate act of a healthy worker too: no breaker strike, no
eviction; the request re-routes, or migrates once it has streamed. The
endpoint wire types only overload, so a remote preemption arrives as a
retriable connection error and counts as a failure, as in the JAX
package.

Left out: the request-trace spans (``route``, ``migrate``,
``overload_bounce``) come with telemetry, ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import logging
import time
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.kv_router.indexer import KvIndexer, WorkerId
from dynamo_tpu_torch.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvRouterConfig,
    KvScheduler,
    KVHitRateEvent,
    NoEndpoints,
    SchedulingRequest,
)
from dynamo_tpu_torch.kv_router.sequence import ActiveSequencesMultiWorker
from dynamo_tpu_torch.overload.errors import (
    EngineOverloadedError,
    PreemptedError,
)
from dynamo_tpu_torch.overload.load import WorkerLoadView
from dynamo_tpu_torch.overload.metrics import OVERLOAD
from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.resilience.health import WorkerHealthTracker
from dynamo_tpu_torch.resilience.metrics import RESILIENCE
from dynamo_tpu_torch.resilience.migration import (
    MigrationPolicy,
    build_replay_request,
)
from dynamo_tpu_torch.resilience.policy import RetryPolicy
from dynamo_tpu_torch.runtime.remote_engine import invoke_clear
from dynamo_tpu_torch.tokens import TokenBlockSequence

log = logging.getLogger(__name__)


class KvRouter:
    """Scoring core: indexer + per-worker active-sequence prediction +
    softmax scheduler."""

    def __init__(
        self,
        block_size: int,
        config: Optional[KvRouterConfig] = None,
        on_hit_rate: Optional[Callable[[KVHitRateEvent], None]] = None,
    ):
        self.block_size = block_size
        self.indexer = KvIndexer(
            block_size,
            freq_halflife_s=(
                config.freq_halflife_s if config is not None else None
            ),
        )
        self.sequences = ActiveSequencesMultiWorker(block_size, [])
        self.scheduler = KvScheduler(
            block_size,
            selector=DefaultWorkerSelector(config),
            on_hit_rate=on_hit_rate,
        )

    def update_workers(self, worker_ids: list[WorkerId]) -> None:
        self.sequences.update_workers(worker_ids)

    def find_best_match(
        self,
        request_id: str,
        tokens: list[int],
        salt: str = "",
        exclude: Optional[set[WorkerId]] = None,
    ) -> tuple[WorkerId, int]:
        """(worker_id, overlap_blocks). Registers the request against the
        chosen worker's predicted active set (kv_router.rs:178-214).
        ``exclude`` drops workers from consideration (dead/tripped workers
        during re-route and migration); raises NoEndpoints when nothing
        remains — the caller decides whether to relax the exclusion."""
        seq = TokenBlockSequence.from_tokens(tokens, self.block_size, salt=salt)
        overlap = self.indexer.find_matches(seq.block_hashes())
        candidates = self.sequences.worker_ids()
        if exclude:
            candidates = [w for w in candidates if w not in exclude]
        req = SchedulingRequest(
            isl_tokens=len(tokens),
            overlap=overlap,
            potential_blocks=self.sequences.potential_blocks(seq),
        )
        worker, overlap_blocks = self.scheduler.schedule(candidates, req)
        self.sequences.add_request(request_id, worker, seq)
        return worker, overlap_blocks

    def push(self, request_id: str, token: int) -> None:
        self.sequences.push(request_id, token)

    def free(self, request_id: str) -> None:
        self.sequences.free(request_id)


class KvPushRouter:
    """AsyncEngine wrapper: route + stream + per-token tracking
    (kv_router.rs:242-304), plus the resilience plane: breaker-aware
    worker selection, pre-first-token re-route, and mid-stream migration
    with exactly-once token delivery, and the overload plane's spill."""

    def __init__(
        self,
        router: KvRouter,
        workers: Optional[dict[WorkerId, Any]] = None,
        *,
        health: Optional[WorkerHealthTracker] = None,
        migration: Optional[MigrationPolicy] = None,
        retry: Optional[RetryPolicy] = None,
        load: Optional[WorkerLoadView] = None,
    ):
        self.router = router
        self.workers: dict[WorkerId, Any] = workers or {}
        self.health = health or WorkerHealthTracker()
        # overload plane: live queue-depth/budget view fed by the
        # metrics plane + wire-observed overload bounces — routing
        # steers AWAY from saturating workers (spill-before-shed)
        self.load = load or WorkerLoadView()
        self.migration = migration or MigrationPolicy()
        # backoff between failover attempts (small base: failover latency
        # is client-visible TTFT)
        self.retry = retry or RetryPolicy(
            max_attempts=8, base_delay_s=0.05, max_delay_s=1.0
        )
        self.migrations = 0       # replays dispatched (instance-local)
        self.reroutes = 0         # pre-first-token re-routes
        # observability hook: called with the wall seconds each successful
        # routing decision took (a decision-latency probe; None = no
        # overhead on the hot path)
        self.on_decision: Optional[Callable[[float], None]] = None
        self.router.update_workers(list(self.workers))

    def add_worker(self, worker_id: WorkerId, engine: Any) -> None:
        self.workers[worker_id] = engine
        self.router.update_workers(list(self.workers))

    def remove_worker(self, worker_id: WorkerId) -> None:
        self.workers.pop(worker_id, None)
        self.router.update_workers(list(self.workers))
        self.router.indexer.remove_worker(worker_id)
        self.health.forget(worker_id)
        self.load.forget(worker_id)

    async def clear_kv_blocks(self) -> int:
        """Fan /clear_kv_blocks out to every routed worker and drop their
        indexer state (the radix view is now stale by construction)."""
        total = 0
        for wid, engine in list(self.workers.items()):
            clear = getattr(engine, "clear_kv_blocks", None)
            if clear is None:
                continue
            try:
                total += await invoke_clear(clear)
            except Exception:  # noqa: BLE001 — best-effort per worker
                log.warning("clear_kv_blocks failed on worker %s",
                            wid, exc_info=True)
                continue
            self.router.indexer.remove_worker(wid)
        return total

    def _route(
        self, rid: str, cur: PreprocessedRequest, tried: set[WorkerId]
    ) -> tuple[WorkerId, int]:
        """One routing decision: exclude workers already tried for this
        request, workers the health plane blocks (tripped breakers), AND
        workers the overload plane would steer away from (published
        queue budget saturated, live bounce cooldown, or — for a deadline-carrying request — an estimated
        queue wait that can't meet the deadline). Exclusions relax in
        reverse order of confidence when they empty the candidate list —
        availability beats precision; overload hints first (the worker
        will shed what it must), then breakers; the dead ones stay
        excluded via ``tried``. Raises NoEndpoints when no worker is
        routable at all."""
        workers = list(self.workers)
        blocked = self.health.blocked(workers)
        overloaded = self.load.blocked(
            workers, deadline=getattr(cur, "deadline", None)
        )
        stages = [tried | blocked | overloaded]
        if overloaded:
            stages.append(tried | blocked)
        if blocked:
            stages.append(tried)
        last = len(stages) - 1
        for i, exclude in enumerate(stages):
            try:
                worker, overlap = self.router.find_best_match(
                    rid, cur.token_ids, salt=cur.model, exclude=exclude,
                )
            except NoEndpoints:
                if i == last:
                    raise
                continue
            # (spills are counted at the BOUNCE, not here: whether the
            # proactive exclusion changed THIS decision's outcome is
            # unknowable without re-running the scheduler, and counting
            # every route made while any worker cools down would
            # overstate the storm)
            return worker, overlap
        raise NoEndpoints("no routable worker")  # unreachable

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[LLMEngineOutput]:
        """Route + stream, surviving worker failure at any point:

        - Unreachable before the first token: the worker is evicted (its
          warm-prefix blocks leave the indexer so they stop attracting
          traffic for the rest of the lease window) and the request
          re-routes to the next-best worker.
        - Died MID-STREAM: live migration — the request is rebuilt as
          prompt + tokens-emitted-so-far and replayed as a prefill on a
          healthy worker (excluding every worker already tried). The
          replay prompt suppresses the already-delivered suffix by
          construction, so the client receives each token exactly once
          and greedy output is token-identical to an uninterrupted run.
          The failed worker is NOT evicted here (it may be alive but
          degraded — chaos, stall); the breaker and lease plane decide
          its fate.
        """
        rid = request.request_id
        emitted: list[int] = []
        tried: set[WorkerId] = set()
        cur = request
        route_attempts = max(1, len(self.workers))
        # migration budget is evaluated at FAILURE time against the
        # fleet as it is then — workers added after this request started
        # (scale-up mid-stream) are valid migration targets
        migrations_used = 0
        last_err: Optional[BaseException] = None
        attempt = 0
        while attempt < route_attempts + self.migration.max_migrations:
            if not self.workers:
                break
            if attempt > 0:
                await self.retry.sleep(attempt - 1)
            t_route = time.monotonic()
            try:
                worker_id, overlap = self._route(rid, cur, tried)
            except NoEndpoints:
                break
            if self.on_decision is not None:
                self.on_decision(time.monotonic() - t_route)
            cur.estimated_prefix_hit_num_blocks = overlap
            engine = self.workers.get(worker_id)
            if engine is None:  # scheduler raced a removal
                self.router.free(rid)
                self.remove_worker(worker_id)  # purge sequences + indexer too
                continue
            log.debug(
                "routing %s to %s (overlap %d blocks)", rid, worker_id, overlap
            )
            # consume the half-open probe grant (if any) for the worker
            # the request actually dispatches to
            self.health.on_routed(worker_id)
            attempt += 1
            streamed = False
            finish_seen = False
            try:
                async for out in engine.generate(cur):
                    for tok in out.token_ids:
                        self.router.push(rid, tok)
                        emitted.append(tok)
                    streamed = True
                    if out.finish_reason is not None:
                        finish_seen = True
                    yield out
                self.health.record_success(worker_id)
                return
            except EngineOverloadedError as e:
                # overload bounce: the worker refused ADMISSION, so no
                # tokens exist to lose — spill to the next-best peer.
                # The worker is healthy (it answered!), so no breaker
                # strike and no eviction; the load view just cools it
                # down for exactly the window it asked for.
                last_err = e
                if streamed:
                    raise  # can't happen (admission is pre-stream)
                tried.add(worker_id)
                self.load.note_overloaded(
                    worker_id, getattr(e, "retry_after_s", 1.0)
                )
                OVERLOAD.inc("dynamo_overload_router_spills_total")
                log.info(
                    "worker %s overloaded; spilling %s to a peer "
                    "(retry_after %.2fs)",
                    worker_id, rid, getattr(e, "retry_after_s", 1.0),
                )
                continue
            except (ConnectionError, OSError) as e:
                last_err = e
                # PreemptedError is a DELIBERATE act of a healthy worker (a
                # higher-priority request took the lane): no breaker
                # strike, never evict the worker; the request just moves
                # elsewhere (excluded through ``tried``)
                preempted = isinstance(e, PreemptedError)
                if not preempted:
                    self.health.record_failure(worker_id)
                tried.add(worker_id)
                if finish_seen:
                    # the finish output was already delivered — the worker
                    # died between it and the stream close. The request is
                    # COMPLETE; migrating would regenerate past the stop
                    # point and push tokens after a finish chunk.
                    log.warning(
                        "worker %s died after finishing %s; stream complete",
                        worker_id, rid,
                    )
                    return
                if not streamed:
                    if preempted:
                        # nothing emitted yet: the request re-routes as
                        # it is, and the worker stays in the fleet
                        log.info("worker %s preempted %s before its first "
                                 "token; re-routing", worker_id, rid)
                        continue
                    log.warning(
                        "worker %s unreachable (%s); evicting and "
                        "re-routing %s", worker_id, e, rid,
                    )
                    self.reroutes += 1
                    RESILIENCE.inc("dynamo_resilience_reroute_total")
                    self.remove_worker(worker_id)
                    if not self.workers:
                        raise
                    continue
                # ---- mid-stream: live migration ----
                if (not self.migration.enabled
                        or migrations_used
                        >= self.migration.budget(len(self.workers))):
                    RESILIENCE.inc("dynamo_migration_failed_total")
                    raise
                migrations_used += 1
                replay = build_replay_request(request, emitted)
                if replay is None:
                    # token budget already delivered: the uninterrupted
                    # run would finish with LENGTH right here — close the
                    # stream instead of replaying a zero-token tail
                    yield LLMEngineOutput(
                        token_ids=[], finish_reason=FinishReason.LENGTH,
                    )
                    return
                self.migrations += 1
                RESILIENCE.inc("dynamo_migration_total")
                RESILIENCE.inc(
                    "dynamo_migration_replayed_tokens_total", len(emitted)
                )
                log.warning(
                    "worker %s died mid-stream (%s); migrating %s "
                    "(%d tokens replayed as prefill)",
                    worker_id, e, rid, len(emitted),
                )
                cur = replay
            finally:
                self.router.free(rid)
        if emitted:
            RESILIENCE.inc("dynamo_migration_failed_total")
        if isinstance(last_err, EngineOverloadedError) and not emitted:
            # every worker bounced admission: the FLEET is overloaded —
            # surface the typed, retriable error (frontend: 429 +
            # Retry-After) instead of a generic connection failure
            raise EngineOverloadedError(
                f"all workers overloaded for request {rid}",
                retry_after_s=last_err.retry_after_s,
                # a per-tenant quota bounce keeps its tenant key through
                # the fleet-wide re-raise (frontend slices 429s by it)
                tenant=getattr(last_err, "tenant", ""),
            ) from last_err
        raise ConnectionError(
            f"no reachable worker for request {rid}"
        ) from last_err
