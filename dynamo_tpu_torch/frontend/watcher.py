"""Model discovery: watch registrations, build chains, update the manager
(the port's copy of the JAX package's frontend/watcher.py; reference
lib/llm/src/discovery/watcher.rs:187-300 ModelWatcher).

Model entries live at ``dynamo://{namespace}/_models/{model_name}/
{lease_id}`` (value: JSON ModelEntry, the JAX package's format) and
worker instances under the component prefix the entry names, so either
package's workers and frontends discover each other through one store.

``register_llm`` (reference lib/bindings/python rust/lib.rs:134) is the
worker-side half: serve the engine endpoint, put the model entry, and
publish the allocator's KV events and the engine's load metrics.

A ``kv`` entry is served through a ``KvPushRouter`` (kv_router/): the
watcher follows the ``kv_events.>`` plane into the indexer of the router
that owns each worker (events that race a worker's discovery wait in a
bounded buffer and replay when it appears), and the ``load_metrics.>``
plane into one health tracker and one load view shared by every model's
router; both freeze while the control-plane session is degraded.
``round_robin`` and ``random`` entries are served through a
``RemoteEngine``.

What the port's frontend refuses, and does not register (a request for
such a model gets 404): an entry that names a checkpoint (``model_path``
or ``card_ref``: the port has no tokenizer for a model directory yet,
ROADMAP Queue 1 item 9; serving it through the test tokenizer would
answer differently). Left out of the KV path: the fleet view and the
prefetch controller (item 6), the shared breaker board and heartbeat
TTLs (item 5), and the fleet-merged latency feed (item 10).
"""
from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Optional

from dynamo_tpu_torch.backend import Backend
from dynamo_tpu_torch.frontend.model_manager import ModelChain, ModelManager
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
)
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
from dynamo_tpu_torch.overload.load import WorkerLoadView
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor, PromptFormatter
from dynamo_tpu_torch.resilience.health import WorkerHealthTracker
from dynamo_tpu_torch.runtime.component import DistributedRuntime, Instance
from dynamo_tpu_torch.runtime.publisher import (
    KV_EVENTS_TOPIC,
    METRICS_TOPIC,
    KvEventPublisher,
    WorkerMetricsPublisher,
)
from dynamo_tpu_torch.runtime.remote_engine import (
    RemoteEngine,
    RemoteWorkerEngine,
    serve_engine,
)
from dynamo_tpu_torch.tokenizer import Tokenizer, make_test_tokenizer

log = logging.getLogger(__name__)

MODEL_PREFIX = "_models/"
# how often a KV-routed worker republishes its whole cache (the pub/sub
# plane is lossy; the reference's register_llm default)
KV_RESYNC_INTERVAL_S = 60.0
# KV events of a worker the frontend has not discovered yet: how many wait,
# and how long before one is dropped as belonging to a worker that will
# never be claimed (departed, or a model this frontend does not route)
UNCLAIMED_EVENTS = 4096
UNCLAIMED_TTL_S = 30.0


def model_key(namespace: str, name: str) -> str:
    return f"dynamo://{namespace}/{MODEL_PREFIX}{name}"


@dataclass
class ModelEntry:
    """What a worker publishes about a model (reference
    discovery/ModelEntry + model_card basics)."""

    name: str
    namespace: str
    component: str
    endpoint: str = "generate"
    model_type: str = "chat"          # chat | completions | both
    block_size: int = 64              # router block size (must match engine)
    router_mode: str = "kv"           # kv | round_robin | random
    # minimal card payload: tokenizer/template source directory, context len
    model_path: Optional[str] = None
    context_length: Optional[int] = None
    # object-store bucket holding the card artifacts
    card_ref: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "ModelEntry":
        return cls(**json.loads(s))


async def register_llm(
    rt: DistributedRuntime,
    engine: Any,
    entry: ModelEntry,
    *,
    lease_ttl_s: float = 5.0,
):
    """Worker-side: serve the engine + publish the model entry. Entries are
    per-instance keys suffixed with the lease id, so the model vanishes
    exactly when the last instance's lease dies. For a KV-routed model the
    allocator's KV events are published under the instance's lease id
    (the id routers use as the worker key), with a periodic resync of the
    whole cache; the engine's load metrics are published either way."""
    ep = rt.namespace(entry.namespace).component(entry.component).endpoint(
        entry.endpoint
    )
    served = await serve_engine(
        ep, engine, worker_id=entry.name, lease_ttl_s=lease_ttl_s,
        metadata={"model": entry.name},
    )
    key = model_key(entry.namespace, entry.name) + f"/{served.lease_id}"
    await rt.kv.put(key, entry.to_json(), lease=served.lease_id)

    allocator = getattr(engine, "allocator", None)
    # resync sessions re-grant a lost lease under a NEW id when the old one
    # can't be reclaimed; everything keyed by lease id follows the rekey
    on_rekey: Optional[list] = getattr(served.lease, "on_rekey", None)
    # only KV-routed models have indexers consuming these events;
    # publishing for others just pollutes the event plane
    if entry.router_mode == "kv" and allocator is not None:
        pub = KvEventPublisher(rt.kv, str(served.lease_id))
        pub.start()
        allocator.worker_id = str(served.lease_id)
        allocator.on_event = pub
        served.kv_publisher = pub
        if on_rekey is not None:
            def _rekey_kv(old: int, new: int,
                          pub=pub, allocator=allocator) -> None:
                wid = str(new)
                # rekey() also rewrites payloads already queued under the
                # old id, so none go out on the new topic mis-attributed
                pub.rekey(wid, f"{KV_EVENTS_TOPIC}.{wid}")
                allocator.worker_id = wid

            on_rekey.append(_rekey_kv)
        # periodic authoritative resync: the pub/sub plane is lossy
        # (slow consumers drop), and a dropped STORED would otherwise
        # skew routing until the worker restarts
        async def resync_loop():
            while True:
                await asyncio.sleep(KV_RESYNC_INTERVAL_S)
                try:
                    events = allocator.snapshot_stored_events()
                    # all-or-nothing: a CLEARED whose STORED batches
                    # get dropped by a full queue would ERASE correct
                    # routing state instead of healing it. This loop
                    # runs on the publisher's own loop, so the
                    # capacity check + enqueue burst is atomic wrt
                    # other (call_soon_threadsafe) producers.
                    free = pub.queue.maxsize - pub.queue.qsize()
                    if free < len(events):
                        log.warning(
                            "kv resync skipped: publisher backlog "
                            "(%d free < %d events)", free, len(events)
                        )
                        continue
                    for ev in events:
                        pub(ev)  # stamps worker_id, same as live path
                except Exception:  # noqa: BLE001 — keep resyncing
                    log.exception("kv resync failed")

        served.kv_resync_task = asyncio.get_running_loop().create_task(
            resync_loop()
        )
    # load-metrics plane (a KV router's load view, the planner)
    if hasattr(engine, "on_metrics"):
        mpub = WorkerMetricsPublisher(rt.kv, str(served.lease_id))
        mpub.start()
        engine.on_metrics = mpub
        served.metrics_publisher = mpub
        if on_rekey is not None:
            def _rekey_metrics(old: int, new: int, mpub=mpub) -> None:
                wid = str(new)
                mpub.rekey(wid, f"{METRICS_TOPIC}.{wid}")

            on_rekey.append(_rekey_metrics)
    return served


def refusal(entry: ModelEntry) -> Optional[str]:
    """Why the port's frontend does not serve this entry, or None."""
    if entry.model_path or entry.card_ref:
        return ("a checkpoint's tokenizer (model_path / card_ref) is not "
                "ported yet (ROADMAP Queue 1 item 9)")
    if entry.router_mode not in ("kv", "round_robin", "random"):
        return f"unknown router_mode {entry.router_mode!r}"
    return None


class ModelWatcher:
    """Frontend-side: reconcile the ModelManager with discovered models."""

    def __init__(
        self,
        rt: DistributedRuntime,
        manager: ModelManager,
        namespace: str = "dynamo",
        router_config: Optional[KvRouterConfig] = None,
        kv_recorder: Optional[Any] = None,  # KvRecorder: tees kv_events
        tokenizer: Optional[Tokenizer] = None,
    ):
        self.rt = rt
        self.manager = manager
        self.namespace = namespace
        self.router_config = router_config
        self.kv_recorder = kv_recorder
        # every discovered model's tokenizer: the test tokenizer, as the
        # JAX package's watcher uses for an entry without a checkpoint
        # (programmatic callers may pass another, as to build_chain)
        self.tokenizer = tokenizer
        # one health tracker shared by every model's router (per-worker
        # circuit breakers, heartbeats off the load-metrics plane) and one
        # live queue-depth view (routing spills away from saturating
        # workers), fed by the same metrics subscription
        self.health = WorkerHealthTracker()
        self.load = WorkerLoadView()
        self._task: Optional[asyncio.Task] = None
        self._kv_sub_task: Optional[asyncio.Task] = None
        self._metrics_sub_task: Optional[asyncio.Task] = None
        self._models: dict[str, dict[int, ModelEntry]] = {}  # name -> lease -> entry
        self._chains: dict[str, Any] = {}
        self._routers: dict[str, KvPushRouter] = {}
        # KV events that raced worker discovery, replayed on sync
        self._unclaimed_events: deque = deque(maxlen=UNCLAIMED_EVENTS)
        # models whose entries the port does not serve: name -> reason
        self.refused: dict[str, str] = {}

    async def start(self) -> "ModelWatcher":
        prefix = f"dynamo://{self.namespace}/{MODEL_PREFIX}"
        watch = await self.rt.kv.watch_prefix(prefix)
        for k, v, _ in watch.initial:
            try:
                await self._apply("put", k, v)
            except Exception:  # noqa: BLE001 — one bad snapshot entry
                # must not abort frontend startup (the _follow loop has
                # the same protection for live events)
                log.exception("model watcher failed applying snapshot %s", k)
        loop = asyncio.get_running_loop()
        self._task = loop.create_task(self._follow(watch))
        self._kv_sub_task = loop.create_task(self._follow_kv_events())
        self._metrics_sub_task = loop.create_task(self._follow_metrics())
        # degraded-mode serving: when the control-plane session loses its
        # store, freeze the health/load views (stale-while-revalidate —
        # keep routing off the last-known fleet picture) instead of aging
        # every worker out while the metrics stream is paused
        add_listener = getattr(self.rt.kv, "add_state_listener", None)
        if add_listener is not None:
            def _on_store_state(degraded: bool) -> None:
                if degraded:
                    self.health.freeze()
                    self.load.freeze()
                else:
                    self.health.thaw()
                    self.load.thaw()

            add_listener(_on_store_state)
        return self

    async def stop(self) -> None:
        for t in (self._task, self._kv_sub_task, self._metrics_sub_task):
            if t is not None:
                t.cancel()
        self._task = self._kv_sub_task = self._metrics_sub_task = None
        for name in list(self._chains):
            await self._remove_model(name)

    async def _follow(self, watch) -> None:
        async for ev in watch:
            try:
                await self._apply(ev["event"], ev["key"], ev.get("value"))
            except Exception:  # noqa: BLE001
                log.exception("model watcher failed applying %s", ev)

    async def _follow_kv_events(self) -> None:
        """Feed worker KV events into the indexer of the router that OWNS
        that worker (reference: NATS kv_events subject -> KvIndexer).
        Broadcast-to-all would accumulate unbounded foreign-worker state in
        every model's indexer; events for a not-yet-discovered worker wait
        in a bounded buffer and are replayed when the worker appears."""
        sub = await self.rt.kv.subscribe(f"{KV_EVENTS_TOPIC}.>")
        async for ev in sub:
            try:
                event = KvCacheEvent.from_dict(json.loads(ev["value"]))
            except (KeyError, ValueError, TypeError):
                continue
            if self.kv_recorder is not None:
                try:
                    self.kv_recorder(event)
                except Exception:  # noqa: BLE001 — a debug feature must
                    # never take down routing; disable and keep going
                    log.exception("kv recorder failed; disabling recording")
                    self.kv_recorder = None
            self._route_kv_event(event)

    async def _follow_metrics(self) -> None:
        """Tap on the load-metrics plane: every worker publication is a
        heartbeat in the shared health tracker and a reading of its queue
        in the shared load view."""
        sub = await self.rt.kv.subscribe(f"{METRICS_TOPIC}.>")
        async for ev in sub:
            try:
                m = ForwardPassMetrics.from_dict(json.loads(ev["value"]))
            except (KeyError, ValueError, TypeError):
                continue
            self.health.observe_metrics(m)
            self.load.observe(m)

    def _route_kv_event(self, event: KvCacheEvent, *,
                        buffer_unclaimed: bool = True) -> bool:
        """Apply to EVERY router owning the worker (a legacy untagged
        instance can be in several models' routers). Returns claimed."""
        claimed = False
        for router in self._routers.values():
            if event.worker_id in router.workers:
                router.router.indexer.apply_event(event)
                claimed = True
        if not claimed and buffer_unclaimed:
            # worker not discovered yet (event raced registration): buffer
            self._unclaimed_events.append((time.monotonic(), event))
        return claimed

    def _replay_unclaimed(self) -> None:
        """Called after a router gains workers: re-route buffered events.
        Entries older than the TTL are dropped — they belong to workers
        that will never be claimed (departed, or non-kv models), and must
        not evict genuinely raced events."""
        if not self._unclaimed_events:
            return
        now = time.monotonic()
        pending, self._unclaimed_events = self._unclaimed_events, deque(
            maxlen=self._unclaimed_events.maxlen
        )
        for ts, event in pending:
            if now - ts > UNCLAIMED_TTL_S:
                continue
            if not self._route_kv_event(event, buffer_unclaimed=False):
                self._unclaimed_events.append((ts, event))

    async def _apply(self, event: str, key: str, value: Optional[str]) -> None:
        # key: dynamo://{ns}/_models/{name}/{lease_id}
        tail = key.rsplit(MODEL_PREFIX, 1)[-1]
        if "/" not in tail:
            return
        name, lease_s = tail.rsplit("/", 1)
        try:
            lease_id = int(lease_s)
        except ValueError:
            if lease_s != "static":
                return
            lease_id = 0  # llmctl static registration (no lease)
        entries = self._models.setdefault(name, {})
        if event == "put" and value is not None:
            entry = ModelEntry.from_json(value)
            entries[lease_id] = entry
            if name not in self._chains and name not in self.refused:
                why = refusal(entry)
                if why is None:
                    await self._add_model(name, entry)
                else:
                    self.refused[name] = why
                    log.warning("model %s not served by this frontend: %s",
                                name, why)
        elif event == "delete":
            entries.pop(lease_id, None)
            if not entries:
                self._models.pop(name, None)
                self.refused.pop(name, None)
                if name in self._chains:
                    await self._remove_model(name)

    async def _add_model(self, name: str, entry: ModelEntry) -> None:
        log.info("model %s discovered (%s/%s)", name, entry.component,
                 entry.endpoint)
        client = await self.rt.namespace(entry.namespace).component(
            entry.component
        ).endpoint(entry.endpoint).client()
        if entry.router_mode == "kv":
            router = KvRouter(entry.block_size, self.router_config)
            push = KvPushRouter(router, health=self.health, load=self.load)
            self._routers[name] = push

            def sync_workers(instances: list[Instance], push=push,
                             client=client, name=name):
                # instances carry their model in metadata: two models
                # sharing a component must not route into each other's
                # workers (legacy instances without the tag serve any
                # model)
                instances = [
                    i for i in instances
                    if i.metadata.get("model", name) == name
                ]
                current = {str(i.id) for i in instances}
                for wid in list(push.workers):
                    if wid not in current:
                        push.remove_worker(wid)
                added = False
                for inst in instances:
                    wid = str(inst.id)
                    if wid not in push.workers:
                        push.add_worker(wid,
                                        RemoteWorkerEngine(client, inst.id))
                        added = True
                if added:
                    self._replay_unclaimed()

            client.on_change = sync_workers
            sync_workers(list(client.instances.values()))
            engine: Any = push
        else:
            # as sync_workers: route only to this model's instances
            client.instance_filter = (
                lambda inst, name=name:
                inst.metadata.get("model", name) == name
            )
            engine = RemoteEngine(client, mode=entry.router_mode)
        tok = self.tokenizer or make_test_tokenizer()
        chain = ModelChain(
            name=name,
            preprocessor=OpenAIPreprocessor(
                tokenizer=tok, formatter=PromptFormatter(), model_name=name,
                context_length=entry.context_length,
            ),
            engine=engine,
            backend=Backend(tok),
            chat=entry.model_type in ("chat", "both"),
            completions=entry.model_type in ("completions", "both", "chat"),
        )
        self._chains[name] = (chain, client)
        self.manager.register(chain)

    async def _remove_model(self, name: str) -> None:
        log.info("model %s removed (last instance gone)", name)
        chain_client = self._chains.pop(name, None)
        self._routers.pop(name, None)
        self.manager.unregister(name)
        if chain_client is not None:
            await chain_client[1].stop()
