"""Model discovery: watch registrations, build chains, update the manager
(the port's copy of the JAX package's frontend/watcher.py; reference
lib/llm/src/discovery/watcher.rs:187-300 ModelWatcher).

Model entries live at ``dynamo://{namespace}/_models/{model_name}/
{lease_id}`` (value: JSON ModelEntry, the JAX package's format) and
worker instances under the component prefix the entry names, so either
package's workers and frontends discover each other through one store.

``register_llm`` (reference lib/bindings/python rust/lib.rs:134) is the
worker-side half: serve the engine endpoint, put the model entry, publish
the allocator's KV events and the engine's load metrics, and (for an
engine with ``apply_fleet_hints``) take the fleet controller's hint and
prefetch payloads off ``kv_fleet.{lease_id}``.

A ``kv`` entry is served through a ``KvPushRouter`` (kv_router/): the
watcher follows the ``kv_events.>`` plane into the indexer of the router
that owns each worker (events that race a worker's discovery wait in a
bounded buffer and replay when it appears), and the ``load_metrics.>``
plane into one health tracker and one load view shared by every model's
router; both freeze while the control-plane session is degraded.
``round_robin`` and ``random`` entries are served through a
``RemoteEngine``.

An entry that names a checkpoint is served with that checkpoint's
tokenizer and chat template: ``register_llm`` uploads the model card
(model_card.py) when the entry has a ``model_path``, and the frontend
reads the directory itself when it shares the filesystem, else downloads
the card (cached per ``card_ref``); a card that fails to load is logged
and the model served with the test tokenizer, as the reference does. The
port's frontend refuses (and does not register: a request for such a
model gets 404) only an entry with an unknown ``router_mode``. With
``heartbeat_ttl_s`` a worker whose metrics go
silent is blocked before its lease expires, and a SharedBreakerBoard
(resilience/shared.py) exchanges breaker trips with sibling frontends
over the store. Each KV-routed model gets a FleetKvView over its
router's indexer (``fleet_views``, served at ``/debug/kv_fleet``) and,
with a ``prefetch_config``, a KvPrefetchController that publishes hints
and hot prefixes to its workers over the store. Every worker metrics
publication also folds its latency histograms into the fleet-merged feed
(telemetry/fleet_feed.py FLEET_FEED, the frontend's dynamo_fleet_*
families).
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Optional

from dynamo_tpu_torch.backend import Backend
from dynamo_tpu_torch.frontend.model_manager import ModelChain, ModelManager
from dynamo_tpu_torch.kv_router.fleet import FleetKvView
from dynamo_tpu_torch.kv_router.prefetch import (
    KV_FLEET_TOPIC,
    KvPrefetchController,
    PrefetchConfig,
)
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
)
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
from dynamo_tpu_torch.overload.load import WorkerLoadView
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor, PromptFormatter
from dynamo_tpu_torch.resilience.health import WorkerHealthTracker
from dynamo_tpu_torch.resilience.shared import SharedBreakerBoard
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
from dynamo_tpu_torch.telemetry.fleet_feed import FLEET_FEED
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
    whole cache, and an engine with ``apply_fleet_hints`` takes the fleet
    controller's hint and prefetch payloads off ``kv_fleet.{lease_id}``
    (one bad payload is logged, not fatal; the loop stops with
    ``served.shutdown``); the engine's load metrics are published either
    way."""
    ep = rt.namespace(entry.namespace).component(entry.component).endpoint(
        entry.endpoint
    )
    # upload card artifacts so remote frontends can tokenize (model.rs:256)
    if entry.model_path and entry.card_ref is None:
        from dynamo_tpu_torch.model_card import upload_card

        try:
            entry.card_ref = await upload_card(
                rt.kv, entry.namespace, entry.name, entry.model_path
            )
        except (ConnectionError, OSError):
            log.warning("card upload failed for %s; frontends must share "
                        "the filesystem", entry.name)
    served = await serve_engine(
        ep, engine, worker_id=entry.name, lease_ttl_s=lease_ttl_s,
        metadata={"model": entry.name},
    )
    allocator = getattr(engine, "allocator", None)
    fleet_sub = None
    if (entry.router_mode == "kv" and allocator is not None
            and hasattr(engine, "apply_fleet_hints")):
        # subscribed as soon as the lease id is known: a frontend sees
        # the instance from here on, and a warm-start push that arrives
        # before the subscription would be lost
        fleet_sub = await rt.kv.subscribe(
            f"{KV_FLEET_TOPIC}.{served.lease_id}")
    key = model_key(entry.namespace, entry.name) + f"/{served.lease_id}"
    await rt.kv.put(key, entry.to_json(), lease=served.lease_id)

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
    if fleet_sub is not None:
        # the fleet prefix economy: the frontend controller's hint digests
        # and prefetch pushes (kv_router/prefetch.py publishes them on
        # kv_fleet.{worker_id} for workers it cannot call in-process)
        async def fleet_loop(sub=fleet_sub, wid=str(served.lease_id)):
            async for ev in sub:
                try:
                    msg = json.loads(ev["value"])
                except (KeyError, ValueError, TypeError):
                    continue
                try:
                    if msg.get("hints") is not None:
                        engine.apply_fleet_hints(msg["hints"])
                    pf = msg.get("prefetch")
                    if pf and hasattr(engine, "prefetch_hashes"):
                        await engine.prefetch_hashes(
                            [int(h) for h in pf.get("hashes", [])],
                            parents=[
                                int(p) for p in pf.get("parents", [])
                            ] or None,
                        )
                except Exception:  # noqa: BLE001 — one bad payload must
                    # not end fleet-hint delivery
                    log.exception("fleet payload failed for %s", wid)

        served.kv_fleet_task = asyncio.get_running_loop().create_task(
            fleet_loop())
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
        heartbeat_ttl_s: Optional[float] = None,
        # the fleet replication controller of each KV-routed model (None:
        # the reactive G4 path only)
        prefetch_config: Optional[PrefetchConfig] = None,
        engine_factory: Optional[Any] = None,  # (client, Instance) -> engine
    ):
        self.rt = rt
        self.manager = manager
        self.namespace = namespace
        self.router_config = router_config
        self.kv_recorder = kv_recorder
        self.prefetch_config = prefetch_config
        # fleet simulator hook (fleetsim/sim.py): a KV-routed model's
        # router reaches in-process engines, keyed by the instance found
        # in the store, instead of a RemoteWorkerEngine TCP client per
        # worker. None: the serving path
        self.engine_factory = engine_factory
        # the tokenizer of a model without a checkpoint: the test
        # tokenizer, as the JAX package's watcher uses (programmatic
        # callers may pass another, as to build_chain)
        self.tokenizer = tokenizer
        # downloaded model cards by card_ref
        self._card_dirs: dict[str, str] = {}
        # one health tracker shared by every model's router (per-worker
        # circuit breakers, heartbeats off the load-metrics plane, blocking
        # a worker silent for ``heartbeat_ttl_s``: engines publish on idle
        # ticks too, so silence means wedged) and one live queue-depth
        # view (routing spills away from saturating workers), fed by the
        # same metrics subscription
        self.health = WorkerHealthTracker(heartbeat_ttl_s=heartbeat_ttl_s)
        self.load = WorkerLoadView()
        # breaker trips observed here publish on the store's pub/sub plane
        # so sibling frontends stop routing to the dead worker too
        self._breaker_board: Optional[SharedBreakerBoard] = None
        self._task: Optional[asyncio.Task] = None
        self._kv_sub_task: Optional[asyncio.Task] = None
        self._metrics_sub_task: Optional[asyncio.Task] = None
        self._models: dict[str, dict[int, ModelEntry]] = {}  # name -> lease -> entry
        self._chains: dict[str, Any] = {}
        self._routers: dict[str, KvPushRouter] = {}
        # the fleet prefix economy: each KV-routed model's read view over
        # its router's indexer (served at /debug/kv_fleet) and its
        # replication controller (with a prefetch_config)
        self.fleet_views: dict[str, FleetKvView] = {}
        self._prefetchers: dict[str, KvPrefetchController] = {}
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
        self._breaker_board = await SharedBreakerBoard(
            self.rt.kv, self.health, namespace=self.namespace).start()
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
        if self._breaker_board is not None:
            await self._breaker_board.stop()
            self._breaker_board = None
        for ctrl in list(self._prefetchers.values()):
            await ctrl.stop()
        self._prefetchers.clear()
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
        heartbeat in the shared health tracker, a reading of its queue in
        the shared load view, and its latency histograms folded into the
        fleet-merged feed."""
        sub = await self.rt.kv.subscribe(f"{METRICS_TOPIC}.>")
        async for ev in sub:
            try:
                m = ForwardPassMetrics.from_dict(json.loads(ev["value"]))
            except (KeyError, ValueError, TypeError):
                continue
            self.health.observe_metrics(m)
            self.load.observe(m)
            FLEET_FEED.observe(m)

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
            view = FleetKvView(router.indexer)
            self.fleet_views[name] = view
            if self.prefetch_config is not None:
                async def publish(wid: str, msg: dict) -> None:
                    await self.rt.kv.publish(f"{KV_FLEET_TOPIC}.{wid}",
                                             json.dumps(msg))

                ctrl = KvPrefetchController(
                    view, lambda push=push: push.workers,
                    self.prefetch_config, publish=publish)
                self._prefetchers[name] = ctrl
                ctrl.start()

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
                        eng = (self.engine_factory(client, inst)
                               if self.engine_factory is not None
                               else RemoteWorkerEngine(client, inst.id))
                        push.add_worker(wid, eng)
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
        tok, fmt = await self._checkpoint_tokenizer(name, entry)
        if tok is None:
            tok, fmt = self.tokenizer or make_test_tokenizer(), \
                PromptFormatter()
        chain = ModelChain(
            name=name,
            preprocessor=OpenAIPreprocessor(
                tokenizer=tok, formatter=fmt, model_name=name,
                context_length=entry.context_length,
            ),
            engine=engine,
            backend=Backend(tok),
            chat=entry.model_type in ("chat", "both"),
            completions=entry.model_type in ("completions", "both", "chat"),
        )
        self._chains[name] = (chain, client)
        self.manager.register(chain)

    async def _checkpoint_tokenizer(self, name: str, entry: ModelEntry):
        """(HfTokenizer, PromptFormatter) of the entry's checkpoint: its
        directory when this host has it, else the model card downloaded
        from the store (cached per card_ref across worker churn); (None,
        None) without one, or when it fails to load (logged)."""
        model_dir = entry.model_path
        if (model_dir is None or not os.path.isdir(model_dir)) \
                and entry.card_ref:
            model_dir = self._card_dirs.get(entry.card_ref)
            if model_dir is None:
                from dynamo_tpu_torch.model_card import download_card

                try:
                    model_dir = await download_card(self.rt.kv,
                                                    entry.card_ref)
                except (ConnectionError, OSError):
                    log.exception("card download failed for %s", name)
                    model_dir = None
                if model_dir is not None:
                    self._card_dirs[entry.card_ref] = model_dir
        if not model_dir:
            return None, None
        try:
            from dynamo_tpu_torch.tokenizer import HfTokenizer

            return (HfTokenizer.from_dir(model_dir),
                    PromptFormatter.from_dir(model_dir))
        except Exception:  # noqa: BLE001 — a bad card/dir must not
            # crash discovery; serve with the fallback tokenizer
            log.exception("tokenizer load failed for %s (%s)", name,
                          model_dir)
            return None, None

    async def _remove_model(self, name: str) -> None:
        log.info("model %s removed (last instance gone)", name)
        chain_client = self._chains.pop(name, None)
        self._routers.pop(name, None)
        self.fleet_views.pop(name, None)
        ctrl = self._prefetchers.pop(name, None)
        if ctrl is not None:
            await ctrl.stop()
        self.manager.unregister(name)
        if chain_client is not None:
            await chain_client[1].stop()
