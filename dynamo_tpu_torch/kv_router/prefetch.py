"""The router-driven KV replication controller: push hot prefixes into the
workers' host tiers before demand hits (a copy of the JAX package's
kv_router/prefetch.py).

The reactive path (the engine's ``_remote_prefetch`` and G4's
``RemoteKvFetcher``) pulls a missed prefix from a peer at request time,
so the first request on a cold worker still pays the probe and the
stream. This controller acts ahead of demand from the frontend, where the
``FleetKvView`` knows every block's holders and heat:

  * each tick it pushes the fleet hint digest (replica counts, holder
    lists) to every worker; dedup admission and replication-aware
    eviction consult it;
  * a worker that appears with an EMPTY fleet footprint (a cold join) is
    warm-started with the fleet's top-K hot chains;
  * hot chains whose leaf fewer than ``replication_target`` workers hold
    are pushed into the least-loaded non-holder's G2 host tier.

Delivery is duck-typed: a worker object (or its ``.engine`` or
``.inner``) with ``apply_fleet_hints(digest)`` and
``prefetch_hashes(hashes, parents)`` is called directly (in-process
fleets, tests). A worker reached only over the wire gets the same
payloads on the store's pub/sub plane (``kv_fleet.{worker_id}``, which
frontend/watcher.py ``register_llm`` subscribes to) when a ``publish``
callable is given; a worker with neither is skipped. The fleet simulator
(fleetsim/: SimFleet's in-process mocker workers behind a ModelWatcher)
drives this controller at fleet scale on the CPU.
"""
from __future__ import annotations

import asyncio
import inspect
import logging
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Optional

from dynamo_tpu_torch.kv_fleet_metrics import KV_FLEET
from dynamo_tpu_torch.kv_router.fleet import FleetKvView
from dynamo_tpu_torch.kv_router.indexer import WorkerId

log = logging.getLogger(__name__)

# pub/sub topic prefix of the wire-delivered fleet payloads: JSON
# {"hints": digest} or {"prefetch": {"hashes": [...], "parents": [...]}}
KV_FLEET_TOPIC = "kv_fleet"


@dataclass
class PrefetchConfig:
    """The controller's knobs (config.py and the launcher's flags)."""

    # desired fleet copies of a hot block (--kv-replication-target)
    replication_target: int = 2
    # hot chains examined per tick and pushed to a cold joiner
    hot_k: int = 8
    # controller tick period
    interval_s: float = 2.0
    # ceiling on blocks pushed per tick (storm guard)
    max_blocks_per_tick: int = 256
    # the same chain leaf is not pushed to the same worker again within
    # this window (the engine skips blocks it holds, but probing peers
    # for them again is wasted wire)
    cooldown_s: float = 30.0


class KvPrefetchController:
    """One frontend-side controller per KV-routed model."""

    def __init__(
        self,
        view: FleetKvView,
        workers: Callable[[], dict[WorkerId, Any]],
        config: Optional[PrefetchConfig] = None,
        *,
        publish: Optional[Callable[[WorkerId, dict], Awaitable[Any]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.view = view
        self._workers = workers
        self.cfg = config or PrefetchConfig()
        self._publish = publish
        self._clock = clock
        self._warm_started: set[WorkerId] = set()
        self._pushed: dict[tuple[WorkerId, int], float] = {}
        self._task: Optional[asyncio.Task] = None
        self.ticks = 0

    # ---- lifecycle ----

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — outlive one bad tick
                log.exception("kv prefetch tick failed")
            await asyncio.sleep(self.cfg.interval_s)

    # ---- worker delivery (duck-typed) ----

    @staticmethod
    def _hook(worker: Any, name: str) -> Optional[Callable]:
        for obj in (worker, getattr(worker, "engine", None),
                    getattr(worker, "inner", None)):
            fn = getattr(obj, name, None)
            if callable(fn):
                return fn
        return None

    @staticmethod
    async def _call(fn: Callable, *args: Any) -> Any:
        out = fn(*args)
        if inspect.isawaitable(out):
            out = await out
        return out

    def _deliverable(self, worker: Any) -> bool:
        return (self._hook(worker, "prefetch_hashes") is not None
                or self._publish is not None)

    async def _push_chain(
        self, worker_id: WorkerId, worker: Any, chain: list[int]
    ) -> int:
        if not chain:
            return 0
        fn = self._hook(worker, "prefetch_hashes")
        if fn is None and self._publish is None:
            return 0
        key = (worker_id, chain[-1])
        now = self._clock()
        last = self._pushed.get(key)
        if last is not None and now - last < self.cfg.cooldown_s:
            return 0
        self._pushed[key] = now
        if len(self._pushed) > 4096:
            cutoff = now - self.cfg.cooldown_s
            self._pushed = {
                k: t for k, t in self._pushed.items() if t >= cutoff
            }
        # within the run each block's parent is its predecessor; the
        # head's parent comes from the indexer's learned chain links
        parents = [
            self.view.indexer.parent_of(chain[0]) or 0, *chain[:-1]
        ]
        try:
            if fn is not None:
                # the engine counts the landed blocks itself
                # (dynamo_kv_fleet_prefetched_blocks_total is worker-side)
                return int(
                    await self._call(fn, list(chain), parents) or 0
                )
            await self._publish(worker_id, {
                "prefetch": {"hashes": list(chain), "parents": parents},
            })
            # optimistic: the worker skips blocks it already holds
            return len(chain)
        except Exception:  # noqa: BLE001 — a dead worker must not end a tick
            log.exception("prefetch push to %s failed", worker_id)
            return 0

    # ---- the control loop body ----

    async def tick(self) -> int:
        """One controller pass; returns the blocks pushed."""
        self.ticks += 1
        KV_FLEET.inc("dynamo_kv_fleet_prefetch_rounds_total")
        workers = dict(self._workers() or {})
        if not workers:
            return 0
        digest = self.view.digest()
        for wid, worker in workers.items():
            fn = self._hook(worker, "apply_fleet_hints")
            try:
                if fn is not None:
                    await self._call(fn, digest)
                elif self._publish is not None:
                    await self._publish(wid, {"hints": digest})
                else:
                    continue
                KV_FLEET.inc("dynamo_kv_fleet_hint_pushes_total")
            except Exception:  # noqa: BLE001
                log.exception("hint push to %s failed", wid)

        budget = self.cfg.max_blocks_per_tick
        pushed = 0
        chains = self.view.hot_chains(self.cfg.hot_k)

        # cold joiners first: a worker with no fleet footprint warm-starts
        # from the whole hot set
        for wid, worker in workers.items():
            if wid in self._warm_started:
                continue
            if self.view.indexer.worker_block_count(wid) > 0:
                self._warm_started.add(wid)  # born warm, nothing to do
                continue
            if not self._deliverable(worker):
                continue
            if not chains:
                continue
            self._warm_started.add(wid)
            got = 0
            for chain in chains:
                if pushed >= budget:
                    break
                n = await self._push_chain(wid, worker,
                                           chain[:budget - pushed])
                got += n
                pushed += n
            if got:
                KV_FLEET.inc("dynamo_kv_fleet_warm_starts_total")
                log.info("warm-started %s with %d fleet-hot blocks", wid, got)

        # then raise under-replicated hot chains toward the target
        target = self.cfg.replication_target
        if target > 1:
            for chain in chains:
                if pushed >= budget:
                    break
                leaf = chain[-1]
                holders = self.view.holders(leaf)
                if not holders or len(holders) >= target:
                    continue
                candidates = [
                    (self.view.indexer.worker_block_count(w), w)
                    for w in workers
                    if w not in holders and self._deliverable(workers[w])
                ]
                if not candidates:
                    continue
                _, wid = min(candidates)
                pushed += await self._push_chain(
                    wid, workers[wid], chain[:budget - pushed]
                )
        return pushed
