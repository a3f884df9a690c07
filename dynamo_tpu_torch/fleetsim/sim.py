"""In-process worker fleet driven through the REAL control plane (the
port's copy of the JAX package's fleetsim/sim.py, over the port's store,
watcher and router).

A ``SimWorker`` is a ``MockerEngine`` (optionally on a ``VirtualClock``)
registered against a LIVE store exactly the way production workers are:
a kept-alive lease, an instance key under the component prefix, a model
entry key, and a throttled ``WorkerMetricsPublisher`` on the
load-metrics plane. The ONE production piece it skips is the per-worker
TCP endpoint server — at 1k workers that is 1k listening sockets for
zero coverage, since the router's dispatch seam is exercised through
``ModelWatcher(engine_factory=...)`` handing the router the in-process
engine keyed by the same lease id discovery found in the store.

``SimFleet`` owns the workers (list guarded by ``_mu`` — the planner's
connector and the bench's scale calls race) and scales by spawning /
draining them newest-first. ``SimConnector`` adapts the fleet to the
planner's ``Connector`` protocol, closing the loop: planner decisions
cause real registrations and real lease revocations, which the watcher
observes as real store events.
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Optional

from dynamo_tpu_torch.fleetsim.clock import REAL_CLOCK, Clock

log = logging.getLogger(__name__)


class SimWorker:
    """One simulated worker: engine + live-store registration."""

    def __init__(
        self,
        rt: Any,                 # DistributedRuntime (shared per fleet)
        entry: Any,              # ModelEntry
        args: Any,               # MockerArgs (worker_id overwritten)
        index: int,
        clock: Clock = REAL_CLOCK,
        lease_ttl_s: float = 60.0,
        metrics_interval_s: float = 1.0,
        engines: Optional[dict[str, Any]] = None,
    ):
        self.rt = rt
        self.entry = entry
        self.args = args
        self.index = index
        self.clock = clock
        self.lease_ttl_s = lease_ttl_s
        self.metrics_interval_s = metrics_interval_s
        # fleet-shared engine registry: the entry MUST land before the
        # instance key does — the watcher's engine_factory resolves it the
        # moment discovery sees the put
        self._engines = engines
        self.lease: Optional[Any] = None
        self.engine: Optional[Any] = None
        self._pub: Optional[Any] = None
        self._keys: list[str] = []

    @property
    def worker_id(self) -> str:
        return str(self.lease.id) if self.lease is not None else ""

    async def start(self) -> "SimWorker":
        from dynamo_tpu_torch.frontend.watcher import model_key
        from dynamo_tpu_torch.mocker import MockerEngine
        from dynamo_tpu_torch.runtime.component import instance_prefix
        from dynamo_tpu_torch.runtime.publisher import WorkerMetricsPublisher

        # long TTL: a thousand workers on short leases turn the store into
        # a keepalive treadmill that measures nothing but its own overhead
        self.lease = await self.rt.kv.lease_grant(self.lease_ttl_s)
        wid = str(self.lease.id)
        self.args.worker_id = wid
        self.engine = MockerEngine(self.args, clock=self.clock)
        if self._engines is not None:
            self._engines[wid] = self.engine

        inst_key = instance_prefix(
            self.entry.namespace, self.entry.component, self.entry.endpoint
        ) + wid
        await self.rt.kv.put(
            inst_key,
            json.dumps({
                # no endpoint server: the router reaches this engine via
                # the watcher's engine_factory, never via host:port
                "host": "sim", "port": 0, "worker_id": wid,
                "metadata": {"model": self.entry.name},
            }),
            lease=self.lease.id,
        )
        mkey = model_key(self.entry.namespace, self.entry.name) \
            + f"/{self.lease.id}"
        await self.rt.kv.put(mkey, self.entry.to_json(),
                             lease=self.lease.id)
        self._keys = [inst_key, mkey]

        pub = WorkerMetricsPublisher(
            self.rt.kv, wid, min_interval_s=self.metrics_interval_s
        )
        pub.start()
        self.engine.on_metrics = pub
        self._pub = pub
        return self

    async def drain(self, timeout_s: float = 5.0) -> None:
        """Graceful exit: stop admitting, let in-flight streams finish,
        then revoke the lease (the store deletes both keys + notifies)."""
        if self.engine is not None:
            self.engine.begin_drain()
            deadline = self.clock.monotonic() + timeout_s
            while (not self.engine.drained()
                   and self.clock.monotonic() < deadline):
                await self.clock.sleep(0.05)
        await self._teardown()

    async def kill(self) -> None:
        """Abrupt exit (no drain) — registration-storm churn."""
        await self._teardown()

    async def _teardown(self) -> None:
        if self._engines is not None and self.lease is not None:
            self._engines.pop(str(self.lease.id), None)
        if self._pub is not None:
            try:
                await self._pub.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log.debug("metrics publisher stop failed", exc_info=True)
            self._pub = None
        if self.engine is not None:
            await self.engine.stop()
            self.engine = None
        if self.lease is not None:
            try:
                await self.lease.revoke()
            except Exception:  # noqa: BLE001 — store may already be gone
                log.debug("lease revoke failed", exc_info=True)
            self.lease = None


class SimFleet:
    """A scalable population of SimWorkers sharing one runtime client."""

    def __init__(
        self,
        rt: Any,
        entry: Any,
        make_args: Any,          # (index: int) -> MockerArgs
        clock: Clock = REAL_CLOCK,
        lease_ttl_s: float = 60.0,
        metrics_interval_s: float = 1.0,
    ):
        self.rt = rt
        self.entry = entry
        self.make_args = make_args
        self.clock = clock
        self.lease_ttl_s = lease_ttl_s
        self.metrics_interval_s = metrics_interval_s
        self._mu = asyncio.Lock()
        self._workers: list[SimWorker] = []
        # advisory size mirror: _workers accesses hold _mu, but
        # the planner's Connector.current_replicas() is synchronous — it
        # reads this GIL-atomic int, updated only under the lock
        self._n = 0
        self._spawned = 0
        self.engines: dict[str, Any] = {}  # lease id -> engine (watcher hook)

    def engine_factory(self, client: Any, inst: Any) -> Any:
        """ModelWatcher hook: the store-discovered instance id IS the
        lease id we registered under, so hand back the live engine."""
        eng = self.engines.get(str(inst.id))
        if eng is None:
            raise KeyError(f"sim fleet has no engine for instance {inst.id}")
        return eng

    def size(self) -> int:
        return self._n

    async def scale_to(self, n: int) -> None:
        """Spawn or drain (newest-first) until the fleet holds ``n``."""
        n = max(0, n)
        async with self._mu:
            while len(self._workers) < n:
                idx = self._spawned
                self._spawned += 1
                w = SimWorker(
                    self.rt, self.entry, self.make_args(idx), idx,
                    clock=self.clock, lease_ttl_s=self.lease_ttl_s,
                    metrics_interval_s=self.metrics_interval_s,
                    engines=self.engines,
                )
                await w.start()
                self._workers.append(w)
                self._n = len(self._workers)
            drained: list[SimWorker] = []
            while len(self._workers) > n:
                drained.append(self._workers.pop())
            self._n = len(self._workers)
            # drain outside nothing — we hold _mu for the whole resize so a
            # concurrent scale_to sees a consistent fleet; draining a few
            # mockers is fast (streams are short and clock-compressed)
            for w in drained:
                await w.drain()

    async def spawn(self, count: int) -> None:
        await self.scale_to(self.size() + count)

    async def stop(self) -> None:
        async with self._mu:
            workers, self._workers = self._workers, []
            self._n = 0
            for w in workers:
                await w.kill()
            self.engines.clear()


class SimConnector:
    """Planner ``Connector`` over a SimFleet: decisions become real
    registrations/revocations the watcher discovers through the store."""

    def __init__(self, fleet: SimFleet):
        self.fleet = fleet
        self.calls: list[int] = []

    def current_replicas(self) -> int:
        return self.fleet.size()

    async def set_replicas(self, n: int) -> None:
        self.calls.append(n)
        await self.fleet.scale_to(n)
