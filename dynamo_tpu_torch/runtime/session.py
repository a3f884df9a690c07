"""StoreSession: a control-plane connection that survives the control plane
(the port's copy of the JAX package's runtime/session.py).

`KvClient` is one TCP connection: when the store dies, every pending call
fails, every watch iterator ends, every lease keep-alive starves — and
nothing recovers. `StoreSession` wraps it with the session semantics the
reference gets from etcd clients (transports/etcd.rs): the *session*
outlives any one connection.

What it remembers, it restores:

  - **Leases** (`SessionLease`): on reconnect, first try
    ``lease_keepalive(old_id)`` — a store restarted from its journal keeps
    lease ids alive through the grace window, so the id (and everything
    keyed by it) is simply reclaimed. If the lease is truly gone, grant a
    fresh one, rewrite registration keys ending in ``/{old_id}`` to
    ``/{new_id}``, and fire ``on_rekey(old, new)`` callbacks so publishers
    / allocators keyed by lease id follow. Either way, every key the
    session put under the lease is re-put.
  - **Watches / subscriptions** (`SessionWatch`): a watch re-established
    after an outage diffs the fresh snapshot against the last-known
    keyspace and synthesizes put/delete events for whatever changed while
    the store was down (put-while-down, delete-while-down; unchanged keys
    produce nothing) — consumers see one consistent event stream, never a
    dead iterator.
  - **Degraded state**: while disconnected, ``dynamo_store_degraded`` = 1
    and registered state listeners fire (the frontend freezes its health /
    load views — stale-while-revalidate instead of forgetting the fleet).

Reconnects use the jittered `RetryPolicy` so a fleet of sessions doesn't
stampede a restarted store on a synchronized tick. `SessionLease.lost` is
deliberately NEVER set by a recoverable outage: a worker gated on
``lease.lost.wait()`` keeps serving while the session repairs the world
behind it.

The session duck-types `KvClient` (put/get/watch_prefix/subscribe/
qpush/...), so ``DistributedRuntime.connect(resync=True)`` can hand it out
as ``rt.kv`` with zero call-site changes.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.runtime.client import KvClient, Lease, StoreError, Watch
from dynamo_tpu_torch.runtime.store_metrics import STORE

log = logging.getLogger(__name__)


class SessionLease:
    """A lease that survives store outages: same surface as `Lease`
    (id / lost / revoke), but the session re-grants and re-registers it
    behind the scenes. `lost` is never set by a recoverable outage."""

    def __init__(self, session: "StoreSession", inner: Lease, ttl_s: float):
        self.session = session
        self.inner = inner
        self.ttl_s = ttl_s
        # key -> value: every registration put under this lease, re-put on
        # re-grant (the worker's discovery record, model cards, ...)
        self.keys: dict[str, str] = {}
        # deliberately session-level: the inner Lease's lost event fires on
        # outages, this one only if the session gives up (it doesn't)
        self.lost: asyncio.Event = asyncio.Event()
        # callbacks fired as cb(old_id, new_id) when a re-grant changes the
        # lease id (publishers/allocators keyed by lease id follow along)
        self.on_rekey: list[Callable[[int, int], None]] = []

    @property
    def id(self) -> int:
        return self.inner.id

    def start_keepalive(self) -> None:
        self.inner.start_keepalive()

    def _rekey(self, old_id: int, new_id: int) -> None:
        rekeyed: dict[str, str] = {}
        for k, v in self.keys.items():
            if k.endswith(f"/{old_id}"):
                k = k[: -len(str(old_id))] + str(new_id)
            rekeyed[k] = v
        self.keys = rekeyed
        for cb in list(self.on_rekey):
            try:
                cb(old_id, new_id)
            except Exception:  # noqa: BLE001 — one bad callback must not
                # abort the resync that everything else depends on
                log.exception("on_rekey callback failed (%d -> %d)",
                              old_id, new_id)

    async def revoke(self) -> None:
        await self.session._deregister_lease(self)
        await self.inner.revoke()


class SessionWatch:
    """A watch/subscription that survives store outages. Duck-types
    `Watch` (initial / async-iterate / cancel). A pump task forwards inner
    events and maintains the last-known keyspace; `resync` swaps in a
    fresh inner watch and synthesizes the put/delete delta."""

    def __init__(self, session: "StoreSession", inner: Watch,
                 prefix: str = "", topic: str = "", kind: str = "watch"):
        self.session = session
        self.inner = inner
        self.prefix = prefix
        self.topic = topic
        self.kind = kind  # "watch" (kv prefix) | "sub" (pub/sub topic)
        self.initial = inner.initial
        self.queue: asyncio.Queue = asyncio.Queue()
        self.last_known: dict[str, str] = {
            k: v for k, v, _l in inner.initial
        }
        self.synthesized_events = 0
        self._pump_task: Optional[asyncio.Task] = (
            asyncio.get_running_loop().create_task(self._pump())
        )

    def __aiter__(self) -> AsyncIterator[dict[str, Any]]:
        return self

    async def __anext__(self) -> dict[str, Any]:
        item = await self.queue.get()
        if item is None:
            raise StopAsyncIteration
        return item

    async def _pump(self) -> None:
        inner = self.inner
        while True:
            ev = await inner.queue.get()
            if ev is None:
                # inner stream died (connection loss): do NOT end the
                # outer iterator — the session's resync swaps in a fresh
                # inner watch and restarts this pump
                return
            if self.kind == "watch":
                if ev.get("event") == "put":
                    self.last_known[ev["key"]] = ev.get("value", "")
                elif ev.get("event") == "delete":
                    self.last_known.pop(ev["key"], None)
            self.queue.put_nowait(ev)

    async def resync(self, client: KvClient) -> None:
        """Re-establish on `client`; for kv watches, diff the fresh
        snapshot against last_known and synthesize the missed delta."""
        if self._pump_task is not None:
            self._pump_task.cancel()
            self._pump_task = None
        if self.kind == "sub":
            self.inner = await client.subscribe(self.topic)
        else:
            fresh = await client.watch_prefix(self.prefix)
            snap = {k: v for k, v, _l in fresh.initial}
            for k, v in sorted(snap.items()):
                if self.last_known.get(k) != v:
                    # put-while-down (new key or changed value)
                    self.queue.put_nowait(
                        {"watch": fresh.watch_id, "event": "put",
                         "key": k, "value": v, "synthetic": True})
                    self.synthesized_events += 1
            for k in sorted(self.last_known):
                if k not in snap:
                    # delete-while-down
                    self.queue.put_nowait(
                        {"watch": fresh.watch_id, "event": "delete",
                         "key": k, "synthetic": True})
                    self.synthesized_events += 1
            self.last_known = snap
            self.inner = fresh
        self._pump_task = asyncio.get_running_loop().create_task(
            self._pump())

    async def cancel(self) -> None:
        if self._pump_task is not None:
            self._pump_task.cancel()
            self._pump_task = None
        await self.session._deregister_watch(self)
        try:
            await self.inner.cancel()
        except (StoreError, ConnectionError, OSError):
            pass
        self.queue.put_nowait(None)


class StoreSession:
    """Auto-resyncing control-plane session; duck-types `KvClient`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7111,
                 retry_policy: Optional[Any] = None):
        from dynamo_tpu_torch.resilience.policy import RetryPolicy

        self.host = host
        self.port = port
        self._client = KvClient(host, port)
        # effectively-infinite jittered reconnect: an outage is a blip to
        # wait out, not an error to give up on
        self._policy = retry_policy or RetryPolicy(
            max_attempts=1_000_000, base_delay_s=0.1, max_delay_s=1.0,
        )
        self._mu = asyncio.Lock()
        self._session_leases: dict[int, SessionLease] = {}
        self._session_watches: list[SessionWatch] = []
        self._listeners: list[Callable[[bool], None]] = []
        self._change = asyncio.Event()
        self._sup_task: Optional[asyncio.Task] = None
        self._closed = False
        self.degraded = False
        self.reconnects = 0
        self.resyncs = 0
        # set only by close(): the session never declares itself dead on a
        # connection loss (that's the whole point)
        self.closed = asyncio.Event()

    async def connect(self, retries: int = 40,
                      delay_s: float = 0.25) -> "StoreSession":
        await self._client.connect(retries=retries, delay_s=delay_s)
        self._sup_task = asyncio.get_running_loop().create_task(
            self._supervise())
        return self

    # ---- degraded-state plumbing ----

    def add_state_listener(self, cb: Callable[[bool], None]) -> None:
        """Register cb(degraded: bool), fired on every transition. Fired
        immediately with the current state so late registrants agree."""
        self._listeners.append(cb)
        cb(self.degraded)

    def _set_degraded(self, flag: bool) -> None:
        if flag == self.degraded:
            return
        self.degraded = flag
        STORE.set("dynamo_store_degraded", 1.0 if flag else 0.0)
        for cb in list(self._listeners):
            try:
                cb(flag)
            except Exception:  # noqa: BLE001 — a listener must not break
                # the reconnect machinery everything depends on
                log.exception("degraded-state listener failed")

    # ---- supervisor ----

    async def _supervise(self) -> None:
        while not self._closed:
            client = self._client
            async with self._mu:
                leases = list(self._session_leases.values())
            closed_w = asyncio.get_running_loop().create_task(
                client.closed.wait())
            change_w = asyncio.get_running_loop().create_task(
                self._change.wait())
            lost_map = {
                asyncio.get_running_loop().create_task(sl.inner.lost.wait()):
                sl for sl in leases
            }
            try:
                done, pending = await asyncio.wait(
                    {closed_w, change_w, *lost_map},
                    return_when=asyncio.FIRST_COMPLETED,
                )
            finally:
                for t in (closed_w, change_w, *lost_map):
                    if not t.done():
                        t.cancel()
            self._change.clear()
            if self._closed:
                return
            if client.closed.is_set():
                await self._reconnect()
                continue
            for t in done:
                sl = lost_map.get(t)
                if sl is None:
                    continue
                # lease lost while the connection is healthy (server-side
                # expiry, e.g. a starved keep-alive): re-grant +
                # re-register — the previously-unconsumed Lease.lost event
                # finally has a consumer
                try:
                    await self._regrant(sl, client)
                except (ConnectionError, OSError, StoreError):
                    log.warning(
                        "lease %d re-grant interrupted by connection loss; "
                        "will retry on reconnect", sl.inner.id)

    async def _reconnect(self) -> None:
        self._set_degraded(True)
        await self._client.close()
        attempt = 0
        while not self._closed:
            c = KvClient(self.host, self.port)
            try:
                await c.connect(retries=1)
            except (ConnectionError, OSError):
                await self._policy.sleep(min(attempt, 16))
                attempt += 1
                continue
            self.reconnects += 1
            STORE.inc("dynamo_store_reconnects_total")
            log.info("control plane reconnected (%s:%d); resyncing session",
                     self.host, self.port)
            try:
                await self._resync(c)
            except (ConnectionError, OSError, StoreError) as e:
                log.warning("session resync interrupted (%s); retrying", e)
                await c.close()
                await self._policy.sleep(min(attempt, 16))
                attempt += 1
                continue
            self._client = c
            self.resyncs += 1
            STORE.inc("dynamo_store_resyncs_total")
            self._set_degraded(False)
            log.info("session resynced after %d reconnect attempt(s)",
                     attempt + 1)
            return

    async def _resync(self, c: KvClient) -> None:
        async with self._mu:
            leases = list(self._session_leases.values())
            watches = list(self._session_watches)
        for sl in leases:
            await self._regrant(sl, c)
        for w in watches:
            await w.resync(c)

    async def _regrant(self, sl: SessionLease, c: KvClient) -> None:
        old_id = sl.inner.id
        if sl.inner._task is not None:
            sl.inner._task.cancel()
            sl.inner._task = None
        # first choice: reclaim the old id — a journal-restarted store
        # keeps leases alive through the grace window exactly for this
        reclaimed = await c.lease_keepalive(old_id)
        if reclaimed:
            fresh = Lease(c, old_id, sl.ttl_s)
        else:
            fresh = await c.lease_grant(sl.ttl_s, keepalive=False)
        fresh.start_keepalive()
        sl.inner = fresh
        if fresh.id != old_id:
            async with self._mu:
                self._session_leases.pop(old_id, None)
                self._session_leases[fresh.id] = sl
            sl._rekey(old_id, fresh.id)
            log.info("lease %d re-granted as %d; re-registering %d key(s)",
                     old_id, fresh.id, len(sl.keys))
        else:
            log.info("lease %d reclaimed; re-registering %d key(s)",
                     old_id, len(sl.keys))
        for k, v in list(sl.keys.items()):
            await c.put(k, v, lease=fresh.id)
        self._change.set()  # supervisor: rebuild the lost-wait set

    # ---- registration bookkeeping ----

    async def _deregister_lease(self, sl: SessionLease) -> None:
        async with self._mu:
            self._session_leases.pop(sl.inner.id, None)
        self._change.set()

    async def _deregister_watch(self, w: SessionWatch) -> None:
        async with self._mu:
            if w in self._session_watches:
                self._session_watches.remove(w)

    # ---- KvClient surface (duck-typed; rt.kv IS the session) ----

    async def put(self, key: str, value: str, lease: int = 0) -> int:
        rev = await self._client.put(key, value, lease=lease)
        if lease:
            async with self._mu:
                sl = self._session_leases.get(lease)
                if sl is not None:
                    sl.keys[key] = value
        return rev

    async def get(self, key: str) -> Optional[str]:
        return await self._client.get(key)

    async def get_prefix(self, prefix: str) -> list[tuple[str, str, int]]:
        return await self._client.get_prefix(prefix)

    async def delete(self, key: str) -> int:
        async with self._mu:
            for sl in self._session_leases.values():
                sl.keys.pop(key, None)
        return await self._client.delete(key)

    async def delete_prefix(self, prefix: str) -> int:
        async with self._mu:
            for sl in self._session_leases.values():
                for k in [k for k in sl.keys if k.startswith(prefix)]:
                    sl.keys.pop(k, None)
        return await self._client.delete_prefix(prefix)

    async def lease_grant(self, ttl_s: float,
                          keepalive: bool = True) -> SessionLease:
        inner = await self._client.lease_grant(ttl_s, keepalive=keepalive)
        sl = SessionLease(self, inner, ttl_s)
        async with self._mu:
            self._session_leases[inner.id] = sl
        self._change.set()  # supervisor: watch this lease's lost event
        return sl

    async def lease_keepalive(self, lease: int) -> bool:
        return await self._client.lease_keepalive(lease)

    async def lease_revoke(self, lease: int) -> None:
        async with self._mu:
            self._session_leases.pop(lease, None)
        self._change.set()
        await self._client.lease_revoke(lease)

    async def ping(self) -> bool:
        return await self._client.ping()

    async def watch_prefix(self, prefix: str) -> SessionWatch:
        inner = await self._client.watch_prefix(prefix)
        w = SessionWatch(self, inner, prefix=prefix, kind="watch")
        async with self._mu:
            self._session_watches.append(w)
        return w

    async def subscribe(self, topic: str) -> SessionWatch:
        inner = await self._client.subscribe(topic)
        w = SessionWatch(self, inner, topic=topic, kind="sub")
        async with self._mu:
            self._session_watches.append(w)
        return w

    async def publish(self, topic: str, value: str) -> int:
        return await self._client.publish(topic, value)

    async def qpush(self, queue: str, value: str) -> int:
        return await self._client.qpush(queue, value)

    async def qpop(self, queue: str,
                   timeout_s: float = 0.0) -> Optional[str]:
        return await self._client.qpop(queue, timeout_s)

    async def qlen(self, queue: str) -> int:
        return await self._client.qlen(queue)

    async def close(self) -> None:
        self._closed = True
        self._change.set()
        if self._sup_task is not None:
            self._sup_task.cancel()
            self._sup_task = None
        async with self._mu:
            leases = list(self._session_leases.values())
            watches = list(self._session_watches)
            self._session_leases.clear()
            self._session_watches.clear()
        for sl in leases:
            if sl.inner._task is not None:
                sl.inner._task.cancel()
                sl.inner._task = None
        for w in watches:
            if w._pump_task is not None:
                w._pump_task.cancel()
                w._pump_task = None
            w.queue.put_nowait(None)
        await self._client.close()
        self.closed.set()
