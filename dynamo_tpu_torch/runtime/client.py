"""Asyncio client for the control-plane store (the port's copy of the JAX
package's runtime/client.py; it talks to either package's store, or the
JAX package's native dcp-server, over the same wire protocol).

Mirrors the reference's etcd client surface (transports/etcd.rs):
``primary_lease`` with background keep-alive tied to a cancellation
callback (etcd.rs:66-148), kv_get/put/delete, and
``kv_get_and_watch_prefix`` — snapshot + live event stream.
"""
from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.runtime.protocol import encode_frame, read_frame

log = logging.getLogger(__name__)


class StoreError(RuntimeError):
    pass


class Lease:
    """A granted lease + its keep-alive loop (etcd.rs lease keep-alive)."""

    def __init__(self, client: "KvClient", lease_id: int, ttl_s: float):
        self.client = client
        self.id = lease_id
        self.ttl_s = ttl_s
        self._task: Optional[asyncio.Task] = None
        self.lost: asyncio.Event = asyncio.Event()

    def start_keepalive(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._beat())

    async def _beat(self) -> None:
        # 3 beats per TTL. etcd-client semantics: transient failures are
        # retried until the TTL has actually elapsed since the last ack —
        # only a server round-trip that reports the lease gone, or a full
        # TTL of silence, declares it lost (the reference cancels the
        # runtime when the primary lease dies).
        interval = max(self.ttl_s / 3.0, 0.05)
        last_ack = time.monotonic()
        while True:
            await asyncio.sleep(interval)
            try:
                # bound the RPC: a hung server (silent partition, no RST)
                # must not park _beat forever past the TTL deadline
                ok = await asyncio.wait_for(
                    self.client.lease_keepalive(self.id), timeout=interval
                )
            except (ConnectionError, OSError, asyncio.TimeoutError):
                # transient: control plane unreachable; the lease may still
                # be live server-side. Retry until the TTL deadline passes.
                if time.monotonic() - last_ack > self.ttl_s:
                    log.warning("lease %d lost (no ack within TTL)", self.id)
                    self.lost.set()
                    return
                continue
            if ok:
                last_ack = time.monotonic()
            else:
                # authoritative: the server answered and the lease is gone
                log.warning("lease %d lost (expired server-side)", self.id)
                self.lost.set()
                return

    async def revoke(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        try:
            await self.client.lease_revoke(self.id)
        except (StoreError, ConnectionError, OSError):
            pass


class Watch:
    """A live prefix watch: async-iterate events; `initial` holds the
    snapshot taken when the watch started."""

    def __init__(self, client: "KvClient", watch_id: int,
                 initial: list[tuple[str, str, int]], kind: str = "watch"):
        self.client = client
        self.watch_id = watch_id
        self.initial = initial
        self.kind = kind  # "watch" (kv prefix) | "sub" (pub/sub topic)
        self.queue: asyncio.Queue = asyncio.Queue()

    def __aiter__(self) -> AsyncIterator[dict[str, Any]]:
        return self

    async def __anext__(self) -> dict[str, Any]:
        item = await self.queue.get()
        if item is None:
            raise StopAsyncIteration
        return item

    async def cancel(self) -> None:
        self.client._watches.pop(self.watch_id, None)
        op = (
            {"op": "unwatch", "watch": self.watch_id}
            if self.kind == "watch"
            else {"op": "unsubscribe", "sub": self.watch_id}
        )
        try:
            await self.client._call(op)
        except (StoreError, ConnectionError, OSError):
            pass
        # events in flight during the unwatch round-trip landed in the
        # orphan buffer under this (never-reused) id; reclaim them now that
        # the server has stopped sending
        self.client._orphan_events.pop(self.watch_id, None)
        self.queue.put_nowait(None)


class KvClient:
    """One TCP connection multiplexing requests + watch events."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7111):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: dict[int, asyncio.Future] = {}
        self._watches: dict[int, Watch] = {}
        # events that arrive between a watch/subscribe response and the
        # caller registering the Watch object (same-loop race: _rx may read
        # the first event frame before the requesting coroutine resumes)
        self._orphan_events: dict[int, list[dict[str, Any]]] = {}
        self._ids = itertools.count(1)
        self._rx_task: Optional[asyncio.Task] = None
        self.closed = asyncio.Event()

    async def connect(self, retries: int = 40, delay_s: float = 0.25,
                      retry_policy: Optional[Any] = None) -> "KvClient":
        # jittered backoff (resilience/policy.py): a fleet of workers
        # reconnecting after a control-plane restart must not stampede it
        # on a synchronized retry tick. The legacy (retries, delay_s)
        # default maps onto a CONSTANT-delay jittered policy
        # (max_delay == base) so the total time-to-fail stays the legacy
        # retries * delay_s budget; pass retry_policy for exponential.
        from dynamo_tpu_torch.resilience.policy import RetryPolicy

        policy = retry_policy or RetryPolicy(
            max_attempts=retries, base_delay_s=delay_s, max_delay_s=delay_s,
        )
        last: Optional[Exception] = None
        for attempt in range(policy.max_attempts):
            try:
                self._reader, self._writer = await asyncio.open_connection(
                    self.host, self.port
                )
                break
            except OSError as e:
                last = e
                if attempt == policy.max_attempts - 1:
                    break
                await policy.sleep(attempt)
        if self._writer is None:
            raise ConnectionError(
                f"cannot reach control plane at {self.host}:{self.port}: {last}"
            )
        self._rx_task = asyncio.get_running_loop().create_task(self._rx())
        return self

    async def close(self) -> None:
        if self._rx_task is not None:
            self._rx_task.cancel()
            self._rx_task = None
        if self._writer is not None:
            w, self._writer = self._writer, None
            w.close()
            try:
                # without this the transport (and its FD) outlives close()
                # and leaks into the loop's next iteration
                await w.wait_closed()
            except (ConnectionError, OSError):
                pass
        self.closed.set()

    async def _rx(self) -> None:
        try:
            while True:
                msg = await read_frame(self._reader)
                rid = msg.pop("req_id", None)
                if rid is not None:
                    fut = self._pending.pop(rid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(msg)
                elif "watch" in msg or "sub" in msg:
                    wid = msg.get("watch") or msg.get("sub")
                    w = self._watches.get(wid)
                    if w is not None:
                        w.queue.put_nowait(msg)
                    else:
                        self._orphan_events.setdefault(wid, []).append(msg)
                        # hard bound: ids are monotonic, so the smallest
                        # buffered wid is the stalest claim-in-flight
                        while len(self._orphan_events) > 64:
                            self._orphan_events.pop(min(self._orphan_events))
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            self.closed.set()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("control plane connection lost"))
            self._pending.clear()
            for w in self._watches.values():
                w.queue.put_nowait(None)

    async def _call(self, req: dict[str, Any]) -> dict[str, Any]:
        if self._writer is None:
            raise ConnectionError("not connected")
        rid = next(self._ids)
        req["req_id"] = rid
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        self._writer.write(encode_frame(req))
        await self._writer.drain()
        resp = await fut
        if not resp.get("ok", False) and "error" in resp:
            raise StoreError(resp["error"])
        return resp

    # ---- API ----

    async def put(self, key: str, value: str, lease: int = 0) -> int:
        return (await self._call(
            {"op": "put", "key": key, "value": value, "lease": lease}
        ))["rev"]

    async def get(self, key: str) -> Optional[str]:
        kvs = (await self._call({"op": "get", "key": key}))["kvs"]
        return kvs[0][1] if kvs else None

    async def get_prefix(self, prefix: str) -> list[tuple[str, str, int]]:
        resp = await self._call({"op": "get_prefix", "prefix": prefix})
        return [tuple(kv) for kv in resp["kvs"]]

    async def delete(self, key: str) -> int:
        return (await self._call({"op": "delete", "key": key}))["deleted"]

    async def delete_prefix(self, prefix: str) -> int:
        return (await self._call({"op": "delete_prefix", "prefix": prefix}))["deleted"]

    async def lease_grant(self, ttl_s: float, keepalive: bool = True) -> Lease:
        resp = await self._call({"op": "lease_grant", "ttl": ttl_s})
        lease = Lease(self, resp["lease"], ttl_s)
        if keepalive:
            lease.start_keepalive()
        return lease

    async def lease_keepalive(self, lease: int) -> bool:
        try:
            resp = await self._call({"op": "lease_keepalive", "lease": lease})
        except StoreError:
            return False
        return bool(resp.get("ok"))

    async def lease_revoke(self, lease: int) -> None:
        await self._call({"op": "lease_revoke", "lease": lease})

    async def ping(self) -> bool:
        return bool((await self._call({"op": "ping"})).get("ok"))

    async def watch_prefix(self, prefix: str) -> Watch:
        """Snapshot + live events (etcd.rs kv_get_and_watch_prefix). The
        server returns the snapshot atomically with watch registration in a
        single op, so no put/delete can fall between snapshot and watch."""
        resp = await self._call({"op": "watch", "prefix": prefix})
        snapshot = [tuple(kv) for kv in resp.get("kvs", [])]
        w = Watch(self, resp["watch"], snapshot)
        self._register_watch(w)
        return w

    def _register_watch(self, w: Watch) -> None:
        self._watches[w.watch_id] = w
        for msg in self._orphan_events.pop(w.watch_id, []):
            w.queue.put_nowait(msg)

    # ---- durable FIFO queues (JetStream-work-queue equivalent; carries
    # the disagg prefill queue — reference utils/prefill_queue.py) ----

    async def qpush(self, queue: str, value: str) -> int:
        """Push; returns queue depth after the op (0 if delivered straight
        to a parked popper)."""
        return (await self._call(
            {"op": "qpush", "queue": queue, "value": value}
        ))["len"]

    async def qpop(
        self, queue: str, timeout_s: float = 0.0
    ) -> Optional[str]:
        """Pop the oldest value; with timeout_s > 0 the server parks the
        request (long-poll) and replies on push or timeout. None if empty."""
        resp = await self._call(
            {"op": "qpop", "queue": queue, "timeout": timeout_s}
        )
        return None if resp.get("empty") else resp["value"]

    async def qlen(self, queue: str) -> int:
        return (await self._call({"op": "qlen", "queue": queue}))["len"]

    # ---- pub/sub (NATS-core-equivalent event plane) ----

    async def publish(self, topic: str, value: str) -> int:
        resp = await self._call({"op": "publish", "topic": topic, "value": value})
        return resp.get("receivers", 0)

    async def subscribe(self, topic: str) -> Watch:
        """Subscribe to a topic; iterate {'topic', 'value'} events. Topic
        may end in '.>' for NATS-style suffix wildcard."""
        resp = await self._call({"op": "subscribe", "topic": topic})
        w = Watch(self, resp["sub"], [], kind="sub")
        self._register_watch(w)
        return w


class ObjectStore:
    """NATS-object-store equivalent over the kv plane (reference
    model_card/model.rs:256-305 uses the NATS object store for model-card
    artifacts). Objects are single values under a bucket prefix — the
    frame cap (64 MB) bounds object size; binary payloads are base64."""

    ROOT = "dynamo://_objects/"

    def __init__(self, kv: KvClient):
        self.kv = kv

    def _key(self, bucket: str, name: str) -> str:
        return f"{self.ROOT}{bucket}/{name}"

    async def put(self, bucket: str, name: str, data: bytes) -> None:
        import base64

        await self.kv.put(
            self._key(bucket, name), base64.b64encode(data).decode()
        )

    async def get(self, bucket: str, name: str) -> Optional[bytes]:
        import base64

        v = await self.kv.get(self._key(bucket, name))
        return None if v is None else base64.b64decode(v)

    async def delete(self, bucket: str, name: str) -> None:
        await self.kv.delete(self._key(bucket, name))

    async def list(self, bucket: str) -> list[str]:
        prefix = f"{self.ROOT}{bucket}/"
        kvs = await self.kv.get_prefix(prefix)
        return [k[len(prefix):] for k, _, _ in kvs]
