"""Control-plane KV store with leases and prefix watches (the port's copy
of the JAX package's runtime/store.py, without its chaos hooks).

etcd-shaped semantics (reference transports/etcd.rs:44-148): every key may
be bound to a lease; leases expire unless kept alive; expiry deletes the
bound keys and notifies watchers — that's the whole liveness story: a dead
worker stops sending keep-alives, its registration keys vanish, routers
drop it.

The frames (runtime/protocol.py) are byte-equal to the JAX package's, so
either package's clients talk to either package's store, and either
store replays the other's journal. The in-process `KvStore` core is
shared by the asyncio server here and the tests.

Durability (``journal_path``): every mutation (put/delete/lease
grant+revoke/qpush/qpop) appends one JSONL record to a WAL, compacted to
a one-line-per-live-entry snapshot via the same tmp+fsync+atomic-rename
discipline as the G3 manifest (engine/offload.py) — a crash leaves either
the old or the new journal, never a half state, and a torn tail (partial
last write) is tolerated on replay. Restarted leases get a grace window
(deadline = now + max(ttl, lease_grace_s)) so still-alive workers
reconnecting after the bounce can reclaim their lease ids — and the
registration keys bound to them — before the sweeper erases the fleet.
Off by default: journal_path=None is exactly the old in-memory store.
"""
from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from dynamo_tpu_torch.runtime.protocol import encode_frame, read_frame
from dynamo_tpu_torch.runtime.store_metrics import STORE

log = logging.getLogger(__name__)

# compaction slack: rewrite the journal once it holds more than this many
# lines per live entry (floor 256 so tiny stores don't thrash the file)
_WAL_SLACK = 4

WatchSink = Callable[[dict[str, Any]], None]


@dataclass
class _Watch:
    prefix: str
    sink: WatchSink
    watch_id: int


class KvStore:
    """The store core: keys, leases, watches. Time injected for tests."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        journal_path: Optional[str] = None,
        lease_grace_s: float = 10.0,
        fsync_mode: str = "always",
    ):
        if fsync_mode not in ("always", "batch"):
            raise ValueError(
                f"fsync_mode must be 'always' or 'batch', got {fsync_mode!r}"
            )
        self._clock = clock
        self._kv: dict[str, tuple[str, int]] = {}       # key -> (value, lease)
        self._leases: dict[int, float] = {}             # lease -> deadline
        self._lease_ttl: dict[int, float] = {}
        self._lease_keys: dict[int, set[str]] = {}
        self._watches: dict[int, _Watch] = {}
        self._subs: dict[int, tuple[str, WatchSink]] = {}
        self._queues: dict[str, deque] = {}
        # queue -> waiters: (sink, req_id, deadline, alive) — parked qpop
        # long-polls served FIFO on the next push
        self._qwaiters: dict[str, deque] = {}
        self._ids = itertools.count(1)
        self.revision = 0
        # -- WAL (off when journal_path is None) --
        self.journal_path = journal_path
        self.lease_grace_s = lease_grace_s
        self.fsync_mode = fsync_mode
        self._journal = None
        self._journal_lines = 0
        # batch mode: records buffered here until the scheduled
        # end-of-event-loop-drain flush (one write+flush+fsync per drain)
        self._wal_pending: list[str] = []
        self._wal_drain_scheduled = False
        self.replayed_keys = 0
        self.replayed_queue_items = 0
        self.torn_records = 0
        if journal_path is not None:
            self._replay_journal()
            # startup snapshot: drops the torn tail and replayed-away
            # churn so the attach point is a clean one-line-per-entry file
            self.compact_journal()

    # ---- kv ----

    def lease_alive(self, lease: int) -> bool:
        """Granted AND not past its deadline — the sweep-race fix: an
        expired-but-unswept lease must be authoritatively dead regardless
        of sweeper cadence."""
        dl = self._leases.get(lease)
        return dl is not None and dl >= self._clock()

    def expire_lease_if_overdue(self, lease: int) -> bool:
        """Inline expiry for a lease caught past its deadline by put /
        keepalive before the sweeper ran: delete its keys + notify now."""
        dl = self._leases.get(lease)
        if dl is None or dl >= self._clock():
            return False
        log.info("lease %d expired (caught inline, pre-sweep)", lease)
        self.lease_revoke(lease)
        return True

    def put(self, key: str, value: str, lease: int = 0) -> int:
        if lease:
            if not self.lease_alive(lease):
                self.expire_lease_if_overdue(lease)
                raise KeyError(f"lease {lease} not found")
            self._lease_keys.setdefault(lease, set()).add(key)
        old = self._kv.get(key)
        if old is not None and old[1] and old[1] != lease:
            # key moved off its old lease
            ks = self._lease_keys.get(old[1])
            if ks is not None:
                ks.discard(key)
        self._kv[key] = (value, lease)
        self.revision += 1
        self._wal({"op": "put", "key": key, "value": value, "lease": lease,
                   "rev": self.revision})
        self._notify("put", key, value)
        return self.revision

    def get(self, key: str) -> Optional[tuple[str, int]]:
        return self._kv.get(key)

    def get_prefix(self, prefix: str) -> list[tuple[str, str, int]]:
        return sorted(
            (k, v, l) for k, (v, l) in self._kv.items() if k.startswith(prefix)
        )

    def delete(self, key: str) -> int:
        if key not in self._kv:
            return 0
        _, lease = self._kv.pop(key)
        if lease:
            ks = self._lease_keys.get(lease)
            if ks is not None:
                ks.discard(key)
        self.revision += 1
        self._wal({"op": "delete", "key": key, "rev": self.revision})
        self._notify("delete", key, None)
        return 1

    def delete_prefix(self, prefix: str) -> int:
        keys = [k for k in self._kv if k.startswith(prefix)]
        for k in keys:
            self.delete(k)
        return len(keys)

    # ---- leases ----

    def lease_grant(self, ttl: float) -> int:
        lease = next(self._ids)
        self._leases[lease] = self._clock() + ttl
        self._lease_ttl[lease] = ttl
        self._wal({"op": "lease_grant", "lease": lease, "ttl": ttl})
        return lease

    def lease_keepalive(self, lease: int) -> bool:
        if not self.lease_alive(lease):
            # sweep-race fix: membership alone is not liveness — a lease
            # past its deadline must not be resurrectable just because
            # the sweeper hasn't run yet
            self.expire_lease_if_overdue(lease)
            return False
        self._leases[lease] = self._clock() + self._lease_ttl[lease]
        return True

    def lease_revoke(self, lease: int) -> None:
        had = self._leases.pop(lease, None) is not None
        self._lease_ttl.pop(lease, None)
        if had:
            self._wal({"op": "lease_revoke", "lease": lease})
        for k in list(self._lease_keys.pop(lease, set())):
            self.delete(k)

    def sweep_leases(self) -> list[int]:
        """Expire overdue leases (delete their keys + notify). Called
        periodically by the server loop."""
        now = self._clock()
        expired = [l for l, dl in self._leases.items() if dl < now]
        for l in expired:
            log.info("lease %d expired", l)
            self.lease_revoke(l)
        return expired

    # ---- durable FIFO queues (JetStream-work-queue equivalent; reference
    # transports/nats.rs:50-170 + utils/prefill_queue.py — carries the
    # disagg prefill queue). Values outlive producer connections; a parked
    # qpop (long-poll) is served directly on the next push. ----

    def qpush(self, queue: str, value: str) -> int:
        """Push; delivers straight to the oldest parked popper if any.
        Returns the queue depth after the operation."""
        waiters = self._qwaiters.get(queue)
        while waiters:
            sink, rid, _deadline, alive = waiters.popleft()
            if not alive():
                continue
            try:
                sink({"ok": True, "queue": queue, "value": value,
                      "req_id": rid})
                return len(self._queues.get(queue, ()))
            except Exception:  # noqa: BLE001 — dead waiter; try the next
                log.debug("queue waiter delivery failed; trying next",
                          exc_info=True)
                continue
        self._queues.setdefault(queue, deque()).append(value)
        # journal only what actually landed in the queue: a value handed
        # straight to a parked popper is net-zero and must not be
        # resurrected by replay
        self._wal({"op": "qpush", "queue": queue, "value": value})
        return len(self._queues[queue])

    def qpop(self, queue: str) -> Optional[str]:
        q = self._queues.get(queue)
        if q:
            v = q.popleft()
            if not q:
                self._queues.pop(queue, None)
            self._wal({"op": "qpop", "queue": queue})
            return v
        return None

    def qlen(self, queue: str) -> int:
        return len(self._queues.get(queue, ()))

    def qwait(
        self,
        queue: str,
        sink: WatchSink,
        req_id: Any,
        timeout: float,
        alive: Callable[[], bool] = lambda: True,
    ) -> None:
        self._qwaiters.setdefault(queue, deque()).append(
            (sink, req_id, self._clock() + timeout, alive)
        )

    def sweep_qwaiters(self) -> None:
        """Time out parked qpops (in-band empty reply). Called by the
        server loop alongside lease sweeping."""
        now = self._clock()
        for queue in list(self._qwaiters):
            ws = self._qwaiters[queue]
            keep: deque = deque()
            for sink, rid, deadline, alive in ws:
                if deadline < now or not alive():
                    if alive():
                        try:
                            sink({"ok": True, "queue": queue, "empty": True,
                                  "req_id": rid})
                        except Exception:  # noqa: BLE001
                            log.debug("expired-waiter notify failed",
                                      exc_info=True)
                else:
                    keep.append((sink, rid, deadline, alive))
            if keep:
                self._qwaiters[queue] = keep
            else:
                self._qwaiters.pop(queue, None)

    # ---- pub/sub (NATS-core-style transient topics; reference
    # transports/nats.rs — carries KV events and metrics) ----

    def subscribe(self, topic: str, sink: WatchSink) -> int:
        sid = next(self._ids)
        self._subs[sid] = (topic, sink)
        return sid

    def unsubscribe(self, sub_id: int) -> None:
        self._subs.pop(sub_id, None)

    def publish(self, topic: str, value: str) -> int:
        n = 0
        for sid, (t, sink) in list(self._subs.items()):
            # NATS-style token wildcard: exact match or 'a.b.>' suffix
            if t == topic or (t.endswith(".>") and topic.startswith(t[:-1])):
                try:
                    sink({"sub": sid, "topic": topic, "value": value})
                    n += 1
                except Exception:  # noqa: BLE001
                    log.debug("dropping dead subscriber %s", sid,
                              exc_info=True)
                    self._subs.pop(sid, None)
        return n

    # ---- watches ----

    def watch(self, prefix: str, sink: WatchSink) -> int:
        wid = next(self._ids)
        self._watches[wid] = _Watch(prefix, sink, wid)
        return wid

    def unwatch(self, watch_id: int) -> None:
        self._watches.pop(watch_id, None)

    def _notify(self, event: str, key: str, value: Optional[str]) -> None:
        for w in list(self._watches.values()):
            if key.startswith(w.prefix):
                msg = {"watch": w.watch_id, "event": event, "key": key}
                if value is not None:
                    msg["value"] = value
                try:
                    w.sink(msg)
                except Exception:  # noqa: BLE001 — one dead watcher can't stop others
                    log.debug("dropping dead watcher %s", w.watch_id,
                              exc_info=True)
                    self._watches.pop(w.watch_id, None)

    # ---- WAL (journal_path set) — same journal idiom as the G3 manifest
    # (engine/offload.py): JSONL append + flush per mutation, periodic
    # compaction to a one-line-per-live-entry snapshot via tmp + fsync +
    # atomic rename. ----

    def _live_entries(self) -> int:
        return (
            len(self._kv)
            + len(self._leases)
            + sum(len(q) for q in self._queues.values())
        )

    def _wal(self, rec: dict[str, Any]) -> None:
        if self.journal_path is None:
            return
        if self._journal is None:
            fresh = not os.path.exists(self.journal_path)
            self._journal = open(self.journal_path, "a", encoding="utf-8")
            if fresh:
                self._journal.write(json.dumps({"dcp_wal": 1}) + "\n")
                self._journal_lines = 1
        line = json.dumps(rec) + "\n"
        self._journal_lines += 1
        if self.fsync_mode == "batch":
            self._wal_pending.append(line)
            self._schedule_wal_drain()
        else:
            self._journal.write(line)
            self._journal.flush()
        if self._journal_lines > max(_WAL_SLACK * self._live_entries(), 256):
            self.compact_journal()

    def _schedule_wal_drain(self) -> None:
        if self._wal_drain_scheduled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no event loop (direct-call tests, replay): degrade to an
            # immediate synced write so batch mode loses no durability
            self._drain_wal()
            return
        # call_soon runs after every callback already queued this drain —
        # all mutations landed by concurrent connections coalesce into one
        # write + flush + fsync instead of a flush per record
        self._wal_drain_scheduled = True
        loop.call_soon(self._drain_wal)

    def _drain_wal(self) -> None:
        self._wal_drain_scheduled = False
        if not self._wal_pending:
            return
        if self._journal is None:
            # compaction folded the pending records into its snapshot (or
            # the journal was closed) before the drain fired
            self._wal_pending.clear()
            return
        self._journal.write("".join(self._wal_pending))
        self._wal_pending.clear()
        self._journal.flush()
        os.fsync(self._journal.fileno())
        STORE.inc("dynamo_store_wal_batched_syncs_total")

    def compact_journal(self) -> None:
        """Rewrite the journal as a snapshot of live state: meta line, then
        one lease_grant per live lease, one put per key, one qpush per
        queued item. Crash-safe: tmp + fsync + atomic rename."""
        if self.journal_path is None:
            return
        # pending batched records are superseded by the snapshot (it is
        # written from live in-memory state, which already includes them)
        self._wal_pending.clear()
        if self._journal is not None:
            self._journal.close()
            self._journal = None
        tmp = self.journal_path + ".tmp"
        lines = 1
        with open(tmp, "w", encoding="utf-8") as f:
            # meta line carries the revision: compaction folds away the
            # put/delete records whose "rev" fields would otherwise
            # restore it on replay
            f.write(json.dumps({"dcp_wal": 1, "rev": self.revision}) + "\n")
            # leases first so replayed puts find their lease registered
            for lease, ttl in self._lease_ttl.items():
                f.write(json.dumps(
                    {"op": "lease_grant", "lease": lease, "ttl": ttl}) + "\n")
                lines += 1
            for key, (value, lease) in self._kv.items():
                f.write(json.dumps(
                    {"op": "put", "key": key, "value": value,
                     "lease": lease}) + "\n")
                lines += 1
            for queue, q in self._queues.items():
                for value in q:
                    f.write(json.dumps(
                        {"op": "qpush", "queue": queue,
                         "value": value}) + "\n")
                    lines += 1
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.journal_path)
        self._journal_lines = lines

    def _replay_journal(self) -> None:
        """Rebuild state from the journal at startup. Torn tails (partial
        final write from a crash) are counted and skipped, matching the G3
        manifest loader. Restored lease deadlines get a grace window —
        max(ttl, lease_grace_s) from now — so still-alive workers can
        reclaim their leases before the sweeper erases the fleet."""
        if not os.path.exists(self.journal_path):
            return
        now = self._clock()
        max_lease = 0
        rev_hi = 0  # highest journaled revision (meta line + per-record)
        with open(self.journal_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    self.torn_records += 1
                    continue
                op = rec.get("op")
                rev_hi = max(rev_hi, int(rec.get("rev", 0)))
                if op == "put":
                    lease = rec.get("lease", 0)
                    if lease and lease not in self._leases:
                        continue  # lease revoked later in the log
                    old = self._kv.get(rec["key"])
                    if old is not None and old[1] and old[1] != lease:
                        # mirror live put(): the key moved off its old
                        # lease — a later revoke/expiry of THAT lease
                        # must not delete the new binding
                        ks = self._lease_keys.get(old[1])
                        if ks is not None:
                            ks.discard(rec["key"])
                    self._kv[rec["key"]] = (rec.get("value", ""), lease)
                    if lease:
                        self._lease_keys.setdefault(lease, set()).add(
                            rec["key"])
                elif op == "delete":
                    _, lease = self._kv.pop(rec["key"], ("", 0))
                    if lease:
                        ks = self._lease_keys.get(lease)
                        if ks is not None:
                            ks.discard(rec["key"])
                elif op == "lease_grant":
                    lease = int(rec["lease"])
                    ttl = float(rec.get("ttl", 10.0))
                    max_lease = max(max_lease, lease)
                    self._leases[lease] = now + max(ttl, self.lease_grace_s)
                    self._lease_ttl[lease] = ttl
                elif op == "lease_revoke":
                    lease = int(rec["lease"])
                    self._leases.pop(lease, None)
                    self._lease_ttl.pop(lease, None)
                    for k in self._lease_keys.pop(lease, set()):
                        self._kv.pop(k, None)
                elif op == "qpush":
                    self._queues.setdefault(
                        rec["queue"], deque()).append(rec.get("value", ""))
                elif op == "qpop":
                    q = self._queues.get(rec["queue"])
                    if q:
                        q.popleft()
                        if not q:
                            self._queues.pop(rec["queue"], None)
        if max_lease:
            # restart the id counter past everything in the log so fresh
            # grants never collide with reclaimed leases
            self._ids = itertools.count(max_lease + 1)
        self.replayed_keys = len(self._kv)
        self.replayed_queue_items = sum(
            len(q) for q in self._queues.values())
        # revision must not move backwards across a bounce: restore the
        # highest journaled rev (pre-rev journals fall back to key count)
        self.revision = max(rev_hi, self.replayed_keys)
        if self.replayed_keys:
            STORE.inc("dynamo_store_replayed_keys_total", self.replayed_keys)
        if self.replayed_queue_items:
            STORE.inc("dynamo_store_replayed_queue_items_total",
                      self.replayed_queue_items)
        if self.torn_records:
            log.warning("store journal: skipped %d torn record(s)",
                        self.torn_records)
        log.info(
            "store journal replayed: %d key(s), %d lease(s), %d queue "
            "item(s) (grace %.1fs)", self.replayed_keys, len(self._leases),
            self.replayed_queue_items, self.lease_grace_s,
        )

    def close_journal(self) -> None:
        if self._journal is not None:
            if self._wal_pending:
                self._drain_wal()
            self._journal.close()
            self._journal = None
        self._wal_pending.clear()


class _Conn:
    """One client connection to the store server."""

    def __init__(self, store: KvStore, writer: asyncio.StreamWriter):
        self.store = store
        self.writer = writer
        self.watch_ids: list[int] = []
        self.sub_ids: list[int] = []
        self.lease_ids: list[int] = []

    def send(self, msg: dict[str, Any]) -> None:
        if not self.writer.is_closing():
            self.writer.write(encode_frame(msg))

    def handle(self, req: dict[str, Any]) -> dict[str, Any]:
        op = req.get("op")
        s = self.store
        if op == "put":
            lease = req.get("lease", 0)
            if lease and not s.lease_alive(lease):
                # in-band error, wire-identical to the JAX package's — a stale
                # lease must not tear down the whole multiplexed connection.
                # lease_alive (not membership) so an expired-but-unswept
                # lease is authoritatively dead here too.
                s.expire_lease_if_overdue(lease)
                return {"ok": False, "error": "lease not found"}
            rev = s.put(req["key"], req.get("value", ""), lease)
            return {"ok": True, "rev": rev}
        if op == "get":
            kv = s.get(req["key"])
            return {"ok": True, "kvs": [[req["key"], kv[0], kv[1]]] if kv else []}
        if op == "get_prefix":
            return {"ok": True, "kvs": [list(t) for t in s.get_prefix(req["prefix"])]}
        if op == "delete":
            return {"ok": True, "deleted": s.delete(req["key"])}
        if op == "delete_prefix":
            return {"ok": True, "deleted": s.delete_prefix(req["prefix"])}
        if op == "lease_grant":
            lease = s.lease_grant(float(req.get("ttl", 10.0)))
            self.lease_ids.append(lease)
            return {"ok": True, "lease": lease}
        if op == "lease_keepalive":
            ok = s.lease_keepalive(int(req["lease"]))
            return {"ok": ok} if ok else {"ok": False, "error": "lease expired"}
        if op == "lease_revoke":
            s.lease_revoke(int(req["lease"]))
            return {"ok": True}
        if op == "watch":
            # register-then-snapshot in one synchronous op: no event can be
            # lost between the snapshot and the live stream (the reference's
            # etcd kv_get_and_watch_prefix atomicity)
            wid = s.watch(req["prefix"], self.send)
            self.watch_ids.append(wid)
            return {
                "ok": True,
                "watch": wid,
                "kvs": [list(t) for t in s.get_prefix(req["prefix"])],
            }
        if op == "unwatch":
            s.unwatch(int(req["watch"]))
            return {"ok": True}
        if op == "subscribe":
            sid = s.subscribe(req["topic"], self.send)
            self.sub_ids.append(sid)
            return {"ok": True, "sub": sid}
        if op == "unsubscribe":
            s.unsubscribe(int(req["sub"]))
            return {"ok": True}
        if op == "publish":
            n = s.publish(req["topic"], req.get("value", ""))
            return {"ok": True, "receivers": n}
        if op == "qpush":
            return {"ok": True, "len": s.qpush(req["queue"], req.get("value", ""))}
        if op == "qpop":
            v = s.qpop(req["queue"])
            if v is not None:
                return {"ok": True, "queue": req["queue"], "value": v}
            timeout = float(req.get("timeout", 0.0))
            if timeout > 0:
                # park: the reply frame is sent by qpush delivery or the
                # sweeper's timeout, carrying this op's req_id
                s.qwait(
                    req["queue"], self.send, req.get("req_id"), timeout,
                    alive=lambda: not self.writer.is_closing(),
                )
                return None  # deferred
            return {"ok": True, "queue": req["queue"], "empty": True}
        if op == "qlen":
            return {"ok": True, "len": s.qlen(req["queue"])}
        if op == "ping":
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


async def serve_store(
    host: str = "127.0.0.1",
    port: int = 7111,
    store: Optional[KvStore] = None,
    sweep_interval_s: float = 0.5,
    journal_path: Optional[str] = None,
    fsync_mode: str = "always",
) -> tuple[asyncio.AbstractServer, KvStore]:
    """Run the Python control-plane server. Returns (server, store)."""
    store = store or KvStore(journal_path=journal_path,
                             fsync_mode=fsync_mode)
    conn_writers: set[asyncio.StreamWriter] = set()

    async def on_conn(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn = _Conn(store, writer)
        conn_writers.add(writer)
        try:
            while True:
                req = await read_frame(reader)
                try:
                    resp = conn.handle(req)
                except Exception as e:  # noqa: BLE001 — answer in-band;
                    # a bad op must not kill the multiplexed connection
                    log.exception("store op failed: %s", req.get("op"))
                    resp = {"ok": False, "error": str(e)}
                if resp is None:  # deferred (parked qpop long-poll)
                    continue
                if "req_id" in req:
                    resp["req_id"] = req["req_id"]
                conn.send(resp)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:  # noqa: BLE001
            log.exception("store connection error")
        finally:
            # NOTE deliberate etcd parity: leases are NOT revoked on
            # disconnect — only on TTL expiry or explicit revoke. Watches
            # die with the connection.
            for wid in conn.watch_ids:
                store.unwatch(wid)
            for sid in conn.sub_ids:
                store.unsubscribe(sid)
            conn_writers.discard(writer)
            writer.close()

    async def sweeper():
        while True:
            await asyncio.sleep(sweep_interval_s)
            store.sweep_leases()
            store.sweep_qwaiters()

    server = await asyncio.start_server(on_conn, host, port)
    task = asyncio.get_running_loop().create_task(sweeper())
    server._dcp_sweeper = task  # keep a ref until close
    server._dcp_conn_writers = conn_writers
    server._dcp_store = store
    # close() must also cancel the sweeper — otherwise every store
    # instance leaks a live 0.5s-cadence task into the loop
    _orig_close = server.close

    def _close() -> None:
        if not task.done():
            task.cancel()
        _orig_close()

    server.close = _close
    return server, store


def crash_store(server: asyncio.AbstractServer) -> None:
    """Simulate the store process dying: stop accepting, hard-abort every
    live connection (clients see ConnectionResetError, not a clean FIN),
    kill the sweeper. The KvStore object — and its journal — survive only
    on disk; restart with ``serve_store(store=KvStore(journal_path=...))``.
    Used by the restart tests."""
    task = getattr(server, "_dcp_sweeper", None)
    if task is not None and not task.done():
        task.cancel()
    store = getattr(server, "_dcp_store", None)
    if store is not None:
        store.close_journal()
    server.close()
    for w in list(getattr(server, "_dcp_conn_writers", ())):
        transport = w.transport
        if transport is not None:
            transport.abort()
