"""The port's distributed runtime (dynamo_tpu_torch/runtime/) against the
JAX package's: frames byte-equal for the same objects; the store, client
and endpoint cases of tests/test_runtime.py for every pairing of (store,
client) across the two packages; a WAL journal written by either
package's store replayed by either; and the port's StoreSession resyncing
after crash_store and a restart (tests/test_session_resync.py), against
either store. Everything runs on 127.0.0.1 with port 0. Lease TTLs are
10 s wherever expiry is not what a case tests, and expiry cases poll
with a deadline."""
import asyncio
import json
import types

import pytest

import dynamo_tpu.runtime.client as rclient
import dynamo_tpu.runtime.component as rcomponent
import dynamo_tpu.runtime.endpoint as rendpoint
import dynamo_tpu.runtime.protocol as rprotocol
import dynamo_tpu.runtime.store as rstore
import dynamo_tpu_torch.runtime.client as pclient
import dynamo_tpu_torch.runtime.component as pcomponent
import dynamo_tpu_torch.runtime.endpoint as pendpoint
import dynamo_tpu_torch.runtime.protocol as pprotocol
import dynamo_tpu_torch.runtime.store as pstore
from dynamo_tpu_torch.runtime.session import StoreSession

PKG = {
    "port": types.SimpleNamespace(
        store=pstore, client=pclient, endpoint=pendpoint,
        component=pcomponent, protocol=pprotocol),
    "ref": types.SimpleNamespace(
        store=rstore, client=rclient, endpoint=rendpoint,
        component=rcomponent, protocol=rprotocol),
}
BOTH = pytest.mark.parametrize("pk", ["port", "ref"])
PAIRS = pytest.mark.parametrize(
    "sp,cp", [("port", "port"), ("port", "ref"), ("ref", "port"),
              ("ref", "ref")])
TTL = 10.0  # where expiry is not what a case tests


async def _until(pred, timeout=10.0, what="condition"):
    """Poll ``pred`` (sync or async) until true, within ``timeout``."""
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        got = pred()
        if asyncio.iscoroutine(got):
            got = await got
        if got:
            return got
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.02)


async def _start(pk, port=0, **kw):
    server, store = await PKG[pk].store.serve_store(
        port=port, sweep_interval_s=0.05, **kw)
    return server, store, server.sockets[0].getsockname()[1]


# ---------------------------------------------------------------------------
# frames

PAYLOADS = [
    {},
    {"op": "put", "key": "dynamo://ns/_models/m/7", "value": "{\"a\": 1}",
     "lease": 7, "req_id": 3},
    {"op": "watch", "prefix": "dynamo://", "req_id": 2**40},
    {"ok": True, "kvs": [["k", "v", 0], ["k2", "", 12]], "req_id": 1},
    {"data": {"token_ids": [1, 2, 3], "text": None, "finish_reason": "eos",
              "annotations": {}}},
    {"error": "boom", "done": True, "retriable": True, "overloaded": True,
     "retry_after_s": 0.25, "tenant": "t"},
    {"unicode": "héllo ✓ 日本", "float": 1.5e-7, "neg": -3, "nested": [[]]},
]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_frames_are_byte_equal(i):
    msg = PAYLOADS[i]
    assert pprotocol.encode_frame(msg) == rprotocol.encode_frame(msg)
    for payload in (b"", b"\x00\xff" * 1000):
        assert (pprotocol.encode_frame2(msg, payload)
                == rprotocol.encode_frame2(msg, payload))
        assert (pprotocol.encode_frame2_header(msg, len(payload))
                == rprotocol.encode_frame2_header(msg, len(payload)))

    async def read_back():
        for writer, reader in ((rprotocol, pprotocol), (pprotocol, rprotocol)):
            r = asyncio.StreamReader()
            r.feed_data(writer.encode_frame(msg)
                        + writer.encode_frame2(msg, b"xyz"))
            r.feed_eof()
            assert await reader.read_frame(r) == msg
            assert await reader.read_frame2(r) == (msg, b"xyz")
            with pytest.raises(asyncio.IncompleteReadError):
                await reader.read_frame(r)

    asyncio.run(read_back())
    dec = pprotocol.FrameDecoder()
    blob = rprotocol.encode_frame(msg) * 2
    assert dec.feed(blob[:3]) == [] and dec.feed(blob[3:]) == [msg, msg]


# ---------------------------------------------------------------------------
# store core (no sockets), both packages


@BOTH
def test_store_kv_and_prefix(pk):
    s = PKG[pk].store.KvStore()
    s.put("a/1", "x")
    s.put("a/2", "y")
    s.put("b/1", "z")
    assert s.get("a/1") == ("x", 0)
    assert [k for k, _, _ in s.get_prefix("a/")] == ["a/1", "a/2"]
    assert s.delete("a/1") == 1
    assert s.delete("a/1") == 0
    assert s.delete_prefix("a/") == 1
    assert s.get_prefix("a/") == []
    assert s.revision == 5


@BOTH
def test_store_lease_expiry_deletes_keys(pk):
    now = [0.0]
    s = PKG[pk].store.KvStore(clock=lambda: now[0])
    lease = s.lease_grant(ttl=5.0)
    s.put("w/1", "alive", lease=lease)
    events = []
    s.watch("w/", events.append)
    now[0] = 4.0
    assert s.sweep_leases() == []
    assert s.lease_keepalive(lease)
    now[0] = 8.9
    assert s.sweep_leases() == []
    now[0] = 9.1
    assert s.sweep_leases() == [lease]
    assert s.get("w/1") is None
    assert events == [{"watch": events[0]["watch"], "event": "delete",
                       "key": "w/1"}]


@BOTH
def test_store_pubsub_wildcard(pk):
    s = PKG[pk].store.KvStore()
    got = []
    s.subscribe("kv_events.>", got.append)
    assert s.publish("kv_events.w0", "e1") == 1
    assert s.publish("other.topic", "e2") == 0
    assert got[0]["value"] == "e1"


@BOTH
def test_store_queue_fifo_core(pk):
    s = PKG[pk].store.KvStore()
    assert s.qlen("q") == 0
    assert s.qpop("q") is None
    assert s.qpush("q", "a") == 1
    assert s.qpush("q", "b") == 2
    assert s.qpop("q") == "a"
    assert s.qpop("q") == "b"
    assert s.qpop("q") is None


@BOTH
def test_put_on_expired_lease_rejected_before_sweep(pk):
    now = [0.0]
    s = PKG[pk].store.KvStore(clock=lambda: now[0])
    lease = s.lease_grant(ttl=1.0)
    s.put("w/1", "v", lease=lease)
    now[0] = 1.5
    with pytest.raises(KeyError):
        s.put("w/2", "v", lease=lease)
    assert not s.lease_keepalive(lease)
    assert s.get("w/1") is None


# ---------------------------------------------------------------------------
# store server x client over TCP, every pairing


@PAIRS
async def test_client_kv_watch_pubsub(sp, cp):
    server, store, port = await _start(sp)
    KvClient = PKG[cp].client.KvClient
    c = await KvClient(port=port).connect()
    await c.put("m/a", "1")
    assert await c.get("m/a") == "1"
    assert await c.get("m/missing") is None
    assert await c.delete("m/missing") == 0
    w = await c.watch_prefix("m/")
    assert [k for k, _, _ in w.initial] == ["m/a"]
    await c.put("m/b", "2")
    ev = await asyncio.wait_for(w.__anext__(), 5)
    assert (ev["event"], ev["key"], ev["value"]) == ("put", "m/b", "2")
    assert await c.delete_prefix("m/") == 2
    evs = [await asyncio.wait_for(w.__anext__(), 5) for _ in range(2)]
    assert {(e["event"], e["key"]) for e in evs} == {
        ("delete", "m/a"), ("delete", "m/b")}

    sub = await c.subscribe("events.>")
    c2 = await PKG[sp].client.KvClient(port=port).connect()
    assert await c2.publish("events.x", "hello") == 1
    ev = await asyncio.wait_for(sub.__anext__(), 5)
    assert (ev["topic"], ev["value"]) == ("events.x", "hello")
    await sub.cancel()
    assert await c2.publish("events.x", "again") == 0
    await c.close()
    await c2.close()
    server.close()


@PAIRS
async def test_lease_keepalive_and_crash_expiry(sp, cp):
    server, store, port = await _start(sp)
    c = await PKG[cp].client.KvClient(port=port).connect()
    lease = await c.lease_grant(0.3)
    await c.put("inst/1", "up", lease=lease.id)
    watcher = await PKG[cp].client.KvClient(port=port).connect()
    w = await watcher.watch_prefix("inst/")
    # keep-alive holds the key past several TTLs
    t_end = asyncio.get_running_loop().time() + 1.0
    while asyncio.get_running_loop().time() < t_end:
        assert await c.get("inst/1") == "up"
        await asyncio.sleep(0.1)
    # simulated crash: beats stop, the connection stays open; the lease
    # must expire by TTL
    lease._task.cancel()
    ev = await asyncio.wait_for(w.__anext__(), 10)
    assert ev["event"] == "delete" and ev["key"] == "inst/1"
    assert await c.get("inst/1") is None
    await c.close()
    await watcher.close()
    server.close()


@PAIRS
async def test_put_with_stale_lease_is_in_band_error(sp, cp):
    server, store, port = await _start(sp)
    cl = PKG[cp].client
    c = await cl.KvClient(port=port).connect()
    w = await c.watch_prefix("k/")
    with pytest.raises(cl.StoreError, match="lease not found"):
        await c.put("k/x", "v", lease=999999)
    assert await c.ping()
    await c.put("k/y", "1")
    ev = await asyncio.wait_for(w.__anext__(), 5)
    assert (ev["event"], ev["key"]) == ("put", "k/y")
    assert not await c.lease_keepalive(999999)
    await c.close()
    server.close()


@PAIRS
async def test_watch_snapshot_is_atomic_with_registration(sp, cp):
    server, store, port = await _start(sp)
    KvClient = PKG[cp].client.KvClient
    writer = await KvClient(port=port).connect()
    await writer.put("a/0", "x")
    for i in range(1, 6):
        c = await KvClient(port=port).connect()
        put_task = asyncio.create_task(writer.put(f"a/{i}", "y"))
        w = await c.watch_prefix("a/")
        await put_task
        seen = {k for k, _, _ in w.initial}
        if f"a/{i}" not in seen:
            ev = await asyncio.wait_for(w.__anext__(), 5)
            assert ev["key"] == f"a/{i}"
        await c.close()
    await writer.close()
    server.close()


@PAIRS
async def test_lease_keepalive_retries_transient_failures(sp, cp):
    server, store, port = await _start(sp)
    c = await PKG[cp].client.KvClient(port=port).connect()
    lease = await c.lease_grant(1.5)
    real = c.lease_keepalive
    calls = {"fail": 1, "ok": 0}

    async def flaky(lease_id):
        if calls["fail"] > 0:
            calls["fail"] -= 1
            raise ConnectionError("transient blip")
        calls["ok"] += 1
        return await real(lease_id)

    c.lease_keepalive = flaky
    await _until(lambda: calls["ok"] >= 2, what="two beats after the blip")
    assert not lease.lost.is_set()
    assert store.lease_keepalive(lease.id)
    await lease.revoke()
    assert not store.lease_alive(lease.id)
    await c.close()
    server.close()


@PAIRS
async def test_queue_longpoll_and_fifo_over_wire(sp, cp):
    server, store, port = await _start(sp)
    KvClient = PKG[cp].client.KvClient
    producer = await KvClient(port=port).connect()
    consumer = await KvClient(port=port).connect()
    await producer.qpush("prefill", "job1")
    await producer.qpush("prefill", "job2")
    assert await producer.qlen("prefill") == 2
    assert await consumer.qpop("prefill") == "job1"
    pop_task = asyncio.create_task(consumer.qpop("prefill2", timeout_s=10))
    await _until(lambda: store._qwaiters.get("prefill2"), what="parked pop")
    assert await producer.qpush("prefill2", "job3") == 0
    assert await asyncio.wait_for(pop_task, 5) == "job3"
    assert await consumer.qpop("empty-q", timeout_s=0.2) is None
    c2 = await KvClient(port=port).connect()
    p1 = asyncio.create_task(consumer.qpop("q3", timeout_s=10))
    await _until(lambda: len(store._qwaiters.get("q3", ())) == 1)
    p2 = asyncio.create_task(c2.qpop("q3", timeout_s=10))
    await _until(lambda: len(store._qwaiters.get("q3", ())) == 2)
    await producer.qpush("q3", "first")
    await producer.qpush("q3", "second")
    assert await asyncio.wait_for(p1, 5) == "first"
    assert await asyncio.wait_for(p2, 5) == "second"
    await producer.close()
    await consumer.close()
    await c2.close()
    server.close()


@PAIRS
async def test_object_store_roundtrip(sp, cp):
    server, store, port = await _start(sp)
    c = await PKG[cp].client.KvClient(port=port).connect()
    obj = PKG[cp].client.ObjectStore(c)
    blob = bytes(range(256)) * 3
    await obj.put("cards", "llama-8b", blob)
    assert await obj.get("cards", "llama-8b") == blob
    assert await obj.get("cards", "missing") is None
    await obj.put("cards", "other", b"x")
    assert sorted(await obj.list("cards")) == ["llama-8b", "other"]
    await obj.delete("cards", "other")
    assert await obj.list("cards") == ["llama-8b"]
    # the other package's object store reads the same object
    other = "ref" if cp == "port" else "port"
    assert await PKG[other].client.ObjectStore(c).get(
        "cards", "llama-8b") == blob
    await c.close()
    server.close()


# ---------------------------------------------------------------------------
# endpoint data plane: one package's server, the other's caller


@PAIRS
async def test_endpoint_stream_and_error(sp, cp):
    async def handler(payload):
        for i in range(payload["n"]):
            yield {"i": i}
        if payload.get("boom"):
            raise RuntimeError("boom")
        if payload.get("retry"):
            raise ConnectionError("draining")
        if payload.get("shed"):
            raise PKG[sp].endpoint.EngineOverloadedError(
                "full", retry_after_s=0.5, tenant="t")

    ep = PKG[cp].endpoint
    srv = PKG[sp].endpoint.EndpointServer(handler)
    host, port = await srv.start()
    got = [m async for m in ep.call_endpoint(host, port, {"n": 3})]
    assert got == [{"i": 0}, {"i": 1}, {"i": 2}]
    with pytest.raises(ep.EndpointStreamError, match="boom") as e:
        async for _ in ep.call_endpoint(host, port, {"n": 1, "boom": True}):
            pass
    assert not isinstance(e.value, ConnectionError)
    with pytest.raises(ep.EndpointConnectionError, match="draining"):
        async for _ in ep.call_endpoint(host, port, {"n": 0, "retry": True}):
            pass
    with pytest.raises(ep.EngineOverloadedError) as e:
        async for _ in ep.call_endpoint(host, port, {"n": 0, "shed": True}):
            pass
    assert (e.value.retry_after_s, e.value.tenant) == (0.5, "t")
    await srv.stop()


@PAIRS
async def test_endpoint_client_drop_cancels_handler(sp, cp):
    cancelled = asyncio.Event()

    async def handler(payload):
        try:
            for i in range(10_000):
                await asyncio.sleep(0.01)
                yield {"i": i}
        finally:
            cancelled.set()

    srv = PKG[sp].endpoint.EndpointServer(handler)
    host, port = await srv.start()
    stream = PKG[cp].endpoint.call_endpoint(host, port, {})
    assert (await stream.__anext__())["i"] == 0
    await stream.aclose()
    await asyncio.wait_for(cancelled.wait(), 10)
    await srv.stop()


@PAIRS
async def test_component_discovery_and_failover(sp, cp):
    """Workers registered through package sp's runtime, discovered and
    routed by package cp's EndpointClient (each side on its own store
    connection); the store is the port's."""
    server, store, port = await _start("port")
    rt = await PKG[sp].component.DistributedRuntime.connect(port=port)
    ep = rt.namespace("test").component("worker").endpoint("generate")

    def make_handler(tag):
        async def handler(payload):
            yield {"from": tag, "echo": payload.get("x")}
        return handler

    w0 = await ep.serve(make_handler("w0"), worker_id="w0", lease_ttl_s=0.3)
    w1 = await ep.serve(make_handler("w1"), worker_id="w1", lease_ttl_s=0.3)
    client_rt = await PKG[cp].component.DistributedRuntime.connect(port=port)
    cl = await client_rt.namespace("test").component("worker").endpoint(
        "generate").client()
    changes = []
    cl.on_change = changes.append
    await cl.wait_for_instances(2)
    assert sorted(i.worker_id for i in cl.instances.values()) == ["w0", "w1"]

    seen = []
    for _ in range(4):
        async for m in cl.generate({"x": 1}):
            seen.append(m["from"])
    assert sorted(seen) == ["w0", "w0", "w1", "w1"]
    async for m in cl.generate({"x": 1}, mode="direct",
                               instance_id=w1.lease_id):
        assert m["from"] == "w1"
    cl.instance_filter = lambda inst: inst.worker_id == "w0"
    for _ in range(2):
        async for m in cl.generate({"x": 1}, mode="random"):
            assert m["from"] == "w0"
    cl.instance_filter = None

    await w0.shutdown()
    await _until(lambda: len(cl.instances) == 1, what="w0 deregistered")
    assert changes and len(changes[-1]) == 1
    for _ in range(3):
        async for m in cl.generate({"x": 2}):
            assert m["from"] == "w1"
    # crash: w1's keep-alive stops without a revoke; expiry evicts it
    w1.lease._task.cancel()
    await _until(lambda: not cl.instances, what="w1 expired")
    with pytest.raises(ConnectionError):
        async for m in cl.generate({"x": 3}):
            pass
    await cl.stop()
    await client_rt.close()
    await w1.server.stop()
    await rt.close()
    server.close()


# ---------------------------------------------------------------------------
# the WAL journal, written by one package's store and replayed by the other

WAL_PAIRS = pytest.mark.parametrize(
    "wp,rp", [("port", "port"), ("port", "ref"), ("ref", "port"),
              ("ref", "ref")])


def _open(pk, path, **kw):
    return PKG[pk].store.KvStore(journal_path=str(path), **kw)


@WAL_PAIRS
def test_wal_replay_serves_identical_keys_and_queues(tmp_path, wp, rp):
    jp = tmp_path / "store.wal"
    s1 = _open(wp, jp)
    s1.put("a/1", "x")
    s1.put("a/2", "y")
    s1.put("b/1", "z")
    s1.delete("b/1")
    for i in range(5):
        s1.qpush("q", f"item-{i}")
    assert s1.qpop("q") == "item-0"
    want_keys = [(k, v) for k, v, _ in s1.get_prefix("")]
    s1.close_journal()
    s2 = _open(rp, jp)
    assert [(k, v) for k, v, _ in s2.get_prefix("")] == want_keys
    assert [s2.qpop("q") for _ in range(4)] == [
        f"item-{i}" for i in range(1, 5)]
    assert s2.qpop("q") is None
    assert (s2.replayed_keys, s2.replayed_queue_items, s2.torn_records) \
        == (2, 4, 0)


@WAL_PAIRS
def test_wal_replay_lease_bound_keys_rebinds_and_revokes(tmp_path, wp, rp):
    jp = tmp_path / "store.wal"
    s1 = _open(wp, jp)
    keep = s1.lease_grant(ttl=30.0)
    gone = s1.lease_grant(ttl=30.0)
    other = s1.lease_grant(ttl=30.0)
    s1.put("w/keep", "a", lease=keep)
    s1.put("w/gone", "b", lease=gone)
    s1.put("w/k", "v1", lease=keep)
    s1.put("w/k", "v2", lease=other)  # rebound off `keep`
    s1.put("w/free", "u", lease=keep)
    s1.put("w/free", "u")             # rebound to no lease
    s1.lease_revoke(gone)
    s1.close_journal()
    s2 = _open(rp, jp)
    assert s2.get("w/keep") == ("a", keep)
    assert s2.get("w/gone") is None
    assert s2.lease_grant(ttl=1.0) > other  # no id reuse after a restart
    s2.lease_revoke(keep)
    assert s2.get("w/keep") is None
    assert s2.get("w/k") == ("v2", other)
    assert s2.get("w/free") == ("u", 0)
    s2.lease_revoke(other)
    assert s2.get("w/k") is None


@WAL_PAIRS
def test_wal_replay_restores_revision(tmp_path, wp, rp):
    jp = tmp_path / "store.wal"
    s1 = _open(wp, jp)
    s1.put("a/1", "x")
    s1.put("a/1", "y")
    s1.put("a/2", "z")
    s1.delete("a/2")
    assert s1.revision == 4
    s1.close_journal()
    s2 = _open(rp, jp)          # replays per-record revs, then compacts
    assert s2.revision == 4
    s2.close_journal()
    s3 = _open(wp, jp)          # the compacted journal's meta line
    assert s3.revision == 4
    assert s3.put("a/3", "w") == 5


@WAL_PAIRS
def test_wal_replay_grants_lease_grace(tmp_path, wp, rp):
    jp = tmp_path / "store.wal"
    now = [0.0]
    s1 = PKG[wp].store.KvStore(clock=lambda: now[0], journal_path=str(jp))
    lease = s1.lease_grant(ttl=0.5)
    s1.put("w/1", "alive", lease=lease)
    s1.close_journal()
    now[0] = 100.0
    s2 = PKG[rp].store.KvStore(clock=lambda: now[0], journal_path=str(jp),
                               lease_grace_s=10.0)
    assert s2.get("w/1") is not None
    now[0] = 105.0
    assert s2.sweep_leases() == []
    assert s2.lease_keepalive(lease)
    now[0] = 105.4
    assert s2.sweep_leases() == []
    now[0] = 120.0
    assert s2.sweep_leases() == [lease]
    assert s2.get("w/1") is None


@WAL_PAIRS
def test_wal_torn_tail_is_skipped_not_fatal(tmp_path, wp, rp):
    jp = tmp_path / "store.wal"
    s1 = _open(wp, jp)
    s1.put("a/1", "x")
    s1.put("a/2", "y")
    s1.close_journal()
    with open(jp, "a", encoding="utf-8") as f:
        f.write('{"op":"put","key":"a/3","val')
    s2 = _open(rp, jp)
    assert s2.torn_records == 1
    assert [k for k, _, _ in s2.get_prefix("a/")] == ["a/1", "a/2"]
    s2.put("a/4", "w")
    s2.close_journal()
    s3 = _open(wp, jp)
    assert [k for k, _, _ in s3.get_prefix("a/")] == ["a/1", "a/2", "a/4"]


@WAL_PAIRS
def test_wal_compaction_bounds_journal_and_orders_grants(tmp_path, wp, rp):
    jp = tmp_path / "store.wal"
    s1 = _open(wp, jp)
    lease = s1.lease_grant(ttl=30.0)
    for i in range(2000):
        s1.put("hot/key", f"v{i}", lease=lease if i % 2 else 0)
    s1.compact_journal()
    s1.close_journal()
    lines = jp.read_text(encoding="utf-8").splitlines()
    assert len(lines) < 600, len(lines)
    assert json.loads(lines[0])["dcp_wal"] == 1
    ops = [json.loads(line).get("op") for line in lines[1:]]
    assert ops.index("lease_grant") < ops.index("put")
    s2 = _open(rp, jp)
    assert s2.get("hot/key") == ("v1999", lease)
    s2.lease_revoke(lease)
    assert s2.get("hot/key") is None


@pytest.mark.parametrize("fsync_mode", ["always", "batch"])
def test_both_packages_write_the_same_journal(tmp_path, fsync_mode):
    """The same mutations give byte-equal journals, before and after a
    compaction, in either fsync mode."""
    texts = []
    for pk in ("port", "ref"):
        jp = tmp_path / f"{pk}.wal"
        s = _open(pk, jp, fsync_mode=fsync_mode)
        lease = s.lease_grant(ttl=12.5)
        s.put("w/1", "x", lease=lease)
        s.put("k", "héllo")
        s.qpush("q", "a")
        s.qpush("q", "b")
        s.qpop("q")
        s.delete("k")
        s.lease_revoke(lease)
        s.close_journal()
        before = jp.read_bytes()
        s.compact_journal()
        texts.append((before, jp.read_bytes()))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("wp", ["port", "ref"])
async def test_journaled_server_restart_across_packages(tmp_path, wp):
    """A store served by one package, crashed, and restarted from its
    journal by the other keeps the lease-bound registration."""
    rp = "ref" if wp == "port" else "port"
    jp = str(tmp_path / "store.wal")
    server, store, port = await _start(wp, journal_path=jp)
    c = await PKG[wp].client.KvClient(port=port).connect()
    lease = await c.lease_grant(TTL, keepalive=False)
    await c.put("reg/1", "v", lease=lease.id)
    await c.qpush("jobs", "j1")
    PKG[wp].store.crash_store(server)
    await c.close()
    server2, store2, _ = await _start(rp, port=port, journal_path=jp)
    c2 = await PKG[rp].client.KvClient(port=port).connect()
    assert await c2.get("reg/1") == "v"
    assert await c2.lease_keepalive(lease.id)
    assert await c2.qpop("jobs") == "j1"
    assert store2.replayed_keys == 1
    await c2.close()
    server2.close()
    store2.close_journal()


# ---------------------------------------------------------------------------
# the port's StoreSession through a crash_store and a restart


async def _wait_resynced(sess, n=1):
    await _until(lambda: not sess.degraded and sess.resyncs >= n,
                 what="session resynced")


@BOTH
async def test_rewatch_synthesizes_put_and_delete_deltas(pk):
    server, store, port = await _start(pk)
    sess = await StoreSession(port=port).connect()
    server2 = None
    try:
        await sess.put("p/stays", "same")
        await sess.put("p/dies", "old")
        await sess.put("p/changes", "v1")
        watch = await sess.watch_prefix("p/")
        assert {k for k, _, _ in watch.initial} == {
            "p/stays", "p/dies", "p/changes"}
        states = []
        sess.add_state_listener(states.append)
        PKG[pk].store.crash_store(server)
        await _until(lambda: sess.degraded, what="degraded")
        s2 = PKG[pk].store.KvStore()
        s2.put("p/stays", "same")
        s2.put("p/changes", "v2")
        s2.put("p/born", "new")
        server2, _, _ = await _start(pk, port=port, store=s2)
        await _wait_resynced(sess)
        assert states == [False, True, False]
        events = [await asyncio.wait_for(watch.__anext__(), 5)
                  for _ in range(3)]
        assert {(e["event"], e["key"]) for e in events} == {
            ("delete", "p/dies"), ("put", "p/changes"), ("put", "p/born")}
        assert all(e.get("synthetic") for e in events)
        assert watch.queue.empty()
        s2.put("p/after", "x")
        ev = await asyncio.wait_for(watch.__anext__(), 5)
        assert (ev["event"], ev["key"]) == ("put", "p/after")
        assert not ev.get("synthetic")
    finally:
        await sess.close()
        if server2 is not None:
            server2.close()


@BOTH
async def test_journaled_restart_reclaims_same_lease(tmp_path, pk):
    jp = str(tmp_path / "store.wal")
    server, store, port = await _start(pk, journal_path=jp)
    sess = await StoreSession(port=port).connect()
    server2 = store2 = None
    try:
        lease = await sess.lease_grant(TTL)
        old_id = lease.id
        key = f"dynamo://t/_components/c/e/{old_id}"
        await sess.put(key, "reg", lease=old_id)
        PKG[pk].store.crash_store(server)
        server2, store2, _ = await _start(pk, port=port, journal_path=jp)
        await _wait_resynced(sess)
        assert lease.id == old_id
        assert store2.replayed_keys == 1
        assert await sess.get(key) == "reg"
        assert not lease.lost.is_set()
        assert lease.inner._task is not None and not lease.inner._task.done()
        assert await sess.lease_keepalive(old_id)
    finally:
        await sess.close()
        if server2 is not None:
            server2.close()
            store2.close_journal()


@BOTH
async def test_fresh_restart_regrants_and_reputs_keys(pk):
    server, store, port = await _start(pk)
    sess = await StoreSession(port=port).connect()
    server2 = None
    try:
        # a lease id the fresh store will not hand out first
        for _ in range(3):
            await sess.lease_revoke((await sess.lease_grant(TTL)).id)
        lease = await sess.lease_grant(TTL)
        old_id = lease.id
        await sess.put(f"dynamo://t/_components/c/e/{old_id}", "reg",
                       lease=old_id)
        rekeys = []
        lease.on_rekey.append(lambda o, n: rekeys.append((o, n)))
        PKG[pk].store.crash_store(server)
        server2, store2, _ = await _start(pk, port=port)  # an empty store
        await _wait_resynced(sess)
        regs = await sess.get_prefix("dynamo://t/_components/c/e/")
        assert [(k, v) for k, v, _ in regs] == [
            (f"dynamo://t/_components/c/e/{lease.id}", "reg")]
        assert lease.id != old_id and rekeys == [(old_id, lease.id)]
        assert not lease.lost.is_set()
        await sess.lease_revoke(lease.id)
        assert await sess.get_prefix("dynamo://t/_components/c/e/") == []
    finally:
        await sess.close()
        if server2 is not None:
            server2.close()


@BOTH
async def test_server_side_lease_loss_regrants_while_connected(pk):
    server, store, port = await _start(pk)
    sess = await StoreSession(port=port).connect()
    try:
        lease = await sess.lease_grant(1.5)
        key = f"dynamo://t/_components/c/e/{lease.id}"
        await sess.put(key, "reg", lease=lease.id)
        store.lease_revoke(lease.id)
        assert store.get(key) is None
        regs = await _until(
            lambda: sess.get_prefix("dynamo://t/_components/c/e/"),
            what="re-registered")
        assert [(k, v) for k, v, _ in regs] == [
            (f"dynamo://t/_components/c/e/{lease.id}", "reg")]
    finally:
        await sess.close()
        server.close()


async def test_session_close_leaves_no_stray_tasks():
    base = set(asyncio.all_tasks())
    server, store, port = await _start("port")
    sess = await StoreSession(port=port).connect()
    await sess.lease_grant(TTL)
    watch = await sess.watch_prefix("p/")
    sub = await sess.subscribe("topic.>")
    await sess.close()
    server.close()
    await server.wait_closed()
    await asyncio.sleep(0.05)
    leftover = [t for t in asyncio.all_tasks()
                if t not in base and t is not asyncio.current_task()
                and not t.done()]
    assert not leftover, leftover
    with pytest.raises(StopAsyncIteration):
        await watch.__anext__()
    with pytest.raises(StopAsyncIteration):
        await sub.__anext__()


async def test_publisher_rekey_rewrites_queued_payloads():
    from dynamo_tpu_torch.kv_router.protocols import (
        ForwardPassMetrics,
        KvCacheEvent,
        KvEventKind,
    )
    from dynamo_tpu_torch.runtime.publisher import (
        KvEventPublisher,
        WorkerMetricsPublisher,
    )

    class _Kv:
        def __init__(self):
            self.published = []

        async def publish(self, topic, value):
            self.published.append((topic, json.loads(value)))

    kv = _Kv()
    pub = KvEventPublisher(kv, "111")
    pub(KvCacheEvent(kind=KvEventKind.REMOVED, removed_hashes=[7]))
    pub.rekey("222", "kv_events.222")
    pub.start()
    await _until(lambda: kv.published)
    await pub.stop()
    assert [(t, p["worker_id"]) for t, p in kv.published] == [
        ("kv_events.222", "222")]
    # the metrics publisher throttles to min_interval_s and flushes the
    # trailing sample under the rekeyed id
    kv2 = _Kv()
    mpub = WorkerMetricsPublisher(kv2, "5", min_interval_s=0.2)
    mpub.start()
    mpub(ForwardPassMetrics())
    mpub(ForwardPassMetrics())   # inside the interval: held as trailing
    mpub.rekey("6", "load_metrics.6")
    await _until(lambda: len(kv2.published) == 2)
    await mpub.stop()
    assert [(t, p["worker_id"]) for t, p in kv2.published] == [
        ("load_metrics.6", "6"), ("load_metrics.6", "6")]
