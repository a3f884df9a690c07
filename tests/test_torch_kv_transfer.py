"""The port's KV transfer plane (dynamo_tpu_torch/kv_transfer.py) against
the JAX package's.

- Codec: f32, bf16 and int8-with-scales pages round-trip through the
  port's server and clients byte for byte; a frame whose geometry does
  not match its byte count is nacked in-band (the connection stays
  usable), and a corrupted payload is nacked as ``KvIntegrityError`` by
  both packages' servers and raised as such by both packages' clients.
- Headers: for the same pages (from a numpy seed) the port's frame header
  equals the JAX package's key for key and in order (``kv_scales``,
  ``kv_scales_shape``, ``kv_crc``, ``shape``, ``dtype``), and the payload
  bytes are equal. bf16 uses the JAX package's ml_dtypes on its side
  only.
- Across the packages, both ways and in dense and int8 KV: a port
  BlockTransferServer over a tiny f32 TorchEngine answers the JAX
  package's ``write_remote_pages``, ``write_pages_stream``,
  ``read_remote_pages``, ``probe_remote_hashes`` and
  ``read_remote_hashes`` (monolithic and chunked), and a JAX server over
  TpuEngine answers the port's; every page and scale moved is
  byte-equal to what the serving engine exports.
- Descriptors published by one package are read by the other.
- The engine's ``export_pages_stream`` chunks concatenate to its
  ``export_pages``."""
import asyncio

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu import kv_transfer as jkt
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.kv_integrity import KvIntegrityError as JKvIntegrityError
from dynamo_tpu.kv_quant import QuantizedPages as JQuantizedPages
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.runtime.client import KvClient as JKvClient
from dynamo_tpu_torch import kv_transfer as tkt
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.kv_integrity import KvIntegrityError
from dynamo_tpu_torch.kv_quant import QuantizedPages
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.protocol import encode_frame2, read_frame2
from dynamo_tpu_torch.runtime.store import serve_store
from dynamo_tpu_torch.tokens import compute_block_hashes

PS = 16
L, KVH, HD = 2, 2, 8
KW = dict(num_pages=32, page_size=PS, max_pages_per_seq=8,
          max_decode_slots=2, prefill_buckets=(32, 64),
          cache_dtype="float32")
PROMPT = list(range(1, 70))      # 4 full blocks + 5 tokens


def raw(x) -> bytes:
    if isinstance(x, (QuantizedPages, JQuantizedPages)):
        return raw(x.data) + raw(x.scales)
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def pages_np(kind, n, seed=0):
    """Random pages [2, L, kvh, n, ps, hd] from a numpy seed: f32, bf16
    (ml_dtypes) or an int8 (data, scales) pair."""
    rng = np.random.default_rng(seed)
    shape = (2, L, KVH, n, PS, HD)
    if kind == "int8":
        return (rng.integers(-127, 128, size=shape).astype(np.int8),
                rng.uniform(0.01, 0.1, size=(2, L, n)).astype(np.float32))
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if kind == "bf16" else a


def as_port(kind, p):
    if kind == "int8":
        return QuantizedPages(torch.from_numpy(p[0]), torch.from_numpy(p[1]))
    if kind == "bf16":
        return torch.from_numpy(p.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(p)


def as_ref(kind, p):
    return JQuantizedPages(*p) if kind == "int8" else p


# ---------------------------------------------------------------------------
# codec


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_headers_match_the_reference_key_for_key(kind):
    p = pages_np(kind, 3)
    t_payload, t_fields = tkt._array_header(as_port(kind, p))
    j_payload, j_fields = jkt._array_header(as_ref(kind, p))
    assert list(t_fields) == list(j_fields)
    assert t_fields == j_fields
    assert t_fields["dtype"] == {"f32": "float32", "bf16": "bfloat16",
                                 "int8": "int8"}[kind]
    assert raw(t_payload) == raw(j_payload)
    if kind == "int8":
        assert t_fields["kv_scales"] == j_fields["kv_scales"]
    # and the decoded frame is the same value in both packages
    hdr = {"ok": True, **t_fields}
    got = tkt._decode_payload(hdr, bytearray(raw(t_payload)), copy=True,
                              verify=True)
    want = jkt._decode_payload(hdr, raw(j_payload), copy=True, verify=True)
    assert raw(got) == raw(want) == raw(as_port(kind, p))


def _dict_server(mod, store):
    """A transfer server of package ``mod`` over a dict of pages."""
    def read_fn(pages):
        return store[tuple(pages)]

    def write_fn(pages, data, job=None):
        store[tuple(pages)] = data

    return mod.BlockTransferServer(read_fn=read_fn, write_fn=write_fn)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
async def test_codec_round_trips_both_ways(kind):
    p = pages_np(kind, 3, seed=1)
    pages = [5, 6, 7]
    # the port's clients against the port's server and the JAX server
    for smod in (tkt, jkt):
        store = {}
        srv = _dict_server(smod, store)
        host, port = await srv.start()
        try:
            value = as_port(kind, p)
            await tkt.write_remote_pages(host, port, pages, value, job_id="j")
            assert raw(store[tuple(pages)]) == raw(value)
            got = await tkt.read_remote_pages(host, port, pages)
            assert raw(got) == raw(value)
            assert type(got) is (QuantizedPages if kind == "int8"
                                 else torch.Tensor)
            chunks = [([5], value.slice_pages(0, 1) if kind == "int8"
                       else value[:, :, :, :1]),
                      ([6, 7], value.slice_pages(1, 3) if kind == "int8"
                       else value[:, :, :, 1:])]
            store.clear()
            assert await tkt.write_pages_stream(host, port, chunks) == 2
            assert raw(store[(6, 7)]) == raw(chunks[1][1])
        finally:
            await srv.stop()
    # the JAX package's clients against the port's server
    store = {}
    srv = _dict_server(tkt, store)
    host, port = await srv.start()
    try:
        await jkt.write_remote_pages(host, port, pages, as_ref(kind, p))
        assert raw(store[tuple(pages)]) == raw(as_port(kind, p))
        assert raw(await jkt.read_remote_pages(host, port, pages)) == raw(
            as_port(kind, p))
    finally:
        await srv.stop()


async def test_malformed_geometry_is_nacked_in_band():
    store = {}
    srv = _dict_server(tkt, store)
    host, port = await srv.start()
    try:
        reader, writer = await asyncio.open_connection(host, port)
        # 4 x f32 declared, 12 bytes sent
        writer.write(encode_frame2(
            {"op": "write_pages", "pages": [1], "shape": [4],
             "dtype": "float32"}, b"\0" * 12))
        await writer.drain()
        header, _ = await read_frame2(reader)
        assert header["ok"] is False and header["kind"] == "frame"
        assert "declares 16 payload bytes, got 12" in header["error"]
        # an unknown dtype, then a good frame: the connection stays usable
        writer.write(encode_frame2(
            {"op": "write_pages", "pages": [1], "shape": [1],
             "dtype": "complex512"}, b"\0" * 8))
        ok = torch.arange(4, dtype=torch.float32)
        tkt._write_array_frame(writer, {"op": "write_pages", "pages": [2]},
                               ok)
        await writer.drain()
        bad, _ = await read_frame2(reader)
        good, _ = await read_frame2(reader)
        assert bad["ok"] is False and bad["kind"] == "frame"
        assert good == {"ok": True}
        assert raw(store[(2,)]) == raw(ok)
        writer.close()
        assert not any(k == (1,) for k in store)
    finally:
        await srv.stop()


def _corrupt(data):
    """A copy of a payload (array, tensor or bundle) with one bit flipped
    in its first page."""
    if isinstance(data, (QuantizedPages, JQuantizedPages)):
        return type(data)(_corrupt(data.data), data.scales)
    if isinstance(data, torch.Tensor):
        dirty = data.clone()
        dirty.view(torch.uint8).reshape(-1)[3] ^= 4
        return dirty
    dirty = np.array(data, copy=True)
    dirty.view(np.uint8).reshape(-1)[3] ^= 4
    return dirty


@pytest.mark.parametrize("kind", ["f32", "int8"])
async def test_corrupted_payload_is_refused_as_integrity_error(
        kind, monkeypatch):
    p = pages_np(kind, 2, seed=2)
    # the port's client: the crc is stamped, then the bytes rot on the wire
    real = tkt._array_header

    def rotten(data):
        payload, fields = real(data)
        return _corrupt(payload), fields

    monkeypatch.setattr(tkt, "_array_header", rotten)
    for smod in (tkt, jkt):
        store = {}
        srv = _dict_server(smod, store)
        host, port = await srv.start()
        try:
            with pytest.raises(KvIntegrityError):
                await tkt.write_remote_pages(host, port, [1, 2],
                                             as_port(kind, p))
            with pytest.raises(KvIntegrityError):
                await tkt.write_pages_stream(
                    host, port, [([1, 2], as_port(kind, p))])
            assert not store  # nothing corrupt was scattered
        finally:
            await srv.stop()
    monkeypatch.setattr(tkt, "_array_header", real)
    # the JAX package's client against the port's server (its chaos hook
    # flips a byte of the outgoing payload after the crc was stamped)
    from dynamo_tpu.resilience.chaos import CHAOS

    monkeypatch.setattr(CHAOS, "maybe_corrupt_frame", _corrupt)
    store = {}
    srv = _dict_server(tkt, store)
    host, port = await srv.start()
    try:
        with pytest.raises(JKvIntegrityError):
            await jkt.write_remote_pages(host, port, [1, 2],
                                         as_ref(kind, p))
        assert not store
    finally:
        await srv.stop()


# ---------------------------------------------------------------------------
# across the packages, over engines


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    import jax

    return jparams, jax.tree.map(np.asarray, jparams)


def _engine(port_side, weights, kv_quant):
    if port_side:
        return TorchEngine(
            TConfig.tiny(dtype="float32"),
            TEngineConfig(**KW, kv_quant=kv_quant),
            params=params_from_jax(weights[1], device="cpu"), device="cpu")
    return TpuEngine(JConfig.tiny(dtype="float32"),
                     JEngineConfig(**KW, kv_quant=kv_quant),
                     params=weights[0], mesh_config=MeshConfig(tp=1))


def _server(mod, eng):
    def write_fn(pages, data, job=None):
        eng.import_pages(pages, data)

    return mod.BlockTransferServer(
        read_fn=eng.export_pages, write_fn=write_fn,
        read_hashes_fn=eng.export_pages_by_hash,
        count_hashes_fn=eng.allocator.cached_prefix_len,
        read_hashes_stream_fn=eng.export_hash_stream)


async def _prefill(eng, proto):
    req = proto.PreprocessedRequest(
        token_ids=list(PROMPT),
        stop_conditions=proto.StopConditions(max_tokens=4, ignore_eos=True))
    async for _ in eng.generate(req):
        pass
    await asyncio.sleep(0.1)


def _cat(parts):
    if isinstance(parts[0], (QuantizedPages, JQuantizedPages)):
        return raw(np.concatenate([np.asarray(p.data) for p in parts], 3)) \
            + raw(np.concatenate([np.asarray(p.scales) for p in parts], 2))
    return raw(np.concatenate([np.asarray(p) for p in parts], 3))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("server_side", ["port", "reference"])
@pytest.mark.asyncio_timeout(180)
async def test_every_op_across_the_packages(server_side, kv_quant, weights):
    """The server of one package over its engine, the clients of the
    other: every op moves the pages the serving engine exports, byte for
    byte."""
    port_srv = server_side == "port"
    eng = _engine(port_srv, weights, kv_quant)
    smod, cmod = (tkt, jkt) if port_srv else (jkt, tkt)
    def to_client(x):
        """The serving engine's export as the client package's value."""
        if isinstance(x, (QuantizedPages, JQuantizedPages)):
            d, sc = np.array(x.data), np.array(x.scales)
            return (JQuantizedPages(d, sc) if port_srv else QuantizedPages(
                torch.from_numpy(d), torch.from_numpy(sc)))
        return np.array(x) if port_srv else torch.from_numpy(np.array(x))

    run = asyncio.to_thread
    srv = _server(smod, eng)
    host, port = await srv.start()
    try:
        await _prefill(eng, tproto if port_srv else jproto)
        hashes = compute_block_hashes(PROMPT, PS)[:4]
        pages = [eng.allocator.page_for_hash(h) for h in hashes]
        assert None not in pages
        want = await run(eng.export_pages, pages)
        # reads
        assert raw(await cmod.read_remote_pages(host, port, pages)) == raw(
            want)
        found, data = await cmod.probe_remote_hashes(host, port,
                                                     hashes + [7])
        assert (found, data) == (4, None)
        found, data = await cmod.read_remote_hashes(host, port, hashes)
        assert found == 4 and raw(data) == raw(want)
        got = []
        found, data = await cmod.read_remote_hashes(
            host, port, hashes, chunk_pages=3,
            on_chunk=lambda off, a: got.append((off, a)))
        assert (found, data) == (4, None)
        assert [off for off, _ in got] == [0, 3]
        assert _cat([a for _, a in got]) == raw(want)
        if cmod is tkt or kv_quant == "none":
            # (the JAX client joins chunks with np.concatenate, which
            # takes no int8 bundle: it reads those through on_chunk)
            found, data = await cmod.read_remote_hashes(host, port, hashes,
                                                        chunk_pages=3)
            assert found == 4 and raw(data) == raw(want)
        assert await cmod.probe_remote_hashes(host, port, [12345]) == (0,
                                                                       None)
        # writes: the exported pages into fresh pages of the same pool,
        # exported again
        fresh = eng.allocator.allocate(4)
        payload = to_client(want)
        await cmod.write_remote_pages(host, port, fresh, payload, job_id="j")
        assert raw(await run(eng.export_pages, fresh)) == raw(want)
        fresh2 = eng.allocator.allocate(4)

        def part(lo, hi):
            if isinstance(payload, (QuantizedPages, JQuantizedPages)):
                return type(payload)(payload.data[:, :, :, lo:hi],
                                     payload.scales[:, :, lo:hi])
            return payload[:, :, :, lo:hi]

        n = await cmod.write_pages_stream(
            host, port, [(fresh2[:1], part(0, 1)), (fresh2[1:], part(1, 4))])
        assert n == 2
        assert raw(await run(eng.export_pages, fresh2)) == raw(want)
        eng.allocator.free(fresh + fresh2)
    finally:
        await srv.stop()
        await eng.stop()


async def test_descriptors_cross_the_packages():
    server, _ = await serve_store("127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    tkv = await KvClient(port=port).connect()
    jkv = await JKvClient(port=port).connect()
    try:
        tdesc = tkt.BlocksetDescriptor(
            "port-w", "127.0.0.1", 4242,
            tkt.KvCacheLayout(32, 8, 64, 128, "int8"))
        jdesc = jkt.BlocksetDescriptor(
            "ref-w", "127.0.0.1", 4343,
            jkt.KvCacheLayout(2, 2, 16, 8, "float32"))
        assert tdesc.to_json() == jkt.BlocksetDescriptor(
            "port-w", "127.0.0.1", 4242,
            jkt.KvCacheLayout(32, 8, 64, 128, "int8")).to_json()
        assert tkt.kvmeta_key("ns", "w") == jkt.kvmeta_key("ns", "w")
        await tkt.publish_descriptor(tkv, "ns", tdesc)
        await jkt.publish_descriptor(jkv, "ns", jdesc)
        got = await jkt.get_descriptor(jkv, "ns", "port-w")
        assert got.to_json() == tdesc.to_json()
        assert got.layout.page_shape(3) == (2, 32, 8, 3, 64, 128)
        got = await tkt.get_descriptor(tkv, "ns", "ref-w")
        assert got.to_json() == jdesc.to_json()
        assert await tkt.get_descriptor(tkv, "ns", "nobody") is None
        # the G4 fetcher sees both packages' workers as peers
        fetcher = tkt.RemoteKvFetcher(tkv, "ns", "port-w")
        assert [d.worker_id for d in await fetcher._peers()] == ["ref-w"]
    finally:
        await tkv.close()
        await jkv.close()
        server.close()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
async def test_export_pages_stream_concatenates_to_export_pages(
        kv_quant, weights):
    eng = _engine(True, weights, kv_quant)
    try:
        await _prefill(eng, tproto)
        pages = [eng.allocator.page_for_hash(h)
                 for h in compute_block_hashes(PROMPT, PS)[:4]]
        whole = await asyncio.to_thread(eng.export_pages, pages)
        for cp in (1, 3, 4):
            chunks = await asyncio.to_thread(
                lambda: list(eng.export_pages_stream(pages, cp)))
            assert [int(c.shape[3]) for c in chunks] == [
                min(cp, 4 - i) for i in range(0, 4, cp)]
            assert _cat(chunks) == raw(whole)
        # an export is contiguous in the wire's layout: sent without a copy
        data = whole.data if kv_quant == "int8" else whole
        assert data.is_contiguous() and data.shape[3] == 4
    finally:
        await eng.stop()
