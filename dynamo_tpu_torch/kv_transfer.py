"""KV block transfer plane (a copy of the JAX package's kv_transfer.py on
torch CPU tensors; reference block_manager.rs:54,120-130
``SerializedNixlBlockSet``, examples/llm/utils/nixl.py:116).

Workers publish a *blockset descriptor* (who am I, where is my data
plane, what layout do my pages have) in the control-plane store, and
peers move whole KV pages worker to worker. The data plane is host
staged: the engine gathers pages on the card and copies them to pinned
host memory (``TorchEngine.export_pages*``), they travel over TCP as
two-part frames (JSON header + raw bytes, runtime/protocol.py), and the
receiver scatters them into its pool (``import_pages``). Bulk moves are
chunk-pipelined: a move is a sequence of page-chunk frames, the sender
exports and ships chunk i while chunk i+1 is still being gathered (or,
for a disagg remote prefill, still computed), the receiver scatters each
chunk on arrival and acks once, at eof. Host staging per hop is
O(chunk).

The frames are the JAX package's, byte for byte in their payloads: a
header's ``shape`` and ``dtype`` (numpy's name: ``bfloat16`` for the raw
2-byte words of a bf16 page, without ml_dtypes), the per-page ``kv_crc``
list (kv_integrity.py) and an int8 pool's ``kv_scales`` float list with
``kv_scales_shape`` (kv_quant.py). Either package's client talks to the
other's server.

Ops:
  {"op": "write_pages", "pages": [...], "shape": [...], "dtype": "..."} + payload
      -> {"ok": true}
  {"op": "write_pages", ..., "stream": true, "seq": i} + payload
      -> (no reply per chunk; the stream is acked at eof)
  {"op": "write_pages_eof", "chunks": n}
      -> {"ok": true, "chunks": n} | {"ok": false, "error": "..."}
  {"op": "read_pages", "pages": [...]}
      -> {"ok": true, "shape": [...], "dtype": "..."} + payload
  {"op": "read_hashes", "hashes": [...], "probe": true}
      -> {"ok": true, "found": k}                       (no payload)
  {"op": "read_hashes", "hashes": [...], "chunk_pages": c}
      -> {"ok": true, "found": k, "stream": true} then k pages of
         {"seq": i, "shape": [...], "dtype": "...", "eof": bool} + payload

Each streamed chunk is a ``frame_send`` event on the writer and a
``frame_recv`` event on the server, and the writer's wait for the eof
ack an ``eof_ack_wait`` event (telemetry/timeline.py STREAM_EVENTS).

Left out: ``ArrayFrameServer`` and ``take_remote_array``, which carry
multimodal embeddings (ROADMAP Queue 1 item 12). The ``corrupt_frame`` chaos point
(resilience/chaos.py) flips a byte of an outgoing payload's copy.
"""
from __future__ import annotations

import asyncio
import json
import logging
import math
import os
import struct
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass
from typing import Any, Callable, Iterable, Optional

import torch

from dynamo_tpu_torch.kv_integrity import (
    KV_INTEGRITY,
    KvIntegrityError,
    attach_wire_checksums,
    verify_wire_payload,
)
from dynamo_tpu_torch.kv_quant import (
    QuantizedPages,
    attach_wire_scales,
    from_wire,
)
from dynamo_tpu_torch.kv_transfer_metrics import KV_TRANSFER
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.protocol import (
    MAX_FRAME,
    MAX_PAYLOAD,
    encode_frame2,
    encode_frame2_header,
)
from dynamo_tpu_torch.telemetry import timeline as tl

__all__ = [
    "KV_META_PREFIX", "BlockTransferError", "BlockTransferServer",
    "BlocksetDescriptor", "KvCacheLayout", "PageStreamWriter",
    "RemoteKvFetcher", "get_descriptor", "kvmeta_key", "probe_remote_hashes",
    "publish_descriptor", "read_remote_hashes", "read_remote_pages",
    "write_pages_stream", "write_remote_pages",
]

log = logging.getLogger(__name__)

# a frame's element type by numpy's name (what the JAX package writes)
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


class BlockTransferError(RuntimeError):
    pass


_CRC_POOL: Optional[ThreadPoolExecutor] = None


def _crc_pool() -> ThreadPoolExecutor:
    """Threads that checksum a frame's pages side by side (zlib releases
    the interpreter lock): a page's crc32 is a frame's largest host
    cost."""
    global _CRC_POOL
    if _CRC_POOL is None:
        _CRC_POOL = ThreadPoolExecutor(min(8, os.cpu_count() or 1),
                                       thread_name_prefix="kv-wire-crc")
    return _CRC_POOL


def _array_header(data) -> tuple[torch.Tensor, dict[str, Any]]:
    """(payload tensor, geometry header fields) for dense pages or a
    kv_quant.QuantizedPages bundle: int8 payloads ship their scale
    sidecar in the JSON header. KV page frames (the 6-dim ``[2, L, kvh,
    n, ps, hd]`` geometry) also get a per-page ``kv_crc`` list over the
    pre-serialization value (bundle with its scales), so the receiver
    verifies before scattering. The fields and their order are the JAX
    package's."""
    fields: dict[str, Any] = {}
    if isinstance(data, QuantizedPages):
        attach_wire_scales(fields, data)
        if data.data.ndim == 6:
            attach_wire_checksums(fields, data, _crc_pool())
        data = data.data
    elif getattr(data, "ndim", 0) == 6:
        attach_wire_checksums(fields, data, _crc_pool())
    fields["shape"] = list(data.shape)
    fields["dtype"] = _DTYPE_NAMES[data.dtype]
    return data, fields


def _decode_payload(header: dict[str, Any], payload: bytes,
                    copy: bool = False, verify: bool = False):
    """Inverse of _array_header: the dense tensor, re-bundled with its
    scales when the frame carried a quantized payload (``payload``: a
    received frame's writable buffer). ``copy`` detaches the result from
    the frame buffer; without it the tensor is a view of it.

    The declared geometry is checked against the received byte count
    BEFORE anything is decoded: a malformed header becomes a typed
    BlockTransferError the server answers in-band. ``verify`` also checks
    the payload against the frame's ``kv_crc`` list (KvIntegrityError on
    a mismatch)."""
    try:
        dt = _DTYPES[str(header["dtype"])]
        shape = tuple(int(x) for x in header["shape"])
    except (KeyError, TypeError, ValueError) as e:
        raise BlockTransferError(f"malformed frame geometry: {e!r}") from e
    if any(d < 0 for d in shape):
        raise BlockTransferError(
            f"malformed frame geometry: negative dim in {shape}")
    itemsize = torch.empty((), dtype=dt).element_size()
    expect = math.prod(shape) * itemsize
    if expect != len(payload):
        raise BlockTransferError(
            f"frame geometry {list(shape)}/{header['dtype']} declares "
            f"{expect} payload bytes, got {len(payload)}")
    raw = (torch.frombuffer(payload, dtype=torch.uint8) if len(payload)
           else torch.empty(0, dtype=torch.uint8))
    arr = raw.view(dt).reshape(shape)
    if copy:
        arr = arr.clone()
    try:
        out = from_wire(arr, header)
    except (TypeError, ValueError, RuntimeError) as e:
        raise BlockTransferError(f"malformed scale sidecar: {e}") from e
    if verify:
        verify_wire_payload(header, out, context="kv-transfer frame",
                            pool=_crc_pool())
    return out


def _err_kind(e: BaseException) -> str:
    return "integrity" if isinstance(e, KvIntegrityError) else "frame"


def _raise_nack(header: dict[str, Any], default: str) -> None:
    """Re-raise a receiver nack client-side with its type preserved: a
    ``kind: integrity`` nack becomes the retriable KvIntegrityError."""
    msg = header.get("error", default)
    if header.get("kind") == "integrity":
        raise KvIntegrityError(msg)
    raise BlockTransferError(msg)


def _write_array_frame(writer, header: dict[str, Any], data) -> None:
    """Write header + payload without copying the pages: the length
    prefix and header go as one small bytes, the payload as a byte view
    of the (contiguous) CPU tensor. ``data`` may be a QuantizedPages
    bundle: its scales join the header, its int8 pages the payload."""
    data, fields = _array_header(data)
    header = {**header, **fields}
    data = data.contiguous()   # no copy for an export's contiguous pages
    # chaos corrupt_frame: wire corruption on a COPY, after the crc was
    # stamped: the receiver's verify must catch it, and the sender's pages
    # (which ``data`` may alias) stay clean
    from dynamo_tpu_torch.resilience.chaos import CHAOS

    data = CHAOS.maybe_corrupt_frame(data)
    payload = memoryview(data.reshape(-1).view(torch.uint8).numpy())
    writer.write(encode_frame2_header(header, payload.nbytes))
    writer.write(payload)


def _cat_pages(parts: list) -> Any:
    """Chunks of one page run joined along the page axis."""
    if isinstance(parts[0], QuantizedPages):
        return QuantizedPages(torch.cat([p.data for p in parts], dim=3),
                              torch.cat([p.scales for p in parts], dim=2))
    return torch.cat(parts, dim=3)


# ---------------------------------------------------------------------------
# connections

_LEN = struct.Struct(">I")
_PLEN = struct.Struct(">Q")

# received payloads' buffers, kept for later frames: a fresh buffer costs
# its page faults on every frame, as much as the copy into it
_SPARES: list[bytearray] = []
_SPARES_MAX = 4
_SPARES_LOCK = threading.Lock()


def _payload_buffer(n: int) -> memoryview:
    """``n`` bytes for a received payload: the smallest kept buffer of
    ``n`` to ``2n`` bytes that nothing refers to any more (every
    memoryview of a bytearray, and every tensor over one, holds a
    reference to it), else a new one, kept in place of the oldest."""
    with _SPARES_LOCK:
        best = None
        for b in _SPARES:
            # the list, the loop variable and getrefcount's argument
            if n <= len(b) <= 2 * n and sys.getrefcount(b) == 3 and (
                    best is None or len(b) < len(best)):
                best = b
        if best is None:
            best = bytearray(n)
            _SPARES[:] = _SPARES[-(_SPARES_MAX - 1):] + [best]
        return memoryview(best)[:n]


class _FrameConn(asyncio.BufferedProtocol):
    """One transfer-plane connection, both ways: runtime/protocol.py's
    two-part frames (the JAX package's bytes) received straight into each
    payload's own buffer with ``recv_into`` (as much as the socket holds
    per call), where asyncio's StreamReader moves a payload through
    256 KiB reads, a growing bytearray and two slice copies; and writes
    through the transport with its flow control (``drain``). A payload
    arrives as a memoryview of a uint8 tensor from ``_payload_buffer``.
    At most two received frames wait for ``read_frame2``: beyond that the
    socket is not read (the sender's drain then waits)."""

    _SMALL = 64 * 1024

    def __init__(self, on_open=None):
        self._on_open = on_open
        self._transport: Optional[asyncio.Transport] = None
        self._small = bytearray(self._SMALL)   # a frame's prefix and header
        self._n = 0
        self._header: Optional[dict] = None    # the frame being received
        self._payload: Optional[memoryview] = None
        self._got = 0
        self._frames: deque = deque()
        self._read_paused = False
        self._write_paused = False
        self._waiter: Optional[asyncio.Future] = None
        self._drain_waiter: Optional[asyncio.Future] = None
        self._error: Optional[BaseException] = None

    # -- protocol callbacks (the event loop)

    def connection_made(self, transport) -> None:
        self._transport = transport
        if self._on_open is not None:
            self._on_open(self)

    def get_buffer(self, sizehint: int) -> memoryview:
        if self._payload is not None:
            return self._payload[self._got:]
        return memoryview(self._small)[self._n:]

    def buffer_updated(self, nbytes: int) -> None:
        if self._payload is not None:
            self._got += nbytes
            if self._got == len(self._payload):
                self._push(self._header, self._payload)
                self._header = self._payload = None
            return
        self._n += nbytes
        try:
            self._parse()
        except (ValueError, json.JSONDecodeError) as e:
            # desynced or oversized framing: the reader raises it
            self._fail(ValueError(f"malformed frame: {e}"))
            self._transport.close()

    def _parse(self) -> None:
        """Frames whose prefix and header sit in the small buffer: a
        payload that is not complete there continues in its own buffer."""
        while self._n >= 4:
            buf = self._small
            (hn,) = _LEN.unpack_from(buf, 0)
            if hn > MAX_FRAME:
                raise ValueError(f"header too large: {hn}")
            start = 4 + hn + 8
            if self._n < start:
                if start > len(buf):   # a header larger than the buffer
                    big = bytearray(start)
                    big[:self._n] = buf[:self._n]
                    self._small = big
                return
            header = json.loads(bytes(buf[4:4 + hn]))
            (pn,) = _PLEN.unpack_from(buf, 4 + hn)
            if pn > MAX_PAYLOAD:
                raise ValueError(f"payload too large: {pn}")
            payload = _payload_buffer(pn)
            take = min(pn, self._n - start)
            payload[:take] = buf[start:start + take]
            rest = self._n - start - take
            buf[:rest] = buf[start + take:self._n]
            self._n = rest
            if take < pn:
                self._header, self._payload, self._got = header, payload, take
                return
            self._push(header, payload)

    def _push(self, header: dict, payload: memoryview) -> None:
        self._frames.append((header, payload if len(payload) else b""))
        self._wake()
        if len(self._frames) >= 2 and not self._read_paused:
            self._read_paused = True
            self._transport.pause_reading()

    def _wake(self) -> None:
        if self._waiter is not None and not self._waiter.done():
            self._waiter.set_result(None)

    def _fail(self, exc: BaseException) -> None:
        if self._error is None:
            self._error = exc
        self._wake()
        if self._drain_waiter is not None and not self._drain_waiter.done():
            self._drain_waiter.set_exception(ConnectionResetError(str(exc)))

    def eof_received(self) -> bool:
        self._fail(asyncio.IncompleteReadError(b"", None))
        return False

    def connection_lost(self, exc: Optional[BaseException]) -> None:
        self._fail(exc if exc is not None
                   else asyncio.IncompleteReadError(b"", None))

    def pause_writing(self) -> None:
        self._write_paused = True

    def resume_writing(self) -> None:
        self._write_paused = False
        if self._drain_waiter is not None and not self._drain_waiter.done():
            self._drain_waiter.set_result(None)

    # -- the stream surface

    async def read_frame2(self) -> tuple[dict[str, Any], Any]:
        """The next frame (header, payload); IncompleteReadError once the
        peer closed, ValueError on malformed framing."""
        while not self._frames:
            if self._error is not None:
                raise self._error
            self._waiter = asyncio.get_running_loop().create_future()
            await self._waiter
        frame = self._frames.popleft()
        if self._read_paused and len(self._frames) < 2:
            self._read_paused = False
            self._transport.resume_reading()
        return frame

    def write(self, data) -> None:
        self._transport.write(data)

    async def drain(self) -> None:
        if self._error is not None and not isinstance(
                self._error, asyncio.IncompleteReadError):
            raise ConnectionResetError(str(self._error))
        if self._write_paused:
            self._drain_waiter = asyncio.get_running_loop().create_future()
            await self._drain_waiter

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()


async def _connect(host: str, port: int) -> _FrameConn:
    _, conn = await asyncio.get_running_loop().create_connection(
        _FrameConn, host, port)
    return conn


# ---------------------------------------------------------------------------
# descriptors (the JAX package's JSON: either package finds the other's
# workers)

KV_META_PREFIX = "_kvmeta/"


def kvmeta_key(namespace: str, worker_id: str) -> str:
    return f"dynamo://{namespace}/{KV_META_PREFIX}{worker_id}"


@dataclass
class KvCacheLayout:
    """Block geometry; both sides must agree before pages move."""

    num_layers: int
    num_kv_heads: int
    page_size: int
    head_dim: int
    dtype: str = "bfloat16"

    def page_shape(self, n_pages: int) -> tuple[int, ...]:
        # llama.gather_pages' order: [2(k/v), L, kvh, n, ps, hd]
        return (2, self.num_layers, self.num_kv_heads, n_pages,
                self.page_size, self.head_dim)


@dataclass
class BlocksetDescriptor:
    """What a worker publishes so peers can address its KV pool
    (SerializedNixlBlockSet equivalent)."""

    worker_id: str
    host: str
    port: int
    layout: KvCacheLayout

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "BlocksetDescriptor":
        d = json.loads(s)
        d["layout"] = KvCacheLayout(**d["layout"])
        return cls(**d)


async def publish_descriptor(kv: KvClient, namespace: str,
                             desc: BlocksetDescriptor, lease: int = 0) -> None:
    """The descriptor in the store (reference: NIXL agent metadata via
    etcd, utils/nixl.py:116); with a lease it dies with the worker."""
    await kv.put(kvmeta_key(namespace, desc.worker_id), desc.to_json(),
                 lease=lease)


async def get_descriptor(kv: KvClient, namespace: str,
                         worker_id: str) -> Optional[BlocksetDescriptor]:
    v = await kv.get(kvmeta_key(namespace, worker_id))
    return None if v is None else BlocksetDescriptor.from_json(v)


# ---------------------------------------------------------------------------
# data-plane server

# read_fn(page_ids) -> pages [2, L, kvh, n, ps, hd] (or a bundle)
# write_fn(page_ids, data) -> None, or (page_ids, data, job_id) when the
# writer tags frames with a job id (disagg guarded writes: the owner
# checks that the job is still live before scattering)
ReadFn = Callable[[list[int]], Any]
WriteFn = Callable[..., None]


class BlockTransferServer:
    """Serves a worker's KV pool for peer page reads and writes.

    The owner supplies the callables (the engine's thread-safe export and
    import hooks, or direct pool access in tests). They block until the
    engine loop services them at a round boundary, so every call runs in
    the default executor, never on the event loop."""

    def __init__(
        self,
        read_fn: Optional[ReadFn] = None,
        write_fn: Optional[WriteFn] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        read_hashes_fn: Optional[
            Callable[[list[int]], tuple[int, Any]]] = None,
        # chunk-pipelined serving hooks (peers fall back to the
        # monolithic ops without them): count_hashes_fn(hashes) -> int,
        # the committed-prefix length for the G4 probe (no gather);
        # read_hashes_stream_fn(hashes, chunk_pages) -> (found, iterator
        # of host chunks), the engine's export_hash_stream
        count_hashes_fn: Optional[Callable[[list[int]], int]] = None,
        read_hashes_stream_fn: Optional[Callable[..., tuple[int, Any]]] = None,
    ):
        self.read_fn = read_fn
        self.write_fn = write_fn
        self.host = host
        self.port = port
        self.read_hashes_fn = read_hashes_fn
        self.count_hashes_fn = count_hashes_fn
        self.read_hashes_stream_fn = read_hashes_stream_fn
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[asyncio.Task] = set()

    async def start(self) -> tuple[str, int]:
        loop = asyncio.get_running_loop()

        def opened(conn: _FrameConn) -> None:
            task = loop.create_task(self._on_conn(conn))
            self._conns.add(task)
            task.add_done_callback(self._conns.discard)

        self._server = await loop.create_server(
            lambda: _FrameConn(on_open=opened), self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _scatter(self, loop, header, pages, data) -> None:
        args = (pages, data)
        if header.get("job") is not None:
            args = (pages, data, header["job"])
        await loop.run_in_executor(None, self.write_fn, *args)

    async def _on_conn(self, conn: _FrameConn) -> None:
        loop = asyncio.get_running_loop()
        # chunk-stream state of THIS connection: a failure inside a stream
        # is remembered (later frames skipped) and reported once in the
        # eof ack; the sender pipelines frames without per-chunk acks, so
        # an in-band per-frame error would desync the protocol
        stream_chunks = 0
        stream_err: Optional[str] = None
        stream_err_kind: Optional[str] = None
        try:
            while True:
                # the last frame's buffer goes back to the pool
                payload = data = None
                header, payload = await conn.read_frame2()
                op = header.get("op")
                try:
                    if op == "write_pages":
                        if self.write_fn is None:
                            raise RuntimeError("writes not accepted")
                        pages = [int(p) for p in header["pages"]]
                        if header.get("stream"):
                            stream_chunks += 1
                            if stream_err is not None:
                                continue  # the stream is already dead
                            t0 = time.monotonic()
                            try:
                                # decode + verify BEFORE the scatter:
                                # corrupt or malformed bytes never reach
                                # the pool
                                data = _decode_payload(header, payload,
                                                       verify=True)
                            except (BlockTransferError,
                                    KvIntegrityError) as e:
                                stream_err = str(e)
                                stream_err_kind = _err_kind(e)
                                KV_TRANSFER.inc(
                                    "dynamo_kv_transfer_errors_total")
                                log.warning(
                                    "chunk rejected mid-stream (job=%s "
                                    "seq=%s kind=%s): %s", header.get("job"),
                                    header.get("seq"), stream_err_kind, e)
                                continue
                            try:
                                await self._scatter(loop, header, pages, data)
                            except Exception as e:  # noqa: BLE001
                                stream_err = str(e)
                                stream_err_kind = "scatter"
                                KV_TRANSFER.inc(
                                    "dynamo_kv_transfer_errors_total")
                                log.warning(
                                    "chunk scatter failed mid-stream (job=%s "
                                    "seq=%s): %s", header.get("job"),
                                    header.get("seq"), e)
                            else:
                                KV_TRANSFER.inc(
                                    "dynamo_kv_transfer_rx_chunks_total")
                                KV_TRANSFER.inc(
                                    "dynamo_kv_transfer_rx_bytes_total",
                                    len(payload))
                                dt = time.monotonic() - t0
                                KV_TRANSFER.observe(
                                    "dynamo_kv_transfer_chunk_seconds", dt)
                                ev_job = header.get("job")
                                tl.STREAM_EVENTS.record(
                                    tl.FRAME_RECV, dt,
                                    seq=header.get("seq"),
                                    pages=len(pages), bytes=len(payload),
                                    **({"job": ev_job} if ev_job else {}))
                            continue  # no per-chunk reply
                        try:
                            data = _decode_payload(header, payload,
                                                   verify=True)
                        except (BlockTransferError, KvIntegrityError) as e:
                            # typed nack: the sender tells a retriable
                            # integrity miss from a protocol bug, and the
                            # connection stays usable
                            KV_TRANSFER.inc("dynamo_kv_transfer_errors_total")
                            log.warning("write_pages rejected (kind=%s): %s",
                                        _err_kind(e), e)
                            conn.write(encode_frame2(
                                {"ok": False, "error": str(e),
                                 "kind": _err_kind(e)}, b""))
                            await conn.drain()
                            continue
                        await self._scatter(loop, header, pages, data)
                        KV_TRANSFER.inc("dynamo_kv_transfer_rx_chunks_total")
                        KV_TRANSFER.inc("dynamo_kv_transfer_rx_bytes_total",
                                        len(payload))
                        conn.write(encode_frame2({"ok": True}, b""))
                    elif op == "write_pages_eof":
                        # close one pipelined stream: a single ack that
                        # carries any deferred mid-stream failure (typed,
                        # so an integrity nack stays retriable)
                        if stream_err is not None:
                            conn.write(encode_frame2(
                                {"ok": False, "error": stream_err,
                                 "kind": stream_err_kind,
                                 "chunks": stream_chunks}, b""))
                        else:
                            conn.write(encode_frame2(
                                {"ok": True, "chunks": stream_chunks}, b""))
                        stream_chunks, stream_err = 0, None
                        stream_err_kind = None
                    elif op == "read_pages":
                        if self.read_fn is None:
                            raise RuntimeError("reads not accepted")
                        pages = [int(p) for p in header["pages"]]
                        data = await loop.run_in_executor(None, self.read_fn,
                                                          pages)
                        _write_array_frame(conn, {"ok": True}, data)
                    elif op == "read_hashes":
                        # G4: resolve a chained-hash run against this
                        # worker's sealed pool and export the longest
                        # present prefix (reference block_manager.rs:69-82)
                        hs = [int(h) for h in header["hashes"]]
                        if header.get("probe") and self.count_hashes_fn:
                            # the cheap probe: the committed-prefix length,
                            # no gather
                            found = await loop.run_in_executor(
                                None, self.count_hashes_fn, hs)
                            conn.write(encode_frame2(
                                {"ok": True, "found": int(found)}, b""))
                            await conn.drain()
                            continue
                        cp = int(header.get("chunk_pages") or 0)
                        if cp > 0 and self.read_hashes_stream_fn:
                            await self._serve_hash_stream(conn, loop, hs,
                                                          cp)
                            await conn.drain()
                            continue
                        if self.read_hashes_fn is None:
                            raise RuntimeError("hash reads not accepted")
                        found, data = await loop.run_in_executor(
                            None, self.read_hashes_fn, hs)
                        if not found or data is None:
                            conn.write(encode_frame2(
                                {"ok": True, "found": 0}, b""))
                        else:
                            _write_array_frame(
                                conn, {"ok": True, "found": int(found)},
                                data)
                            KV_TRANSFER.inc(
                                "dynamo_kv_transfer_tx_chunks_total")
                            KV_TRANSFER.inc(
                                "dynamo_kv_transfer_tx_bytes_total",
                                data.nbytes)
                    else:
                        raise RuntimeError(f"unknown op {op!r}")
                except Exception as e:  # noqa: BLE001 — answer in-band
                    log.exception("block transfer op %s failed", op)
                    conn.write(encode_frame2(
                        {"ok": False, "error": str(e)}, b""))
                await conn.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass
        except (ValueError, json.JSONDecodeError):
            # desynced or oversized framing from a faulty peer
            log.warning("malformed block-transfer frame; closing connection")
        finally:
            conn.close()

    async def _serve_hash_stream(self, conn: _FrameConn, loop,
                                 hashes: list[int], chunk_pages: int) -> None:
        """One chunk-pipelined hash read: a lead frame with the found
        count, then one frame per chunk as the engine's export stream
        yields it (the gather and copy of chunk i+1 run while chunk i is
        on the wire; the serving side never stages the whole run)."""
        found, chunks = await loop.run_in_executor(
            None, self.read_hashes_stream_fn, hashes, chunk_pages)
        conn.write(encode_frame2(
            {"ok": True, "found": int(found), "stream": True}, b""))
        if not found:
            return
        await conn.drain()
        sent_pages = 0
        seq = 0
        it = iter(chunks)
        # a sentinel, not StopIteration: StopIteration raised inside
        # run_in_executor cannot be set on an asyncio Future
        done = object()
        while sent_pages < found:
            try:
                data = await loop.run_in_executor(None, next, it, done)
            except Exception as e:  # noqa: BLE001 — report in-band
                log.exception("hash-stream export failed mid-stream")
                KV_TRANSFER.inc("dynamo_kv_transfer_errors_total")
                conn.write(encode_frame2({"ok": False, "error": str(e)},
                                           b""))
                return
            if data is done:
                break
            sent_pages += int(data.shape[3])
            _write_array_frame(
                conn, {"ok": True, "seq": seq, "eof": sent_pages >= found},
                data)
            await conn.drain()
            KV_TRANSFER.inc("dynamo_kv_transfer_tx_chunks_total")
            KV_TRANSFER.inc("dynamo_kv_transfer_tx_bytes_total", data.nbytes)
            seq += 1
        KV_TRANSFER.inc("dynamo_kv_transfer_streams_total")


# ---------------------------------------------------------------------------
# data-plane clients


async def write_remote_pages(host: str, port: int, pages: list[int], data,
                             job_id: Optional[str] = None) -> None:
    """One-sided write: push pages into a peer's pool (prefill pushing
    computed KV into decode's pre-allocated pages). ``job_id`` tags the
    frame so the receiver can refuse writes for a job it cancelled. An
    integrity nack (the bytes rotted on the wire) is retried once before
    the error reaches the caller's fallback."""
    for attempt in (0, 1):
        try:
            await _write_remote_pages_once(host, port, pages, data, job_id)
            return
        except KvIntegrityError:
            if attempt:
                raise
            KV_INTEGRITY.inc("dynamo_kv_integrity_retries_total")
            log.warning("integrity nack on write_pages (job=%s); retrying "
                        "once", job_id)


async def _write_remote_pages_once(host: str, port: int, pages: list[int],
                                   data, job_id: Optional[str]) -> None:
    conn = await _connect(host, port)
    try:
        header: dict[str, Any] = {"op": "write_pages",
                                  "pages": [int(p) for p in pages]}
        if job_id is not None:
            header["job"] = job_id
        _write_array_frame(conn, header, data)
        await conn.drain()
        KV_TRANSFER.inc("dynamo_kv_transfer_tx_chunks_total")
        KV_TRANSFER.inc("dynamo_kv_transfer_tx_bytes_total", data.nbytes)
        header, _ = await conn.read_frame2()
        if not header.get("ok"):
            KV_TRANSFER.inc("dynamo_kv_transfer_errors_total")
            _raise_nack(header, "write failed")
    finally:
        conn.close()


class PageStreamWriter:
    """One chunk-pipelined page push into a peer's pool: ``write_pages``
    frames tagged ``stream``/``seq`` as chunks become available, with no
    per-chunk ack (chunk i rides the wire while chunk i+1 is computed or
    gathered). ``commit()`` sends the eof frame and waits for the single
    ack, which carries any deferred mid-stream failure; ``close()`` on
    error paths, so a dead stream never half-writes silently."""

    def __init__(self, host: str, port: int, job_id: Optional[str] = None):
        self.host = host
        self.port = port
        self.job_id = job_id
        self.chunks_sent = 0
        self.bytes_sent = 0
        self._conn: Optional[_FrameConn] = None
        self._t_open: Optional[float] = None

    async def _ensure_conn(self) -> None:
        if self._conn is None:
            self._conn = await _connect(self.host, self.port)
            self._t_open = time.monotonic()

    async def write_chunk(self, pages: list[int], data) -> None:
        """Ship one chunk (pages aligned with data's page axis)."""
        await self._ensure_conn()
        header: dict[str, Any] = {
            "op": "write_pages", "pages": [int(p) for p in pages],
            "stream": True, "seq": self.chunks_sent}
        if self.job_id is not None:
            header["job"] = self.job_id
        t0 = time.monotonic()
        _write_array_frame(self._conn, header, data)
        await self._conn.drain()
        self.chunks_sent += 1
        self.bytes_sent += data.nbytes
        KV_TRANSFER.inc("dynamo_kv_transfer_tx_chunks_total")
        KV_TRANSFER.inc("dynamo_kv_transfer_tx_bytes_total", data.nbytes)
        dt = time.monotonic() - t0
        KV_TRANSFER.observe("dynamo_kv_transfer_chunk_seconds", dt)
        tl.STREAM_EVENTS.record(
            tl.FRAME_SEND, dt, seq=self.chunks_sent - 1, pages=len(pages),
            bytes=int(data.nbytes),
            **({"job": self.job_id} if self.job_id else {}))

    async def commit(self) -> int:
        """The eof frame and its single ack; returns the receiver's chunk
        count. Raises BlockTransferError (KvIntegrityError for an
        integrity nack) if any chunk failed."""
        await self._ensure_conn()
        self._conn.write(encode_frame2(
            {"op": "write_pages_eof", "chunks": self.chunks_sent,
             **({"job": self.job_id} if self.job_id else {})}, b""))
        await self._conn.drain()
        t_ack = time.monotonic()
        header, _ = await self._conn.read_frame2()
        tl.STREAM_EVENTS.record(
            tl.EOF_ACK_WAIT, time.monotonic() - t_ack,
            chunks=self.chunks_sent,
            **({"job": self.job_id} if self.job_id else {}))
        if not header.get("ok"):
            KV_TRANSFER.inc("dynamo_kv_transfer_errors_total")
            _raise_nack(header, "chunk stream failed")
        KV_TRANSFER.inc("dynamo_kv_transfer_streams_total")
        if self._t_open is not None:
            KV_TRANSFER.observe("dynamo_kv_transfer_seconds",
                                time.monotonic() - self._t_open)
        return int(header.get("chunks", self.chunks_sent))

    async def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


async def write_pages_stream(host: str, port: int,
                             chunks: Iterable[tuple[list[int], Any]],
                             job_id: Optional[str] = None) -> int:
    """Push (pages, data) chunks as one pipelined stream; returns the
    chunks acked. The chunks are materialized so an integrity nack at eof
    can replay the whole stream once (the nacked copy never reached the
    pool)."""
    chunks = list(chunks)
    for attempt in (0, 1):
        w = PageStreamWriter(host, port, job_id=job_id)
        try:
            for pages, data in chunks:
                await w.write_chunk(pages, data)
            return await w.commit()
        except KvIntegrityError:
            if attempt:
                raise
            KV_INTEGRITY.inc("dynamo_kv_integrity_retries_total")
            log.warning("integrity nack on page stream (job=%s); retrying "
                        "once", job_id)
        finally:
            await w.close()


async def read_remote_pages(host: str, port: int, pages: list[int]):
    """One-sided read: pull pages out of a peer's pool."""
    conn = await _connect(host, port)
    try:
        conn.write(encode_frame2(
            {"op": "read_pages", "pages": [int(p) for p in pages]}, b""))
        await conn.drain()
        header, payload = await conn.read_frame2()
        if not header.get("ok"):
            _raise_nack(header, "read failed")
        KV_TRANSFER.inc("dynamo_kv_transfer_rx_chunks_total")
        KV_TRANSFER.inc("dynamo_kv_transfer_rx_bytes_total", len(payload))
        return _decode_payload(header, payload, copy=True, verify=True)
    finally:
        conn.close()


async def probe_remote_hashes(host: str, port: int,
                              hashes: list[int]) -> tuple[int, Any]:
    """The cheap G4 probe: how many leading blocks of the chained-hash run
    the peer's pool holds, without a page export. A peer without probe
    support answers with the FULL read; those bytes already crossed the
    wire, so they are decoded and returned in the second slot. Raises
    BlockTransferError only when the peer errors outright."""
    conn = await _connect(host, port)
    try:
        conn.write(encode_frame2(
            {"op": "read_hashes", "hashes": [int(h) for h in hashes],
             "probe": True}, b""))
        await conn.drain()
        header, payload = await conn.read_frame2()
        if not header.get("ok"):
            _raise_nack(header, "probe failed")
        found = int(header.get("found", 0))
        if payload and found:
            return found, _decode_payload(header, payload, copy=True,
                                          verify=True)
        return found, None
    finally:
        conn.close()


async def read_remote_hashes(
    host: str, port: int, hashes: list[int], chunk_pages: int = 0,
    on_chunk: Optional[Callable[[int, Any], None]] = None,
) -> tuple[int, Any]:
    """Hash-addressed read: the longest prefix of the chained-hash run
    the peer's pool holds, as (found, pages ``[2, L, kvh, found, ps,
    hd]``), (0, None) on a full miss.

    With ``chunk_pages`` > 0 the peer streams the run as chunk frames
    (its gather of chunk i+1 overlaps chunk i's wire time) and each chunk
    goes to ``on_chunk(page_offset, pages)`` as it arrives; the returned
    pages are then None. Without ``on_chunk`` the chunks are joined and
    returned. A peer that does not stream answers monolithically."""
    conn = await _connect(host, port)
    t0 = time.monotonic()
    try:
        req: dict[str, Any] = {"op": "read_hashes",
                               "hashes": [int(h) for h in hashes]}
        if chunk_pages > 0:
            req["chunk_pages"] = int(chunk_pages)
        conn.write(encode_frame2(req, b""))
        await conn.drain()
        header, payload = await conn.read_frame2()
        if not header.get("ok"):
            _raise_nack(header, "read failed")
        found = int(header.get("found", 0))
        if not found:
            return 0, None
        if not header.get("stream"):
            KV_TRANSFER.inc("dynamo_kv_transfer_rx_chunks_total")
            KV_TRANSFER.inc("dynamo_kv_transfer_rx_bytes_total",
                            len(payload))
            data = _decode_payload(header, payload, copy=True, verify=True)
            if on_chunk is not None:
                on_chunk(0, data)
                return found, None
            return found, data
        parts: list = []
        offset = 0
        while offset < found:
            h, payload = await conn.read_frame2()
            if not h.get("ok"):
                _raise_nack(h, "chunk stream failed")
            arr = _decode_payload(h, payload, copy=True, verify=True)
            KV_TRANSFER.inc("dynamo_kv_transfer_rx_chunks_total")
            KV_TRANSFER.inc("dynamo_kv_transfer_rx_bytes_total",
                            len(payload))
            if on_chunk is not None:
                on_chunk(offset, arr)
            else:
                parts.append(arr)
            offset += int(arr.shape[3])
            if h.get("eof"):
                break
        KV_TRANSFER.observe("dynamo_kv_transfer_seconds",
                            time.monotonic() - t0)
        found = min(found, offset)
        if on_chunk is not None:
            return found, None
        return found, _cat_pages(parts)
    finally:
        conn.close()


class RemoteKvFetcher:
    """KVBM G4, the remote cache tier (reference block_manager.rs:69-82
    CacheLevel::G4): every PEER worker's sealed pool, addressed by chained
    block hash over the transfer plane. A prefix that misses G1/G2/G3
    locally is fetched from whichever peer holds it and lands in the G2
    host tier, where the engine's onboard path takes over.

    With ``chunk_pages`` > 0 peers answer a cheap probe (the committed
    prefix length, no export), then the winner streams its run chunk by
    chunk and each chunk lands through ``on_chunk`` while later ones are
    still on the wire. A ``holders`` hint (the fleet view's, through
    dedup admission) narrows the probe round to the hinted peers first."""

    def __init__(self, kv: KvClient, namespace: str, self_worker_id: str,
                 timeout_s: float = 3.0, chunk_pages: int = 0):
        self.kv = kv
        self.namespace = namespace
        self.self_id = self_worker_id
        self.timeout_s = timeout_s
        self.chunk_pages = chunk_pages
        self.fetches = 0
        self.hits = 0
        self.chunked_fetches = 0

    async def _peers(self) -> list[BlocksetDescriptor]:
        rows = await self.kv.get_prefix(
            f"dynamo://{self.namespace}/{KV_META_PREFIX}")
        peers = []
        for _key, val, _ver in rows:
            try:
                desc = BlocksetDescriptor.from_json(val)
            except (ValueError, KeyError, TypeError):
                continue
            if desc.worker_id != self.self_id:
                peers.append(desc)
        return peers

    async def fetch(
        self, hashes: list[int],
        on_chunk: Optional[Callable[[int, Any], None]] = None,
        holders: Optional[list[str]] = None,
    ) -> tuple[int, Any]:
        """Probe every peer CONCURRENTLY; the longest prefix wins; (0,
        None) if no peer holds anything. ``timeout_s`` bounds the WHOLE
        probe round, not each peer: this runs before a request's intake,
        so dead peers cost one timeout in all. With ``on_chunk`` the
        winning run is delivered as (page_offset, pages) and the returned
        pages are None. ``holders`` is the fleet view's hint of which
        worker ids hold the run: the hinted peers are probed alone first,
        and the rest only when the hint comes back empty."""
        self.fetches += 1
        peers = await self._peers()
        if not peers:
            return 0, None
        if holders:
            hinted_ids = set(holders)
            hinted = [d for d in peers if d.worker_id in hinted_ids]
            rest = [d for d in peers if d.worker_id not in hinted_ids]
            if hinted:
                got = await self._fetch_from(hinted, hashes, on_chunk)
                if got[0] or not rest:
                    return got
                peers = rest  # a stale hint: the un-hinted peers
        return await self._fetch_from(peers, hashes, on_chunk)

    async def _fetch_from(
        self, peers: list[BlocksetDescriptor], hashes: list[int],
        on_chunk: Optional[Callable[[int, Any], None]] = None,
    ) -> tuple[int, Any]:
        if self.chunk_pages > 0 and on_chunk is not None:
            got = await self._fetch_chunked(peers, hashes, on_chunk)
            if got is not None:
                if got:
                    self.hits += 1
                return got, None

        async def probe(desc):
            try:
                return await read_remote_hashes(desc.host, desc.port, hashes)
            except (OSError, BlockTransferError, KvIntegrityError):
                # a peer whose copy fails verification is a miss; another
                # holder may win
                return 0, None

        results = await asyncio.gather(
            *[asyncio.wait_for(probe(d), timeout=self.timeout_s)
              for d in peers], return_exceptions=True)
        best: tuple[int, Any] = (0, None)
        for res in results:
            if isinstance(res, BaseException):
                continue
            if res[0] > best[0]:
                best = res
        if best[0]:
            self.hits += 1
        if best[0] and on_chunk is not None:
            on_chunk(0, best[1])
            return best[0], None
        return best

    async def _fetch_chunked(
        self, peers: list[BlocksetDescriptor], hashes: list[int],
        on_chunk: Callable[[int, Any], None],
    ) -> Optional[int]:
        """The probe round and the streamed fetch from the winner. None:
        no peer answered the probe round, and the caller falls back to
        the full-read race."""

        async def probe(desc):
            try:
                found, data = await probe_remote_hashes(desc.host, desc.port,
                                                        hashes)
                return found, data, desc
            except (OSError, BlockTransferError, KvIntegrityError):
                return -1, None, desc

        results = await asyncio.gather(
            *[asyncio.wait_for(probe(d), timeout=self.timeout_s)
              for d in peers], return_exceptions=True)
        holders: list[tuple[int, BlocksetDescriptor]] = []
        best_full: tuple[int, Any] = (0, None)
        any_answered = False
        for res in results:
            if isinstance(res, BaseException):
                continue
            found, data, desc = res
            if found >= 0:
                any_answered = True
            if found > 0:
                holders.append((found, desc))
                if data is not None and found > best_full[0]:
                    best_full = (found, data)  # a probe-less peer's export
        if not any_answered:
            return None
        if not holders:
            return 0
        if best_full[0] >= max(fd[0] for fd in holders):
            # the best run already arrived whole on the probe round
            on_chunk(0, best_full[1])
            return best_full[0]
        self.chunked_fetches += 1
        # stream from the longest-prefix holder; a dead or stalled winner
        # must not zero the fetch while a runner-up holds the run, so the
        # holders are walked best first under ONE stream deadline (chunks
        # an attempt already landed are hash-addressed: landing them again
        # is idempotent)
        holders.sort(key=lambda fd: fd[0], reverse=True)
        deadline = time.monotonic() + max(self.timeout_s * 20, 60.0)
        for _found, desc in holders:
            budget = deadline - time.monotonic()
            if budget <= 0:
                break
            try:
                found, _ = await asyncio.wait_for(
                    read_remote_hashes(desc.host, desc.port, hashes,
                                       chunk_pages=self.chunk_pages,
                                       on_chunk=on_chunk),
                    timeout=budget)
                return found
            except (OSError, BlockTransferError, KvIntegrityError,
                    asyncio.TimeoutError):
                log.exception("chunked G4 fetch from %s failed",
                              desc.worker_id)
        return 0
