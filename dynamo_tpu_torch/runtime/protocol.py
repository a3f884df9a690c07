"""Wire framing shared by the control-plane store and the data plane (the
port's copy of the JAX package's runtime/protocol.py: the same objects
encode to the same bytes in either package).

Frames are length-prefixed JSON: 4-byte big-endian length + UTF-8 JSON
body. JSON keeps the C++ server (dcp_server.cc) dependency-free; the data
plane reuses the same framing with msgpack-able dict payloads encoded as
JSON for uniformity. This plays the role of the reference's TwoPartCodec
(lib/runtime/src/pipeline/network/codec/two_part.rs:23) — one frame = one
message, header fields inline.

Control-plane ops (store.py / dcp_server.cc):
  {"op": "put",   "key": k, "value": v, "lease": id?}     -> {"ok": true, "rev": n}
  {"op": "get",   "key": k} | {"op": "get_prefix", "prefix": p}
                                       -> {"ok": true, "kvs": [[k, v, lease], ...]}
  {"op": "delete","key": k} | {"op": "delete_prefix", "prefix": p}
                                       -> {"ok": true, "deleted": n}
  {"op": "lease_grant", "ttl": seconds}-> {"ok": true, "lease": id}
  {"op": "lease_keepalive", "lease": id} -> {"ok": true}  (error if expired)
  {"op": "lease_revoke", "lease": id}  -> {"ok": true}
  {"op": "watch", "prefix": p}         -> {"ok": true, "watch": wid} then
      pushed events {"watch": wid, "event": "put"|"delete", "key": k, "value": v}
  {"op": "ping"}                       -> {"ok": true}
All requests carry "req_id"; the matching response echoes it. Watch events
have no req_id.
"""
from __future__ import annotations

import asyncio
import json
import struct
from typing import Any

MAX_FRAME = 64 * 1024 * 1024

_LEN = struct.Struct(">I")


def encode_frame(msg: dict[str, Any]) -> bytes:
    body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    return _LEN.pack(len(body)) + body


async def read_frame(reader: asyncio.StreamReader) -> dict[str, Any]:
    """Read one frame; raises IncompleteReadError on clean EOF."""
    head = await reader.readexactly(4)
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    body = await reader.readexactly(n)
    return json.loads(body)


# ---------------------------------------------------------------------------
# Two-part frames: JSON header + raw binary payload — the bulk data-plane
# framing (KV block transfer). True TwoPartCodec parity (two_part.rs:23):
# 4-byte header length + header + 8-byte payload length + payload.

_PLEN = struct.Struct(">Q")
MAX_PAYLOAD = 8 * 1024 * 1024 * 1024  # 8 GiB: bounded by sanity, not design


def encode_frame2(header: dict[str, Any], payload: bytes) -> bytes:
    return encode_frame2_header(header, len(payload)) + payload


def encode_frame2_header(header: dict[str, Any], payload_nbytes: int) -> bytes:
    """Prefix (lengths + header) alone — callers streaming a large payload
    write this, then the payload buffer, avoiding a full-payload copy."""
    body = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return _LEN.pack(len(body)) + body + _PLEN.pack(payload_nbytes)


async def read_frame2(
    reader: asyncio.StreamReader,
) -> tuple[dict[str, Any], bytes]:
    """Read one header+payload frame; IncompleteReadError on clean EOF."""
    head = await reader.readexactly(4)
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise ValueError(f"header too large: {n}")
    header = json.loads(await reader.readexactly(n))
    (pn,) = _PLEN.unpack(await reader.readexactly(8))
    if pn > MAX_PAYLOAD:
        raise ValueError(f"payload too large: {pn}")
    payload = await reader.readexactly(pn) if pn else b""
    return header, payload


class FrameDecoder:
    """Incremental decoder for sync/byte-buffer contexts (tests, C++ parity
    checks)."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, data: bytes):
        self._buf += data
        out = []
        while len(self._buf) >= 4:
            (n,) = _LEN.unpack(self._buf[:4])
            if len(self._buf) < 4 + n:
                break
            out.append(json.loads(self._buf[4 : 4 + n]))
            self._buf = self._buf[4 + n :]
        return out
