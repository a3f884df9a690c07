"""A small HTTP/1.1 server and client on asyncio streams (stands in for
``aiohttp``, which the JAX package's frontend uses).

Server: ``HttpServer(routes)`` serves ``{(method, path): handler}``; a
handler takes a ``Request`` and returns a ``Response`` (sent with a
``Content-Length``) or a ``StreamResponse`` it has prepared and written
(sent with chunked transfer encoding). Request bodies come by
``Content-Length`` or chunked encoding (``Expect: 100-continue`` is
answered); connections are kept alive unless a side asks to close. While
a handler runs, the server watches its connection: when the client goes
away, the handler's task is cancelled, so the handler's ``finally``
paths run (the service closes its engine streams there, which frees the
engine's slots).

Client: ``HttpClient(host, port)`` sends requests over one keep-alive
connection; ``request(..., stream=True)`` returns as soon as the head
has arrived and yields the body's chunks as they come.
"""
from __future__ import annotations

import asyncio
import json
import logging
from http import HTTPStatus
from typing import Any, AsyncIterator, Awaitable, Callable, Optional, Union
from urllib.parse import parse_qsl, urlsplit

log = logging.getLogger(__name__)

MAX_HEAD_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024
_READ_SIZE = 64 * 1024


class HttpError(Exception):
    """A request the server cannot parse: answered with ``status``, then
    the connection is closed."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Headers(dict):
    """Header fields by lower-cased name (one value each; a repeated
    field keeps the last)."""

    def __setitem__(self, key: str, value: str) -> None:
        super().__setitem__(key.lower(), value)

    def __getitem__(self, key: str) -> str:
        return super().__getitem__(key.lower())

    def __contains__(self, key) -> bool:
        return super().__contains__(key.lower())

    def get(self, key: str, default=None):
        return super().get(key.lower(), default)


class _Buffered:
    """An asyncio StreamReader with a buffer this module owns, so bytes
    read while watching for a disconnect are kept for the next request."""

    def __init__(self, reader: asyncio.StreamReader):
        self._reader = reader
        self.buf = bytearray()

    async def fill(self) -> bool:
        """Read what arrives next into the buffer; False at EOF."""
        data = await self._reader.read(_READ_SIZE)
        self.buf += data
        return bool(data)

    async def readuntil(self, sep: bytes, limit: int) -> bytes:
        start = 0
        while True:
            i = self.buf.find(sep, start)
            if i != -1:
                out = bytes(self.buf[:i + len(sep)])
                del self.buf[:i + len(sep)]
                return out
            if len(self.buf) > limit:
                raise HttpError(431, "header section too large")
            start = max(0, len(self.buf) - len(sep) + 1)
            if not await self.fill():
                raise EOFError

    async def readexactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self.fill():
                raise EOFError
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out


def _parse_head(head: bytes) -> tuple[str, Headers]:
    """Start line and header fields of a request or response head."""
    lines = head.decode("latin-1").split("\r\n")
    headers = Headers()
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name or name != name.strip():
            raise HttpError(400, f"malformed header line {line[:40]!r}")
        headers[name] = value.strip()
    return lines[0], headers


async def _read_body(rd: _Buffered, headers: Headers) -> bytes:
    te = headers.get("transfer-encoding", "").lower()
    if te:
        if te != "chunked":
            raise HttpError(501, f"transfer-encoding {te!r}")
        parts, total = [], 0
        while True:
            size_line = await rd.readuntil(b"\r\n", 1024)
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError:
                raise HttpError(400, "bad chunk size") from None
            if size == 0:
                # trailer fields, up to the blank line
                while await rd.readuntil(b"\r\n", MAX_HEAD_BYTES) != b"\r\n":
                    pass
                return b"".join(parts)
            total += size
            if total > MAX_BODY_BYTES:
                raise HttpError(413, "body too large")
            parts.append(await rd.readexactly(size))
            if await rd.readexactly(2) != b"\r\n":
                raise HttpError(400, "chunk not terminated")
    length = headers.get("content-length")
    if length is None:
        return b""
    try:
        n = int(length)
    except ValueError:
        raise HttpError(400, "bad content-length") from None
    if n < 0:
        raise HttpError(400, "bad content-length")
    if n > MAX_BODY_BYTES:
        raise HttpError(413, "body too large")
    return await rd.readexactly(n)


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


def _head(status: int, headers: dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {_reason(status)}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Request:
    def __init__(self, method: str, target: str, headers: Headers,
                 body: bytes, writer: asyncio.StreamWriter):
        self.method = method
        url = urlsplit(target)
        self.path = url.path
        self.query = dict(parse_qsl(url.query))
        self.headers = headers
        self.body = body
        self._writer = writer
        self._keep_alive = True
        self._streaming = False

    def json(self) -> Any:
        return json.loads(self.body)


class Response:
    """A whole response, sent with a Content-Length."""

    def __init__(self, body: bytes = b"", *, status: int = 200,
                 content_type: str = "application/json",
                 headers: Optional[dict[str, str]] = None):
        self.status = status
        self.body = body
        self.headers = {"Content-Type": content_type, **(headers or {})}

    @classmethod
    def json(cls, obj: Any, *, status: int = 200,
             headers: Optional[dict[str, str]] = None) -> "Response":
        return cls(json.dumps(obj).encode(), status=status,
                   headers=headers)


class StreamResponse:
    """A response whose body is written piece by piece, with chunked
    transfer encoding: ``await prepare(request)``, ``await write(data)``
    any number of times, ``await write_eof()``. A write to a client that
    went away raises ``ConnectionResetError``."""

    def __init__(self, *, status: int = 200,
                 headers: Optional[dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._writer: Optional[asyncio.StreamWriter] = None
        self._eof = False

    async def prepare(self, request: Request) -> None:
        self._writer = request._writer
        request._streaming = True
        self.headers["Transfer-Encoding"] = "chunked"
        self._writer.write(_head(self.status, self.headers))
        await self._drain()

    async def _drain(self) -> None:
        if self._writer.is_closing():
            raise ConnectionResetError("client went away")
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if data:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await self._drain()

    async def write_eof(self) -> None:
        if not self._eof:
            self._eof = True
            self._writer.write(b"0\r\n\r\n")
            await self._drain()


Handler = Callable[[Request], Awaitable[Union[Response, StreamResponse]]]


class HttpServer:
    """Serves ``routes``: {(method, path): handler}."""

    def __init__(self, routes: dict[tuple[str, str], Handler]):
        self.routes = routes
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[asyncio.Task] = set()

    async def start(self, host: str, port: int) -> int:
        """Listen; returns the bound port (``port`` 0 picks a free one)."""
        self._server = await asyncio.start_server(self._serve, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for t in list(self._conns):
                t.cancel()
            await asyncio.gather(*self._conns, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        rd = _Buffered(reader)
        try:
            while True:
                try:
                    req = await self._read_request(rd, writer)
                except EOFError:
                    return
                except HttpError as e:
                    msg = json.dumps({"error": {
                        "message": str(e), "code": e.status}}).encode()
                    writer.write(_head(e.status, {
                        "Content-Type": "application/json",
                        "Content-Length": str(len(msg)),
                        "Connection": "close"}) + msg)
                    await writer.drain()
                    return
                if not await self._respond(req, rd, writer):
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            return
        finally:
            self._conns.discard(task)
            writer.close()

    async def _read_request(self, rd: _Buffered,
                            writer: asyncio.StreamWriter) -> Request:
        while True:
            head = await rd.readuntil(b"\r\n\r\n", MAX_HEAD_BYTES)
            if head.strip():
                break  # tolerate blank lines between requests
        start, headers = _parse_head(head[:-4])
        parts = start.split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise HttpError(400, f"bad request line {start[:60]!r}")
        method, target, version = parts
        if headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        body = await _read_body(rd, headers)
        req = Request(method, target, headers, body, writer)
        conn = headers.get("connection", "").lower()
        req._keep_alive = (conn == "keep-alive" if version == "HTTP/1.0"
                           else conn != "close")
        return req

    async def _respond(self, req: Request, rd: _Buffered,
                       writer: asyncio.StreamWriter) -> bool:
        """Run the request's handler and send its response; False when
        the connection must close."""
        handler = self.routes.get((req.method, req.path))
        if handler is None:
            known = any(p == req.path for _, p in self.routes)
            handler = _not_found(405 if known else 404)
        work = asyncio.ensure_future(handler(req))
        # the client may not send before this response ends (no
        # pipelining is expected), so EOF on the connection means it left
        watch = asyncio.ensure_future(rd.fill())
        try:
            while True:
                done, _ = await asyncio.wait(
                    {work, watch}, return_when=asyncio.FIRST_COMPLETED)
                if work in done:
                    break
                if not watch.result() or len(rd.buf) > MAX_HEAD_BYTES:
                    return False
                watch = asyncio.ensure_future(rd.fill())
        finally:
            for t in (work, watch):
                if not t.done():
                    t.cancel()
            await asyncio.gather(work, watch, return_exceptions=True)
        try:
            resp = work.result()
        except ConnectionError:
            return False
        except Exception:  # noqa: BLE001 — the connection must be answered
            log.exception("handler for %s %s failed", req.method, req.path)
            if req._streaming:
                return False  # a response is under way: only closing ends it
            resp = Response.json(
                {"error": {"message": "internal error",
                           "type": "internal_server_error", "code": 500}},
                status=500)
        if isinstance(resp, StreamResponse):
            if resp._writer is None:
                raise RuntimeError("StreamResponse returned unprepared")
            await resp.write_eof()
            return req._keep_alive
        headers = dict(resp.headers)
        headers["Content-Length"] = str(len(resp.body))
        if not req._keep_alive:
            headers["Connection"] = "close"
        writer.write(_head(resp.status, headers) + resp.body)
        await writer.drain()
        return req._keep_alive


def _not_found(status: int) -> Handler:
    async def handler(req: Request) -> Response:
        return Response.json(
            {"error": {"message": f"{req.method} {req.path}: "
                                  f"{_reason(status).lower()}",
                       "type": "not_found_error", "code": status}},
            status=status)
    return handler


# ---------------------------------------------------------------------------
# client


class ClientResponse:
    def __init__(self, status: int, headers: Headers, client: "HttpClient",
                 chunked: bool, length: Optional[int]):
        self.status = status
        self.headers = headers
        self.body = b""
        self._client = client
        self._chunked = chunked
        self._length = length

    def json(self) -> Any:
        return json.loads(self.body)

    async def chunks(self) -> AsyncIterator[bytes]:
        """The body as it arrives (one piece per chunk when chunked)."""
        rd = self._client._rd
        if self._chunked:
            while True:
                size = int((await rd.readuntil(b"\r\n", 1024)).split(
                    b";")[0].strip(), 16)
                if size == 0:
                    while await rd.readuntil(b"\r\n", MAX_HEAD_BYTES) \
                            != b"\r\n":
                        pass
                    break
                data = await rd.readexactly(size)
                await rd.readexactly(2)
                yield data
        else:  # the server sends a Content-Length otherwise
            left = self._length or 0
            while left:
                if not rd.buf and not await rd.fill():
                    raise EOFError("connection closed mid-body")
                data = bytes(rd.buf[:left])
                del rd.buf[:len(data)]
                left -= len(data)
                yield data
        self._client._busy = False

    async def read(self) -> bytes:
        self.body = b"".join([c async for c in self.chunks()])
        return self.body


class HttpClient:
    """HTTP/1.1 client over one keep-alive connection to ``host:port``;
    one request at a time (open one client per concurrent stream)."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._rd: Optional[_Buffered] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._busy = False
        self._must_reconnect = False

    async def __aenter__(self) -> "HttpClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        """Close the connection (mid-stream too: the server sees the
        client go away)."""
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except ConnectionError:
                pass
        self._rd = self._writer = None
        self._busy = False

    async def request(self, method: str, path: str, *, json_body: Any = None,
                      body: Optional[bytes] = None,
                      headers: Optional[dict[str, str]] = None,
                      stream: bool = False) -> ClientResponse:
        """Send one request. Without ``stream`` the body is read into
        ``.body``; with it, read it through ``chunks()`` before the next
        request."""
        if self._busy:
            raise RuntimeError("the previous response was not read")
        if self._writer is None or self._must_reconnect \
                or self._writer.is_closing():
            await self.close()
            reader, self._writer = await asyncio.open_connection(
                self.host, self.port)
            self._rd = _Buffered(reader)
            self._must_reconnect = False
        if json_body is not None:
            body = json.dumps(json_body).encode()
        hdrs = {"Host": f"{self.host}:{self.port}",
                "Content-Length": str(len(body or b""))}
        if json_body is not None:
            hdrs["Content-Type"] = "application/json"
        hdrs.update(headers or {})
        lines = [f"{method} {path} HTTP/1.1"] + [
            f"{k}: {v}" for k, v in hdrs.items()]
        self._writer.write(("\r\n".join(lines) + "\r\n\r\n").encode(
            "latin-1") + (body or b""))
        await self._writer.drain()
        while True:
            head = await self._rd.readuntil(b"\r\n\r\n", MAX_HEAD_BYTES)
            start, rh = _parse_head(head[:-4])
            status = int(start.split(" ")[1])
            if status != 100:
                break
        if rh.get("connection", "").lower() == "close":
            self._must_reconnect = True
        length = rh.get("content-length")
        resp = ClientResponse(
            status, rh, self,
            rh.get("transfer-encoding", "").lower() == "chunked",
            int(length) if length is not None else None)
        self._busy = True
        if not stream:
            await resp.read()
        return resp
