"""Data plane: push RPC with streamed responses over direct TCP (the
port's copy of the JAX package's runtime/endpoint.py).

Reference shape: PushRouter publishes a request over NATS to a worker whose
PushEndpoint then opens a TCP connection BACK to the requester's
TcpStreamServer and streams the response (push_endpoint.rs:26,
tcp/server.rs, two_part.rs). Here both legs collapse into one direct TCP
connection from router to worker — the worker's endpoint server address
is in the control-plane store, so there is no need for a broker hop or a
call-home: fewer copies, same streaming + cancellation semantics.

Wire: length-prefixed JSON frames (runtime/protocol.py).
  client -> server:  {"request": <payload>, "request_id": "..."}
  server -> client:  {"data": <payload>} ... then {"done": true}
                     or {"error": "...", "done": true}
Closing the connection mid-stream cancels the server-side handler (the
drop-to-cancel contract, reference engine.rs:124-140).
"""
from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.overload.errors import EngineOverloadedError
from dynamo_tpu_torch.runtime.protocol import encode_frame, read_frame

log = logging.getLogger(__name__)

# handler: async def h(payload) -> AsyncIterator[payload]
Handler = Callable[[dict[str, Any]], AsyncIterator[dict[str, Any]]]


class EndpointServer:
    """Serves one handler on a TCP port; one request per connection."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _on_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        stream = None
        try:
            req = await read_frame(reader)
            payload = req.get("request", {})
            stream = self.handler(payload)
            async for item in stream:
                writer.write(encode_frame({"data": item}))
                await writer.drain()
            writer.write(encode_frame({"done": True}))
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            log.debug("client dropped mid-stream; handler cancelled")
        except Exception as e:  # noqa: BLE001 — surface handler errors in-band
            log.exception("endpoint handler failed")
            try:
                # a ConnectionError from the handler (draining worker, dead
                # downstream) is RETRIABLE: the client should re-route, not
                # fail the request — mark the frame so call_endpoint raises
                # the retriable error class
                frame = {"error": str(e), "done": True}
                if isinstance(e, ConnectionError):
                    frame["retriable"] = True
                if isinstance(e, EngineOverloadedError):
                    # overload is retriable AND typed: the client must
                    # re-raise the overload class (the router's spill
                    # path and the frontend's 429 both key on it) with
                    # the load-derived Retry-After hint intact
                    frame["overloaded"] = True
                    frame["retry_after_s"] = e.retry_after_s
                    frame["tenant"] = e.tenant
                writer.write(encode_frame(frame))
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass
        finally:
            if stream is not None:
                close = getattr(stream, "aclose", None)
                if close is not None:
                    try:
                        await close()
                    except Exception:  # noqa: BLE001
                        log.debug("handler stream close failed",
                                  exc_info=True)
            writer.close()


class EndpointStreamError(RuntimeError):
    """Handler-side error reported in-band by the worker."""


class EndpointConnectionError(EndpointStreamError, ConnectionError):
    """Transport-level failure (worker unreachable or died mid-stream) —
    retriable by routers, unlike an in-band handler error."""


async def call_endpoint(
    host: str, port: int, payload: dict[str, Any], request_id: str = ""
) -> AsyncIterator[dict[str, Any]]:
    """Open a stream to an endpoint instance; yields response payloads.
    Closing the generator closes the connection (cancels remotely)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(encode_frame({"request": payload, "request_id": request_id}))
        await writer.drain()
        while True:
            msg = await read_frame(reader)
            if "data" in msg:
                yield msg["data"]
            if msg.get("error"):
                if msg.get("overloaded"):
                    raise EngineOverloadedError(
                        msg["error"],
                        retry_after_s=float(
                            msg.get("retry_after_s", 1.0)),
                        tenant=str(msg.get("tenant", "")),
                    )
                if msg.get("retriable"):
                    raise EndpointConnectionError(msg["error"])
                raise EndpointStreamError(msg["error"])
            if msg.get("done"):
                return
    except asyncio.IncompleteReadError as e:
        raise EndpointConnectionError("worker connection lost mid-stream") from e
    finally:
        writer.close()
