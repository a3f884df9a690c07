"""Server-sent-events codec (a copy of the JAX package's protocols/sse.py;
reference lib/llm/src/protocols/codec.rs).

Encoder: JSON dict -> `data: {...}\n\n` bytes, with the terminal
`data: [DONE]` sentinel. Decoder: incremental byte feed -> parsed events,
usable by clients and tests.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Iterator, Optional

DONE = "[DONE]"


def encode_event(data: dict[str, Any] | str, event: Optional[str] = None) -> bytes:
    payload = data if isinstance(data, str) else json.dumps(data, separators=(",", ":"))
    head = f"event: {event}\n" if event else ""
    return (head + f"data: {payload}\n\n").encode("utf-8")


def encode_done() -> bytes:
    return encode_event(DONE)


def encode_comment(text: str) -> bytes:
    return f": {text}\n\n".encode("utf-8")


@dataclass
class SseEvent:
    data: str
    event: Optional[str] = None

    @property
    def is_done(self) -> bool:
        return self.data.strip() == DONE

    def json(self) -> Any:
        return json.loads(self.data)


class SseDecoder:
    """Incremental SSE parser: feed bytes, iterate complete events."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, data: bytes) -> Iterator[SseEvent]:
        self._buf += data
        while True:
            # events are separated by a blank line (\n\n or \r\n\r\n)
            for sep in (b"\n\n", b"\r\n\r\n"):
                idx = self._buf.find(sep)
                if idx != -1:
                    raw, self._buf = self._buf[:idx], self._buf[idx + len(sep) :]
                    ev = self._parse(raw.decode("utf-8", errors="replace"))
                    if ev is not None:
                        yield ev
                    break
            else:
                return

    @staticmethod
    def _parse(block: str) -> Optional[SseEvent]:
        data_lines: list[str] = []
        event: Optional[str] = None
        for line in block.splitlines():
            if line.startswith(":"):
                continue  # comment
            if line.startswith("data:"):
                data_lines.append(line[5:].lstrip())
            elif line.startswith("event:"):
                event = line[6:].strip()
        if not data_lines and event is None:
            return None
        return SseEvent(data="\n".join(data_lines), event=event)
