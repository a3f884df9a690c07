"""Pretty-print a /debug/trace span tree (a copy of the JAX package's
tools/trace_dump.py, fetching over the port's HTTP client).

Usage:
    python -m dynamo_tpu_torch.tools.trace_dump \
        http://HOST:PORT/debug/trace/REQUEST_ID
    python -m dynamo_tpu_torch.tools.trace_dump trace.json
    curl -s .../debug/trace/ID | python -m dynamo_tpu_torch.tools.trace_dump -

Renders the spans as a time-ordered tree with durations and attributes,
e.g.::

    trace 3f9c... (finished)
      0.000s  tokenize          0.4ms   model=tiny prompt_tokens=19
      0.001s  route             0.1ms   worker=1 overlap_blocks=0
      0.002s  queue             0.2ms
      0.003s  prefill          41.3ms   prompt_tokens=19 matched_blocks=0
      0.045s  decode_round      5.1ms   tokens=4

Offsets are relative to the earliest span start.
"""
from __future__ import annotations

import asyncio
import json
import sys
from typing import Any
from urllib.parse import urlsplit

from dynamo_tpu_torch.frontend.http import HttpClient


class FetchError(Exception):
    """A non-200 answer; ``body`` is its parsed JSON (or None)."""

    def __init__(self, status: int, body: Any):
        super().__init__(f"HTTP {status}")
        self.status = status
        self.body = body


def fetch_json(url: str, timeout_s: float = 10.0) -> Any:
    """GET ``url`` (http://HOST:PORT/PATH) with the port's client."""
    u = urlsplit(url)
    path = u.path + (f"?{u.query}" if u.query else "")

    async def get() -> tuple[int, bytes]:
        async with HttpClient(u.hostname, u.port or 80) as c:
            r = await c.request("GET", path)
            return r.status, r.body

    status, body = asyncio.run(asyncio.wait_for(get(), timeout_s))
    doc = json.loads(body) if body else None
    if status != 200:
        raise FetchError(status, doc)
    return doc


def load(source: str) -> dict[str, Any]:
    """A JSON document from stdin (``-``), an http URL or a file. A URL
    answering non-200 gives its JSON body (it carries ``error``)."""
    if source == "-":
        return json.load(sys.stdin)
    if source.startswith("http://"):
        try:
            return fetch_json(source)
        except FetchError as e:
            return e.body if isinstance(e.body, dict) else {
                "error": str(e)}
    with open(source) as f:
        return json.load(f)


def _fmt_dur(s: float) -> str:
    if s >= 1.0:
        return f"{s:7.3f}s "
    return f"{s * 1e3:7.1f}ms"


def _fmt_attrs(attrs: dict[str, Any]) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))


def _walk(span: dict[str, Any], t0: float, depth: int,
          out: list[str]) -> None:
    pad = "  " * depth
    out.append(
        f"  {span.get('start_s', t0) - t0:7.3f}s  "
        f"{pad}{span.get('name', '?'):<18}"
        f"{_fmt_dur(float(span.get('duration_s', 0.0)))}"
        f"   {_fmt_attrs(span.get('attrs') or {})}".rstrip()
    )
    for child in span.get("children") or []:
        _walk(child, t0, depth + 1, out)


def render_trace(trace: dict[str, Any]) -> str:
    spans = sorted(trace.get("spans") or [],
                   key=lambda s: s.get("start_s", 0.0))
    state = "finished" if trace.get("finished") else "in flight"
    lines = [f"trace {trace.get('trace_id', '?')} ({state})"]
    if not spans:
        lines.append("  (no spans)")
        return "\n".join(lines)
    t0 = min(s.get("start_s", 0.0) for s in spans)
    for span in spans:
        _walk(span, t0, 0, lines)
    total = max(s.get("start_s", 0.0) + float(s.get("duration_s", 0.0))
                for s in spans) - t0
    lines.append(f"  total {_fmt_dur(total).strip()} across "
                 f"{len(spans)} spans")
    return "\n".join(lines)


def main(argv: list[str]) -> int:
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 2
    trace = load(argv[0])
    if "error" in trace:
        print(f"error: {trace['error']}", file=sys.stderr)
        return 1
    print(render_trace(trace))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
