"""Perfetto/Chrome-trace timeline assembly for one request or serving run
(a copy of the JAX package's telemetry/timeline.py).

Merges four event sources into a single ``trace.json`` loadable at
ui.perfetto.dev (or chrome://tracing):

- the request span tree (telemetry/trace.py — frontend + worker spans,
  including disagg kv-chunk and spec draft/verify children),
- per-round host-segment breakdowns (telemetry/prof.py RoundProf ring),
- flight-recorder dispatch events (telemetry/flight.py),
- kv_transfer / disagg STREAM events recorded here: frame sends/recvs,
  eof-ack waits and commit-event wakeups — the micro-events that make
  the disagg overlap gaps visible as timeline holes rather than one
  overlap ratio.

Everything renders as standard Trace Event Format: ``X`` (complete)
events with µs timestamps on per-source tracks, ``i`` (instant) events
for the flight recorder. ``python -m dynamo_tpu_torch.tools.trace_export``
is the CLI.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

from .prof import SEGMENTS

# stream-event kinds (the kv_transfer/disagg instrumentation contract)
FRAME_SEND = "frame_send"        # a page stream writer sends a chunk
FRAME_RECV = "frame_recv"        # the transfer server lands a chunk
EOF_ACK_WAIT = "eof_ack_wait"    # a page stream writer waits for its ack
COMMIT_WAKEUP = "commit_wakeup"  # disagg PrefillWorker wakes on commits


class StreamEventRing:
    """Bounded ring of kv-transfer/disagg stream events; process-global
    (stream endpoints live in several classes across two modules — a ring
    per object would fragment the timeline). Thread-safe: asyncio
    handlers and the engine thread both record."""

    def __init__(self, capacity: int = 2048):
        self.capacity = max(1, int(capacity))
        self._ring: list[Optional[dict[str, Any]]] = [None] * self.capacity
        self._next = 0
        self._seq = 0
        self._lock = threading.Lock()

    def record(self, kind: str, dur_s: float = 0.0, **attrs: Any) -> None:
        """Record an event ENDING now that lasted ``dur_s`` seconds."""
        ts = time.time() - dur_s
        with self._lock:
            ev = {"seq": self._seq, "kind": kind,
                  "ts": round(ts, 6), "dur_s": round(dur_s, 6), **attrs}
            self._seq += 1
            self._ring[self._next] = ev
            self._next = (self._next + 1) % self.capacity

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            if self._seq < self.capacity:
                out = self._ring[: self._next]
            else:
                out = self._ring[self._next:] + self._ring[: self._next]
            return [dict(e) for e in out if e is not None]

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._next = 0
            self._seq = 0


STREAM_EVENTS = StreamEventRing()

# track (pid, name) layout of the merged timeline
_PID_SPANS = 1
_PID_ROUNDS = 2
_PID_FLIGHT = 3
_PID_STREAM = 4
_TRACK_NAMES = {
    _PID_SPANS: "request spans",
    _PID_ROUNDS: "engine host rounds",
    _PID_FLIGHT: "flight recorder",
    _PID_STREAM: "kv_transfer streams",
}


def _us(unix_s: float) -> int:
    return int(unix_s * 1e6)


def _span_events(span: dict[str, Any], tid: int,
                 out: list[dict[str, Any]]) -> None:
    """One span dict (telemetry.trace.Span.to_dict form) + children →
    nested ``X`` events on one track (Chrome nests by time containment)."""
    start = float(span.get("start_s", 0.0))
    dur = max(float(span.get("duration_s", 0.0)), 0.0)
    out.append({
        "ph": "X", "pid": _PID_SPANS, "tid": tid,
        "ts": _us(start), "dur": max(_us(start + dur) - _us(start), 1),
        "name": str(span.get("name", "span")), "cat": "span",
        "args": dict(span.get("attrs") or {}),
    })
    for child in span.get("children") or []:
        _span_events(child, tid, out)


def _round_events(records: list[tuple],
                  out: list[dict[str, Any]]) -> None:
    """RoundProf ring records (end_unix_s, wall_s, per-seg seconds) →
    one ``host_round`` event per round with sequential per-segment
    children in enum order (the flat switch model keeps totals, not
    intervals — within-round layout is therefore approximate; the
    durations are exact)."""
    for end_s, wall_s, acc in records:
        start = end_s - wall_s
        out.append({
            "ph": "X", "pid": _PID_ROUNDS, "tid": 1,
            "ts": _us(start), "dur": max(_us(end_s) - _us(start), 1),
            "name": "host_round", "cat": "round",
            "args": {
                "wall_us": round(wall_s * 1e6, 1),
                **{s: round(acc[i] * 1e6, 1)
                   for i, s in enumerate(SEGMENTS) if acc[i] > 0},
            },
        })
        t = start
        for i, seg in enumerate(SEGMENTS):
            d = acc[i]
            if d <= 0.0:
                continue
            out.append({
                "ph": "X", "pid": _PID_ROUNDS, "tid": 2,
                "ts": _us(t), "dur": max(int(d * 1e6), 1),
                "name": seg, "cat": "round_segment", "args": {},
            })
            t += d


def _flight_events(events: list[dict[str, Any]],
                   out: list[dict[str, Any]]) -> None:
    for ev in events:
        args = {k: v for k, v in ev.items()
                if k not in ("ts", "kind", "seq")}
        out.append({
            "ph": "i", "pid": _PID_FLIGHT, "tid": 1, "s": "t",
            "ts": _us(float(ev.get("ts", 0.0))),
            "name": str(ev.get("kind", "event")), "cat": "flight",
            "args": args,
        })


def _stream_events(events: list[dict[str, Any]],
                   out: list[dict[str, Any]]) -> None:
    tids: dict[str, int] = {}
    for ev in events:
        kind = str(ev.get("kind", "stream"))
        tid = tids.setdefault(kind, len(tids) + 1)
        args = {k: v for k, v in ev.items()
                if k not in ("ts", "dur_s", "kind", "seq")}
        start = float(ev.get("ts", 0.0))
        dur_us = max(int(float(ev.get("dur_s", 0.0)) * 1e6), 1)
        out.append({
            "ph": "X", "pid": _PID_STREAM, "tid": tid,
            "ts": _us(start), "dur": dur_us,
            "name": kind, "cat": "kv_stream", "args": args,
        })


def to_chrome_trace(
    spans: Optional[list[dict[str, Any]]] = None,
    round_records: Optional[list[tuple]] = None,
    flight_events: Optional[list[dict[str, Any]]] = None,
    stream_events: Optional[list[dict[str, Any]]] = None,
    label: str = "",
) -> dict[str, Any]:
    """Merge the four sources into one Trace Event Format document.
    Every argument is optional — pass what the caller has (a request's
    span dicts, a RoundProf ring snapshot, FlightRecorder.snapshot(),
    STREAM_EVENTS.snapshot())."""
    events: list[dict[str, Any]] = []
    for pid, name in _TRACK_NAMES.items():
        events.append({
            "ph": "M", "pid": pid, "tid": 0,
            "name": "process_name", "args": {"name": name},
        })
    for sp in spans or []:
        _span_events(sp, tid=1, out=events)
    _round_events(round_records or [], events)
    _flight_events(flight_events or [], events)
    _stream_events(stream_events or [], events)
    doc: dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }
    if label:
        doc["otherData"] = {"label": label}
    return doc


def trace_to_chrome(trace_dict: dict[str, Any],
                    **extra: Any) -> dict[str, Any]:
    """Convenience: a ``/debug/trace/{id}`` response body (Trace.to_dict
    form) → Chrome trace, optionally merged with the other sources via
    keyword passthrough to :func:`to_chrome_trace`."""
    return to_chrome_trace(
        spans=list(trace_dict.get("spans") or []),
        label=str(trace_dict.get("trace_id", "")),
        **extra,
    )


__all__ = [
    "FRAME_SEND",
    "FRAME_RECV",
    "EOF_ACK_WAIT",
    "COMMIT_WAKEUP",
    "StreamEventRing",
    "STREAM_EVENTS",
    "to_chrome_trace",
    "trace_to_chrome",
]
