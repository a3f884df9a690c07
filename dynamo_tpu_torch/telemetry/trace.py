"""Trace context: one span tree per request, assembled across processes
(a copy of the JAX package's telemetry/trace.py).

The frontend mints a trace keyed by the request's ``request_id`` (which
already travels through the runtime protocol in every frame and in the
PreprocessedRequest payload — no extra wire field needed). Stages in the
frontend process (tokenize, route) record spans directly; the worker
engine accumulates its spans (queue wait, prefill, decode/verify rounds,
G2 onboard) on the request and ships them back on the finishing
LLMEngineOutput under ``annotations["trace"]`` — the frontend merges them
into its tree. A worker that owns no active trace for the request id
(i.e. the frontend is a different process) registers the spans in its
OWN store, so the per-worker system server can serve
``/debug/trace/{request_id}`` too.

Completed traces park in a bounded ring (oldest evicted); everything is
lock-guarded because the engine thread records while the asyncio side
serves.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class Span:
    """One timed stage. ``start_s`` is unix time; ``duration_s`` wall."""

    name: str
    start_s: float
    duration_s: float = 0.0
    attrs: dict[str, Any] = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "start_s": round(self.start_s, 6),
            "duration_s": round(self.duration_s, 6),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Span":
        return cls(
            name=str(d.get("name", "")),
            start_s=float(d.get("start_s", 0.0)),
            duration_s=float(d.get("duration_s", 0.0)),
            attrs=dict(d.get("attrs") or {}),
            children=[cls.from_dict(c) for c in d.get("children") or []],
        )


def span_now(name: str, t0_monotonic: float, **attrs: Any) -> Span:
    """Span ending now that began at monotonic time ``t0_monotonic``."""
    dur = time.monotonic() - t0_monotonic
    return Span(name=name, start_s=time.time() - dur, duration_s=dur,
                attrs=attrs)


# spans a shell trace buffers while unsampled, so a LATE promotion (an
# SLO breach only detectable at finish) still recovers the request's
# whole path; bounded so a pathological span source can't grow a shell
_SHELL_BUFFER_CAP = 160


@dataclass
class Trace:
    """One request's span tree (flat span list; stage order by start).

    ``sampled=False`` traces are shells: spans park in a small bounded
    side buffer and the trace is dropped at finish instead of parking in
    the completed ring — the high-QPS sampling mode (--trace-sample-rate)
    never pays completed-ring assembly for unsampled requests. A shell
    can be PROMOTED at any point before finish (migration/failure paths
    always trace; SLO-breach forensics promotes at finish time) and the
    buffered spans are adopted, so even a promotion on the request's
    last instruction yields a complete tree."""

    trace_id: str
    created_s: float = field(default_factory=time.time)
    spans: list[Span] = field(default_factory=list)
    finished: bool = False
    sampled: bool = True
    buffered: list[Span] = field(default_factory=list)

    def add(self, span: Span) -> None:
        if self.sampled:
            self.spans.append(span)
        elif len(self.buffered) < _SHELL_BUFFER_CAP:
            self.buffered.append(span)

    def adopt_buffer(self) -> None:
        """Promote: fold the shell's buffered spans into the real tree."""
        if self.buffered:
            self.spans.extend(self.buffered)
            self.buffered = []

    def merge_dicts(self, span_dicts: list[dict[str, Any]]) -> None:
        """Fold worker-side spans (annotation payload) into the tree."""
        for d in span_dicts:
            try:
                self.spans.append(Span.from_dict(d))
            except (TypeError, ValueError):
                continue

    def span_names(self) -> list[str]:
        return [s.name for s in sorted(self.spans, key=lambda s: s.start_s)]

    def to_dict(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "created_s": round(self.created_s, 6),
            "finished": self.finished,
            "spans": [
                s.to_dict()
                for s in sorted(self.spans, key=lambda s: s.start_s)
            ],
        }


class TraceStore:
    """Active traces + a bounded ring of completed ones."""

    def __init__(self, max_completed: int = 512, max_active: int = 4096):
        self.max_completed = max_completed
        self.max_active = max_active
        self._active: dict[str, Trace] = {}
        # secondary ids resolving onto an active trace — the n>1 fanout
        # gives each extra choice its own request_id; their spans belong
        # on the parent request's tree
        self._aliases: dict[str, str] = {}
        self._completed: OrderedDict[str, Trace] = OrderedDict()
        # ids we saw but no longer hold, mapped to WHY ("evicted" ring
        # overflow vs "unsampled" shell drop) — lets /debug/trace 404s
        # distinguish "gone" from "never existed"; bounded like the ring
        self._gone: OrderedDict[str, str] = OrderedDict()
        self.evicted_total = 0
        self._lock = threading.Lock()

    def _note_gone(self, trace_id: str, reason: str) -> None:
        # caller holds self._lock
        self._gone[trace_id] = reason
        self._gone.move_to_end(trace_id)
        while len(self._gone) > 8 * self.max_completed:
            self._gone.popitem(last=False)

    def start(self, trace_id: str, sampled: bool = True) -> Trace:
        tr = Trace(trace_id=trace_id, sampled=sampled)
        with self._lock:
            # leak bound: a caller that never finishes its traces (crashed
            # stream, test teardown) must not grow the store unboundedly
            if len(self._active) >= self.max_active:
                self._active.pop(next(iter(self._active)))
            self._active[trace_id] = tr
        return tr

    def alias(self, trace_id: str, parent_id: str) -> None:
        """Route ``trace_id``'s spans onto ``parent_id``'s active trace
        (dropped when the parent finishes)."""
        with self._lock:
            if parent_id in self._active:
                self._aliases[trace_id] = parent_id

    def _resolve(self, trace_id: str) -> Optional[Trace]:
        return self._active.get(
            self._aliases.get(trace_id, trace_id)
        )

    def has_active(self, trace_id: str) -> bool:
        with self._lock:
            return self._resolve(trace_id) is not None

    def add_span(self, trace_id: str, span: Span) -> bool:
        """Record onto an ACTIVE trace; no-op (False) when none exists —
        stages call this unconditionally and remote-frontend cases fall
        through to the annotation path."""
        with self._lock:
            tr = self._resolve(trace_id)
            if tr is None:
                return False
            tr.add(span)  # shells buffer (bounded) for late promotion
            return tr.sampled

    def promote(self, trace_id: str) -> bool:
        """Turn an unsampled shell into a full trace mid-request —
        migrated/failed requests are always traced regardless of the
        sample rate. True if an active trace exists."""
        with self._lock:
            tr = self._resolve(trace_id)
            if tr is None:
                return False
            tr.sampled = True
            tr.adopt_buffer()
            return True

    def merge(self, trace_id: str, span_dicts: list[dict[str, Any]]) -> None:
        with self._lock:
            tr = self._resolve(trace_id)
        if tr is None:
            return
        if tr.sampled:
            tr.merge_dicts(span_dicts)
        else:
            # shell: park worker spans in the bounded buffer so a
            # finish-time promotion recovers them
            room = _SHELL_BUFFER_CAP - len(tr.buffered)
            if room > 0:
                shadow = Trace(trace_id=trace_id)
                shadow.merge_dicts(span_dicts[:room])
                tr.buffered.extend(shadow.spans)

    def finish(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            tr = self._active.pop(trace_id, None)
            if tr is None:
                return None
            self._aliases = {
                a: p for a, p in self._aliases.items() if p != trace_id
            }
            tr.finished = True
            if not tr.sampled:
                self._note_gone(trace_id, "unsampled")
                return tr  # shell: dropped, never parked in the ring
            self._completed[trace_id] = tr
            while len(self._completed) > self.max_completed:
                gone_id, _ = self._completed.popitem(last=False)
                self.evicted_total += 1
                self._note_gone(gone_id, "evicted")
            return tr

    def record_remote(
        self, trace_id: str, span_dicts: list[dict[str, Any]]
    ) -> None:
        """Worker-local registration: a finished trace built from the
        engine's own spans, for processes where no frontend owns the
        trace (the per-worker ``/debug/trace`` view)."""
        tr = Trace(trace_id=trace_id, finished=True)
        tr.merge_dicts(span_dicts)
        with self._lock:
            self._completed[trace_id] = tr
            self._completed.move_to_end(trace_id)
            while len(self._completed) > self.max_completed:
                gone_id, _ = self._completed.popitem(last=False)
                self.evicted_total += 1
                self._note_gone(gone_id, "evicted")

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            return self._completed.get(trace_id) or self._active.get(trace_id)

    def describe_missing(self, trace_id: str) -> dict[str, Any]:
        """404 body for /debug/trace/{id}: says WHY the trace is absent —
        ``evicted`` (ring overflow), ``unsampled`` (shell dropped at
        finish), or ``never_seen`` — plus enough ring state to judge
        whether raising --trace-sample-rate or the ring size would have
        kept it."""
        with self._lock:
            reason = self._gone.get(trace_id, "never_seen")
            oldest = next(iter(self._completed), None)
            return {
                "error": f"no trace for request {trace_id!r}",
                "reason": reason,
                "ring_capacity": self.max_completed,
                "retained": len(self._completed),
                "oldest_retained_id": oldest,
                "evicted_total": self.evicted_total,
            }

    def recent_ids(self, n: int = 50) -> list[str]:
        with self._lock:
            return list(self._completed)[-n:]

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._aliases.clear()
            self._completed.clear()
            self._gone.clear()
            self.evicted_total = 0


# process-wide store: the frontend, router, engine, and debug endpoints in
# one process share trace context through it (cross-process assembly rides
# the request_id + output annotations instead)
TRACES = TraceStore()
