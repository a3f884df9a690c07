"""Tail-latency forensics: SLO-breach dossiers in a bounded outlier ring
(a copy of the JAX package's telemetry/forensics.py).

The span/prof/flight planes can explain a request you *choose* to look
at; nothing caught the p99 outlier *for* you — by the time a burn-rate
gauge moves, the trace that explains it was sampled away or evicted.
This module closes that loop:

- ``ForensicsCapture.on_finish`` runs on every finishing request. The
  no-capture path is two float compares against the SLO targets plus an
  optional coin flip — always-on-cheap. On a breach (TTFT/ITL/e2e over
  target) or a ``--forensics-sample-rate`` hit it PROMOTES the trace
  (``TRACES.promote`` — shells buffer spans precisely so this late
  promotion recovers the whole path) and marks the request pending.
- ``on_trace_finished`` (called where the trace is finished) assembles
  the *dossier*: the merged span tree, the host-round segment records
  and flight-recorder / kv-stream events overlapping the request's
  lifetime, its KV path distilled from the spans (prefix-hit depth,
  G2/G3/G4 fetches, migrations, overload bounces), queue wait and
  worker id — into the bounded ``OUTLIERS`` ring served at
  ``GET /debug/outliers`` and exportable as a single-request Perfetto
  timeline (``Dossier.to_dict()`` is exactly the pre-merged bundle
  shape ``python -m dynamo_tpu_torch.tools.trace_export`` builds).
"""
from __future__ import annotations

import logging
import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry
from dynamo_tpu_torch.telemetry.trace import TRACES, Trace

log = logging.getLogger(__name__)

# (name, type, help) — metrics contract: README rows + all three scrape
# surfaces (tests/test_metrics_contract.py, dynlint DTL005)
FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_forensics_dossiers_total", "counter",
     "SLO-breach/sampled dossiers captured into the outlier ring"),
    ("dynamo_forensics_breaches_total", "counter",
     "finishing requests whose TTFT/ITL/e2e crossed the SLO target"),
    ("dynamo_forensics_sampled_total", "counter",
     "dossiers captured by the forensics-sample-rate coin flip"),
    ("dynamo_forensics_dossiers_evicted_total", "counter",
     "dossiers evicted from the bounded outlier ring"),
    ("dynamo_forensics_ring_size", "gauge",
     "dossiers currently retained in the outlier ring"),
)

FORENSICS = CounterRegistry(FAMILIES, label="forensics")

# window slop when clipping ring events to the request lifetime: ring
# timestamps are end-stamped, the trace start is frontend-stamped —
# clock skew between them must not drop boundary events
_WINDOW_SLOP_S = 0.25


def kv_path_from_spans(spans: list[dict[str, Any]]) -> dict[str, Any]:
    """Distill a request's KV journey from its (flat or nested) span
    dicts: where it routed, how deep the prefix hit was, what the KV
    tiers fetched, whether it migrated or bounced off overload."""
    path: dict[str, Any] = {
        "worker": None,
        "prefix_hit_blocks": 0,
        "route_attempts": 0,
        "migrations": [],
        "overload_bounces": 0,
        "g2_onboard_blocks": 0,
        "g4_fetch_blocks": 0,
        "disagg": False,
        "queue_wait_s": None,
    }

    def walk(sp: dict[str, Any]) -> None:
        name = sp.get("name", "")
        attrs = sp.get("attrs") or {}
        if name == "route":
            path["route_attempts"] += 1
            path["worker"] = attrs.get("worker", path["worker"])
            path["prefix_hit_blocks"] = int(
                attrs.get("overlap_blocks", 0) or 0)
        elif name == "migrate":
            path["migrations"].append({
                "from_worker": attrs.get("from_worker"),
                "replayed_tokens": attrs.get("replayed_tokens", 0),
            })
        elif name == "overload_bounce":
            path["overload_bounces"] += 1
        elif name == "g2_onboard":
            path["g2_onboard_blocks"] += int(attrs.get("blocks", 0) or 0)
        elif name == "g4_fetch":
            path["g4_fetch_blocks"] += int(attrs.get("blocks", 0) or 0)
        elif name in ("remote_prefill", "disagg_kv_transfer", "kv_chunk"):
            path["disagg"] = True
        elif name == "queue":
            path["queue_wait_s"] = round(
                float(sp.get("duration_s", 0.0)), 6)
        for child in sp.get("children") or []:
            walk(child)

    for sp in spans or []:
        walk(sp)
    return path


@dataclass
class Dossier:
    """Everything known about one slow request, joined under its
    trace_id. ``to_dict()`` is the pre-merged bundle shape
    ``dynamo_tpu_torch.tools.trace_export.build`` turns into a Perfetto
    timeline."""

    request_id: str
    reason: str                      # ttft_breach|itl_breach|e2e_breach|sampled
    captured_s: float = field(default_factory=time.time)
    worker_id: str = ""
    timing: dict[str, Any] = field(default_factory=dict)
    trace: dict[str, Any] = field(default_factory=dict)
    kv_path: dict[str, Any] = field(default_factory=dict)
    # RoundProf.recent() records [(end_unix_s, wall_s, [seg_s, ...]), ...]
    rounds: list = field(default_factory=list)
    flight: list = field(default_factory=list)
    stream: list = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "request_id": self.request_id,
            "reason": self.reason,
            "captured_s": round(self.captured_s, 6),
            "worker_id": self.worker_id,
            "timing": self.timing,
            "kv_path": self.kv_path,
            "trace": self.trace,
            "rounds": [list(r) for r in self.rounds],
            "flight": self.flight,
            "stream": self.stream,
        }

    def summary(self) -> dict[str, Any]:
        return {
            "request_id": self.request_id,
            "reason": self.reason,
            "captured_s": round(self.captured_s, 3),
            "worker_id": self.worker_id,
            "ttft_s": self.timing.get("ttft_s"),
            "e2e_s": self.timing.get("e2e_s"),
            "queue_s": self.timing.get("queue_s"),
            "spans": len(self.trace.get("spans") or []),
            "rounds": len(self.rounds),
            "flight_events": len(self.flight),
        }


class DossierRing:
    """Bounded id-addressable ring of dossiers (oldest evicted);
    thread-safe — capture runs in request handlers / the engine thread,
    the debug endpoints read from asyncio."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self._ring: OrderedDict[str, Dossier] = OrderedDict()
        self.captured_total = 0
        self.evicted_total = 0
        self._lock = threading.Lock()

    def add(self, dossier: Dossier) -> None:
        with self._lock:
            self._ring[dossier.request_id] = dossier
            self._ring.move_to_end(dossier.request_id)
            self.captured_total += 1
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
                self.evicted_total += 1
                FORENSICS.inc("dynamo_forensics_dossiers_evicted_total")
            FORENSICS.set("dynamo_forensics_ring_size", len(self._ring))
        FORENSICS.inc("dynamo_forensics_dossiers_total")

    def get(self, request_id: str) -> Optional[Dossier]:
        with self._lock:
            return self._ring.get(request_id)

    def recent(self, n: int = 0) -> list[Dossier]:
        """Newest first; ``n<=0`` returns everything retained."""
        with self._lock:
            out = list(self._ring.values())
        out.reverse()
        return out[:n] if n > 0 else out

    def oldest_id(self) -> Optional[str]:
        with self._lock:
            return next(iter(self._ring), None)

    def index(self) -> dict[str, Any]:
        """The ``GET /debug/outliers`` body."""
        with self._lock:
            dossiers = list(self._ring.values())
        dossiers.reverse()
        return {
            "capacity": self.capacity,
            "captured_total": self.captured_total,
            "evicted_total": self.evicted_total,
            "outliers": [d.summary() for d in dossiers],
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.captured_total = 0
            self.evicted_total = 0
        FORENSICS.set("dynamo_forensics_ring_size", 0)


# process-wide outlier ring: the frontend capture path, the worker-side
# engine capture path, and the /debug/outliers endpoints share it
OUTLIERS = DossierRing()


def _clip(events: list, lo: float, hi: float, key: str = "ts") -> list:
    lo, hi = lo - _WINDOW_SLOP_S, hi + _WINDOW_SLOP_S
    return [e for e in events if lo <= float(e.get(key, 0.0)) <= hi]


def _clip_rounds(records: list, lo: float, hi: float) -> list:
    lo, hi = lo - _WINDOW_SLOP_S, hi + _WINDOW_SLOP_S
    return [r for r in records if lo <= float(r[0]) <= hi]


class ForensicsCapture:
    """Per-process breach detector + dossier assembler.

    ``engines_fn`` yields in-process engine-like objects (anything with
    optional ``prof``/``flight`` attributes) whose rings are clipped to
    the request lifetime; a pure frontend has none and its dossiers
    carry the merged spans only (worker rounds ride the worker's own
    ring). SLO targets default to the live PROF targets so
    ``--slo-ttft-target`` / ``--slo-itl-target`` govern both burn rates
    and forensics."""

    def __init__(
        self,
        ring: Optional[DossierRing] = None,
        *,
        sample_rate: float = 0.0,
        ttft_target_s: Optional[float] = None,
        itl_target_s: Optional[float] = None,
        e2e_target_s: Optional[float] = None,
        engines_fn: Optional[Callable[[], list]] = None,
        traces=None,
        seed: Optional[int] = None,
    ):
        self.ring = ring if ring is not None else OUTLIERS
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self._ttft_target_s = ttft_target_s
        self._itl_target_s = itl_target_s
        self.e2e_target_s = e2e_target_s
        self.engines_fn = engines_fn
        self.traces = traces if traces is not None else TRACES
        self._rng = random.Random(seed)
        # rid -> (reason, timing dict, worker_id) awaiting trace finish
        self._pending: dict[str, tuple[str, dict[str, Any], str]] = {}
        self._lock = threading.Lock()

    @property
    def ttft_target_s(self) -> float:
        if self._ttft_target_s is not None:
            return self._ttft_target_s
        from dynamo_tpu_torch.telemetry.prof import PROF
        return PROF.ttft_target_s

    @property
    def itl_target_s(self) -> float:
        if self._itl_target_s is not None:
            return self._itl_target_s
        from dynamo_tpu_torch.telemetry.prof import PROF
        return PROF.itl_target_s

    def breach_reason(
        self,
        ttft_s: Optional[float] = None,
        itl_p95_s: Optional[float] = None,
        e2e_s: Optional[float] = None,
    ) -> Optional[str]:
        """The always-on-cheap check: a couple of float compares."""
        if ttft_s is not None and ttft_s > self.ttft_target_s:
            return "ttft_breach"
        if itl_p95_s is not None and itl_p95_s > self.itl_target_s:
            return "itl_breach"
        if (self.e2e_target_s is not None and e2e_s is not None
                and e2e_s > self.e2e_target_s):
            return "e2e_breach"
        return None

    def _decide(
        self,
        ttft_s: Optional[float],
        itl_p95_s: Optional[float],
        e2e_s: Optional[float],
    ) -> Optional[str]:
        """Breach check + sample coin flip, with counter bookkeeping."""
        reason = self.breach_reason(ttft_s, itl_p95_s, e2e_s)
        if reason is not None:
            FORENSICS.inc("dynamo_forensics_breaches_total")
        elif self.sample_rate > 0.0 and (
                self.sample_rate >= 1.0
                or self._rng.random() < self.sample_rate):
            reason = "sampled"
            FORENSICS.inc("dynamo_forensics_sampled_total")
        return reason

    def on_finish(
        self,
        request_id: str,
        *,
        ttft_s: Optional[float] = None,
        itl_p95_s: Optional[float] = None,
        e2e_s: Optional[float] = None,
        queue_s: Optional[float] = None,
        worker_id: str = "",
        timing: Optional[dict[str, Any]] = None,
    ) -> Optional[str]:
        """Breach/sample decision for a finishing request. On capture,
        promotes the trace (adopting any shell-buffered spans) and marks
        the id pending; returns the reason, else None."""
        if not request_id:
            return None
        reason = self._decide(ttft_s, itl_p95_s, e2e_s)
        if reason is None:
            return None
        self.traces.promote(request_id)
        t = dict(timing or {})
        for k, v in (("ttft_s", ttft_s), ("itl_p95_s", itl_p95_s),
                     ("e2e_s", e2e_s), ("queue_s", queue_s)):
            if v is not None and k not in t:
                t[k] = round(v, 6)
        with self._lock:
            self._pending[request_id] = (reason, t, worker_id)
        return reason

    def pending(self, request_id: str) -> bool:
        with self._lock:
            return request_id in self._pending

    def on_trace_finished(
        self, request_id: str, trace: Optional[Trace]
    ) -> Optional[Dossier]:
        """Assemble and ring-park the dossier for a pending id; call
        with TRACES.finish()'s return value."""
        with self._lock:
            entry = self._pending.pop(request_id, None)
        if entry is None:
            return None
        reason, timing, worker_id = entry
        trace_dict = trace.to_dict() if trace is not None else {
            "trace_id": request_id, "spans": [], "finished": True,
        }
        return self._assemble(
            request_id, reason, timing, worker_id, trace_dict)

    def capture_direct(
        self,
        request_id: str,
        reason: str,
        timing: dict[str, Any],
        worker_id: str,
        trace_dict: dict[str, Any],
    ) -> Dossier:
        """Worker-side path: the engine already holds the span dicts for
        a finishing request — no TraceStore round trip needed."""
        return self._assemble(request_id, reason, timing, worker_id,
                              trace_dict)

    def worker_finish(
        self,
        request_id: str,
        *,
        timing: dict[str, Any],
        worker_id: str,
        trace_spans: list,
    ) -> Optional[Dossier]:
        """One-shot worker-side finish: breach/sample decision against
        the engine's own timing annotation, then direct dossier assembly
        from its span dicts (the frontend lives in another process, so
        nothing will call on_trace_finished here)."""
        if not request_id:
            return None
        reason = self._decide(
            timing.get("ttft_s"), timing.get("itl_p95_s"),
            timing.get("e2e_s"))
        if reason is None:
            return None
        return self.capture_direct(
            request_id, reason, dict(timing), worker_id,
            {"trace_id": request_id, "finished": True,
             "spans": list(trace_spans)},
        )

    def _assemble(
        self,
        request_id: str,
        reason: str,
        timing: dict[str, Any],
        worker_id: str,
        trace_dict: dict[str, Any],
    ) -> Dossier:
        now = time.time()
        lo = float(trace_dict.get("created_s") or 0.0)
        spans = trace_dict.get("spans") or []
        if not lo:
            starts = [float(s.get("start_s", now)) for s in spans]
            lo = min(starts) if starts else now - float(
                timing.get("e2e_s") or 0.0)
        kv_path = kv_path_from_spans(spans)
        if kv_path.get("queue_wait_s") is None and "queue_s" in timing:
            kv_path["queue_wait_s"] = timing["queue_s"]
        rounds: list = []
        flight: list = []
        for eng in (self.engines_fn() if self.engines_fn else []):
            prof = getattr(eng, "prof", None)
            if prof is not None:
                try:
                    rounds.extend(_clip_rounds(prof.recent(256), lo, now))
                except Exception as e:  # noqa: BLE001 — never throws
                    log.debug("forensics: prof clip failed: %s", e)
            fl = getattr(eng, "flight", None)
            if fl is not None:
                try:
                    flight.extend(_clip(fl.snapshot(), lo, now))
                except Exception as e:  # noqa: BLE001 — never throws
                    log.debug("forensics: flight clip failed: %s", e)
        from dynamo_tpu_torch.telemetry.timeline import STREAM_EVENTS
        stream = _clip(STREAM_EVENTS.snapshot(), lo, now)
        dossier = Dossier(
            request_id=request_id,
            reason=reason,
            worker_id=worker_id or str(kv_path.get("worker") or ""),
            timing=timing,
            trace=trace_dict,
            kv_path=kv_path,
            rounds=rounds,
            flight=flight,
            stream=stream,
        )
        self.ring.add(dossier)
        return dossier
