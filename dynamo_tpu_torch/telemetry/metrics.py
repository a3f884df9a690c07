"""Counters, gauges and histograms rendered in the Prometheus text format
(stands in for ``prometheus_client``; a copy of the JAX package's
telemetry/metrics.py request histograms, without exemplars).

Two kinds of series, as in the reference frontend:

- labelled families (``Counter``, ``Gauge``, ``LabeledHistogram``) in a
  ``MetricsRegistry``: the HTTP service's
  ``dynamo_http_service_{requests_total,inflight_requests,
  request_duration_seconds}``, with prometheus_client's names, labels and
  default buckets;
- the request-latency ``Histogram``s in a ``TelemetryRegistry``:
  ``dynamo_request_{ttft,itl,e2e}_seconds`` on the reference's
  per-decade ladder of buckets;
- unlabelled process-wide families in a ``CounterRegistry``: the KV
  planes' ``dynamo_kv_quant_*`` and ``dynamo_kv_integrity_*`` series
  (``kv_quant.KV_QUANT``, ``kv_integrity.KV_INTEGRITY``).

Buckets follow the Prometheus contract: ``le``-labelled CUMULATIVE
counts with a ``+Inf`` terminal bucket, plus ``_sum`` and ``_count``.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Optional

# decode steps run ~1-100 ms, TTFT ~10 ms-10 s, E2E up to minutes: a
# 1-2-3.5-5-7.5 per-decade ladder covers every request-latency series
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.002, 0.0035, 0.005, 0.0075,
    0.01, 0.02, 0.035, 0.05, 0.075,
    0.1, 0.2, 0.35, 0.5, 0.75,
    1.0, 2.0, 3.5, 5.0, 7.5,
    10.0, 20.0, 35.0, 60.0, 120.0,
)
# prometheus_client's Histogram default buckets
PROMETHEUS_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5,
                      0.75, 1.0, 2.5, 5.0, 7.5, 10.0)


def _bucket_index(buckets: tuple[float, ...], value: float) -> int:
    for j, b in enumerate(buckets):
        if value <= b:
            return j
    return len(buckets)


class Histogram:
    """One histogram series (no labels). Thread-safe: observed and
    rendered from different threads."""

    def __init__(
        self,
        name: str,
        help_: str,
        buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
    ):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value`` ``n`` times (n>1: a batch of identical
        observations, e.g. per-token gaps derived from one round)."""
        if n <= 0 or not math.isfinite(value):
            return
        i = _bucket_index(self.buckets, value)
        with self._lock:
            self._counts[i] += n
            self._sum += value * n
            self._count += n

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0

    def snapshot(self) -> dict[str, Any]:
        """Cumulative counts aligned with ``buckets`` + +Inf."""
        with self._lock:
            cum = []
            total = 0
            for c in self._counts:
                total += c
                cum.append(total)
            return {
                "buckets": list(self.buckets),
                "counts": cum,        # cumulative, last entry == count
                "sum": self._sum,
                "count": self._count,
            }

    def render(self) -> list[str]:
        return render_histogram(self.name, self.help, self.snapshot())


def render_histogram(name: str, help_: str, snap: dict[str, Any]) -> list[str]:
    """Prometheus text-format lines for one snapshot."""
    lines = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
    for edge, cum in zip(snap["buckets"], snap["counts"][:-1]):
        lines.append(f'{name}_bucket{{le="{float(edge)!r}"}} {cum}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {snap["counts"][-1]}')
    lines.append(f"{name}_sum {snap['sum']}")
    lines.append(f"{name}_count {snap['count']}")
    return lines


class TelemetryRegistry:
    """Ordered set of histograms with one render surface."""

    def __init__(self) -> None:
        self._hists: dict[str, Histogram] = {}

    def histogram(
        self,
        name: str,
        help_: str,
        buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, help_, buckets)
        return h

    def get(self, name: str) -> Optional[Histogram]:
        return self._hists.get(name)

    def render(self) -> str:
        lines: list[str] = []
        for h in self._hists.values():
            lines.extend(h.render())
        return "\n".join(lines) + ("\n" if lines else "")


# canonical request-latency series (names are the metrics contract)
TTFT = ("dynamo_request_ttft_seconds",
        "time from request receipt to first emitted token")
ITL = ("dynamo_request_itl_seconds",
       "inter-token latency (per-token gaps within one generation)")
E2E = ("dynamo_request_e2e_seconds",
       "end-to-end request latency (receipt to finish)")
# a worker's admission-queue series: the KV router's load view reads its
# median from the worker's published snapshot (overload/load.py)
QUEUE = ("dynamo_request_queue_seconds",
         "admission queue wait (enqueue to prefill start)")


def request_histograms(reg: TelemetryRegistry) -> TelemetryRegistry:
    """Install the canonical request series (TTFT, ITL, E2E) on ``reg``."""
    for name, help_ in (TTFT, ITL, E2E):
        reg.histogram(name, help_)
    return reg


# ---------------------------------------------------------------------------
# labelled families (prometheus_client's Counter, Gauge and Histogram)


def percentile_from_snapshot(
    snap: dict[str, Any], q: float
) -> Optional[float]:
    """Estimate the q-th percentile (0..1) from cumulative bucket counts
    by linear interpolation inside the target bucket (the standard
    ``histogram_quantile`` estimator). None when empty; observations in
    the +Inf bucket clamp to the top finite edge."""
    total = snap.get("count", 0)
    buckets = snap.get("buckets") or []
    counts = snap.get("counts") or []
    if not total or not buckets or len(counts) != len(buckets) + 1:
        return None
    rank = q * total
    prev_cum = 0
    lo = 0.0
    for edge, cum in zip(buckets, counts[:-1]):
        if rank <= cum:
            in_bucket = cum - prev_cum
            frac = (rank - prev_cum) / in_bucket if in_bucket else 0.0
            return lo + (edge - lo) * frac
        prev_cum = cum
        lo = edge
    return buckets[-1]


def weighted_percentile(
    pairs: list, q: float
) -> Optional[float]:
    """q-th percentile (0..1) over (value, weight) pairs — the
    per-request ITL estimator of the frontend's llm_metrics event."""
    if not pairs:
        return None
    pairs = sorted(pairs)
    total = sum(n for _, n in pairs)
    if total <= 0:
        return None
    rank = q * total
    seen = 0
    for value, n in pairs:
        seen += n
        if seen >= rank:
            return value
    return pairs[-1][0]


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels(names: tuple[str, ...], values: tuple[str, ...],
            extra: str = "") -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Family:
    kind = ""

    def __init__(self, name: str, help_: str, labelnames: tuple[str, ...],
                 registry: "MetricsRegistry"):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], Any] = {}
        self._lock = threading.Lock()
        registry.register(self)

    def labels(self, *values: str):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {values}")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            children = list(self._children.items())
        for key, child in children:
            lines.extend(self._render_child(key, child))
        return lines


class _Value:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def get(self) -> float:
        with self._lock:
            return self._v


class Counter(_Family):
    """A counter family; ``name`` ends in ``_total`` as the sample does."""

    kind = "counter"

    def _new_child(self):
        return _Value()

    def _render_child(self, key, child) -> list[str]:
        return [f"{self.name}{_labels(self.labelnames, key)} "
                f"{float(child.get())!r}"]


class Gauge(Counter):
    kind = "gauge"


class LabeledHistogram(_Family):
    kind = "histogram"

    def __init__(self, name, help_, labelnames, registry,
                 buckets: tuple[float, ...] = PROMETHEUS_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        super().__init__(name, help_, labelnames, registry)

    def _new_child(self):
        return Histogram(self.name, self.help, self.buckets)

    def _render_child(self, key, child) -> list[str]:
        snap = child.snapshot()
        out = []
        edges = [repr(float(e)) for e in snap["buckets"]] + ["+Inf"]
        for edge, cum in zip(edges, snap["counts"]):
            le = f'le="{edge}"'
            out.append(f"{self.name}_bucket"
                       f"{_labels(self.labelnames, key, le)} {float(cum)!r}")
        lab = _labels(self.labelnames, key)
        out.append(f"{self.name}_count{lab} {float(snap['count'])!r}")
        out.append(f"{self.name}_sum{lab} {float(snap['sum'])!r}")
        return out


class MetricsRegistry:
    """Labelled families rendered together, in registration order."""

    def __init__(self) -> None:
        self._families: list[_Family] = []

    def register(self, family: _Family) -> None:
        self._families.append(family)

    def render(self) -> str:
        lines: list[str] = []
        for f in self._families:
            lines.extend(f.render())
        return "\n".join(lines) + ("\n" if lines else "")


class CounterRegistry:
    """Thread-safe fixed-family counter/gauge registry with optional
    explicit-bucket histograms, rendered as one Prometheus text block (a
    copy of the JAX package's, without exemplars). Families are ``(name,
    type, help)`` tuples; histograms are ``(name, help)`` tuples on the
    default time buckets."""

    def __init__(
        self,
        families: tuple[tuple[str, str, str], ...],
        histograms: tuple[tuple[str, str], ...] = (),
        label: str = "registry",
    ):
        self._families = tuple(families)
        self._known = {name for name, _, _ in self._families}
        self._label = label
        self._values: dict[str, float] = {n: 0.0 for n in self._known}
        self._lock = threading.Lock()
        self._hists: dict[str, Histogram] = {
            name: Histogram(name, help_) for name, help_ in histograms
        }

    def _check(self, name: str) -> None:
        if name not in self._known:
            raise KeyError(f"unknown {self._label} series {name!r}")

    def inc(self, name: str, n: float = 1.0) -> None:
        self._check(name)
        with self._lock:
            self._values[name] += n

    def set(self, name: str, v: float) -> None:
        self._check(name)
        with self._lock:
            self._values[name] = float(v)

    def get(self, name: str) -> float:
        with self._lock:
            return self._values[name]

    def observe(self, name: str, value: float, n: int = 1) -> None:
        self._hists[name].observe(value, n)

    def histogram(self, name: str) -> Histogram:
        return self._hists[name]

    def reset(self) -> None:
        """Zero every series (tests)."""
        with self._lock:
            for name in self._values:
                self._values[name] = 0.0
        for h in self._hists.values():
            h.reset()

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._values)

    def render(self) -> str:
        """Prometheus text for every family (trailing newline included)."""
        snap = self.snapshot()
        lines: list[str] = []
        for name, typ, help_ in self._families:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            v = snap[name]
            lines.append(f"{name} {int(v) if v == int(v) else v}")
        for h in self._hists.values():
            lines.extend(h.render())
        return "\n".join(lines) + "\n"
