"""Tenant-sliced observability: the ``dynamo_tenant_*`` metric plane (a
copy of the JAX package's tenancy/metrics.py, without exemplars).

Every other subsystem plane is a fixed family set (CounterRegistry);
tenants are an open set discovered at admission time, so this registry
keys each family's series by tenant id and renders them as
``{tenant="..."}``-labelled Prometheus series under ONE HELP/TYPE head
per family (the text-format grouping requirement). Rendered on
the frontend's ``/metrics`` and the per-worker system server's, and
snapshot into ``/debug/tenants`` on both.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

from dynamo_tpu_torch.telemetry.metrics import Histogram, render_histogram

# (name, type, help): the JAX package's names and help text
FAMILIES = (
    ("dynamo_tenant_admitted_total", "counter",
     "requests admitted past the tenant quota gate, per tenant"),
    ("dynamo_tenant_rejected_total", "counter",
     "requests refused by a tenant's own quota (per-tenant 429s)"),
    ("dynamo_tenant_shed_total", "counter",
     "waiting requests shed under tenant-confined pressure, per tenant"),
    ("dynamo_tenant_http_429_total", "counter",
     "frontend 429 responses attributed to a tenant's quota state"),
    ("dynamo_tenant_queue_depth", "gauge",
     "requests waiting in the admission queue, per tenant"),
    ("dynamo_tenant_queue_tokens", "gauge",
     "prompt tokens waiting for prefill, per tenant"),
    ("dynamo_tenant_adapter_rounds_total", "counter",
     "decode rounds that gathered a non-base resident LoRA adapter "
     "for at least one of the tenant's slots"),
)

HISTOGRAMS = (
    ("dynamo_tenant_request_ttft_seconds",
     "time to first token, sliced by tenant"),
    ("dynamo_tenant_request_queue_seconds",
     "admission queue wait, sliced by tenant"),
)


def _safe_tenant(tenant: str) -> str:
    """Label-safe tenant id: the quote/backslash/newline characters that
    would corrupt the Prometheus text format are stripped, length capped
    (the mint path sanitizes too — this is the render-side backstop)."""
    t = "".join(ch for ch in str(tenant) if ch not in '"\\\n\r')
    return (t or "default")[:64]


class TenantRegistry:
    """Thread-safe per-tenant counters/gauges + histograms.

    API mirrors CounterRegistry but every mutator takes the tenant id;
    render() emits one HELP/TYPE head per family with one
    ``{tenant="..."}`` series per tenant seen so far."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # family -> tenant -> value
        self._values: dict[str, dict[str, float]] = {
            name: {} for name, _, _ in FAMILIES
        }
        # family -> tenant -> Histogram
        self._hists: dict[str, dict[str, Histogram]] = {
            name: {} for name, _ in HISTOGRAMS
        }
        self._hist_help = dict(HISTOGRAMS)

    def inc(self, name: str, tenant: str, n: float = 1.0) -> None:
        assert name in self._values, f"unknown tenant series {name!r}"
        t = _safe_tenant(tenant)
        with self._lock:
            self._values[name][t] = self._values[name].get(t, 0.0) + n

    def set(self, name: str, tenant: str, v: float) -> None:
        assert name in self._values, f"unknown tenant series {name!r}"
        t = _safe_tenant(tenant)
        with self._lock:
            self._values[name][t] = float(v)

    def get(self, name: str, tenant: str) -> float:
        with self._lock:
            return self._values[name].get(_safe_tenant(tenant), 0.0)

    def observe(self, name: str, tenant: str, value: float) -> None:
        self.histogram(name, tenant).observe(value)

    def histogram(self, name: str, tenant: str) -> Histogram:
        assert name in self._hists, f"unknown tenant histogram {name!r}"
        t = _safe_tenant(tenant)
        with self._lock:
            h = self._hists[name].get(t)
            if h is None:
                h = self._hists[name][t] = Histogram(
                    name, self._hist_help[name]
                )
            return h

    def percentile(self, name: str, tenant: str, q: float) -> Optional[float]:
        with self._lock:
            h = self._hists[name].get(_safe_tenant(tenant))
        return h.percentile(q) if h is not None else None

    def tenants(self) -> list[str]:
        with self._lock:
            seen: set[str] = set()
            for per in self._values.values():
                seen.update(per)
            for per in self._hists.values():
                seen.update(per)
            return sorted(seen)

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """tenant -> {family: value, histogram: {p50, p99, count}} — the
        /debug/tenants wire form."""
        out: dict[str, dict[str, Any]] = {}
        with self._lock:
            families = {n: dict(per) for n, per in self._values.items()}
            hists = {n: dict(per) for n, per in self._hists.items()}
        for name, per in families.items():
            for t, v in per.items():
                out.setdefault(t, {})[name] = v
        for name, per in hists.items():
            for t, h in per.items():
                out.setdefault(t, {})[name] = {
                    "count": h.count,
                    "p50_s": h.percentile(0.5),
                    "p99_s": h.percentile(0.99),
                }
        return out

    def reset(self) -> None:
        with self._lock:
            for per in self._values.values():
                per.clear()
            for per in self._hists.values():
                per.clear()

    def render(self) -> str:
        """One HELP/TYPE head per family; tenant-labelled series under
        it. Families with no tenants yet still emit their heads so the
        scrape contract is visible from the first scrape."""
        with self._lock:
            values = {n: dict(per) for n, per in self._values.items()}
            hists = {n: dict(per) for n, per in self._hists.items()}
        lines: list[str] = []
        for name, typ, help_ in FAMILIES:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            for t in sorted(values[name]):
                v = values[name][t]
                lines.append(
                    f'{name}{{tenant="{t}"}} '
                    f"{int(v) if v == int(v) else v}"
                )
        for name, help_ in HISTOGRAMS:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} histogram")
            for t in sorted(hists[name]):
                # per-family head emitted once above; per-tenant series
                # drop render_histogram's own HELP/TYPE lines
                lines.extend(render_histogram(
                    name, help_, hists[name][t].snapshot(),
                    label=f'tenant="{t}"',
                )[2:])
        return "\n".join(lines) + "\n"


TENANT = TenantRegistry()
