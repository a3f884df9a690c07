"""Fleet-merged request-latency histograms: workers -> one distribution
(a copy of the JAX package's telemetry/fleet_feed.py).

Per-worker latency histograms travel inside
``ForwardPassMetrics.histograms`` over the store's load-metrics topics.
This module merges the per-worker cumulative snapshots into
``dynamo_fleet_request_*`` families (identical bucket ladders sum bucket
by bucket) and exposes the result both ways:

- scrape surface: ``FLEET_FEED.render()`` on the frontend's ``/metrics``
  and the per-worker system server's, exemplars preserved (the freshest
  per bucket across workers) when OpenMetrics is negotiated;
- programmatic feed: ``merged()`` cumulative snapshots, ``percentile()``,
  and ``advance()`` interval-delta snapshots, the recent window a
  consumer of the fleet's latency reads.

Fed from what sees the load plane: ``ModelWatcher``'s metrics follower
(frontend) and the system server's own engine at scrape time (a fleet of
one).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from dynamo_tpu_torch.telemetry.metrics import (
    percentile_from_snapshot,
    render_histogram,
)

# worker family -> (fleet family, help). Merging is restricted to this
# map: the request-latency series are the fleet-meaningful ones, and the
# explicit literals keep the metrics contract (README rows, DTL005)
# checkable statically.
FLEET_FAMILIES: dict[str, tuple[str, str]] = {
    "dynamo_request_ttft_seconds": (
        "dynamo_fleet_request_ttft_seconds",
        "fleet-merged time to first token (sum of worker histograms)"),
    "dynamo_request_itl_seconds": (
        "dynamo_fleet_request_itl_seconds",
        "fleet-merged inter-token latency (sum of worker histograms)"),
    "dynamo_request_e2e_seconds": (
        "dynamo_fleet_request_e2e_seconds",
        "fleet-merged end-to-end request latency (sum of worker "
        "histograms)"),
    "dynamo_request_queue_seconds": (
        "dynamo_fleet_request_queue_seconds",
        "fleet-merged admission queue wait (sum of worker histograms)"),
    "dynamo_engine_round_seconds": (
        "dynamo_fleet_engine_round_seconds",
        "fleet-merged engine round wall time (sum of worker histograms)"),
}

_WORKERS_GAUGE = (
    "dynamo_fleet_feed_workers",
    "workers contributing fresh histogram snapshots to the fleet merge")


def _merge_snaps(snaps: list[dict[str, Any]]) -> Optional[dict[str, Any]]:
    """Sum cumulative snapshots with identical bucket ladders; snapshots
    on a different ladder are skipped (a mixed-version fleet must not
    corrupt the merge). Exemplars keep the freshest entry per bucket."""
    base: Optional[dict[str, Any]] = None
    for snap in snaps:
        buckets = snap.get("buckets") or []
        counts = snap.get("counts") or []
        if not buckets or len(counts) != len(buckets) + 1:
            continue
        if base is None:
            base = {
                "buckets": list(buckets),
                "counts": list(counts),
                "sum": float(snap.get("sum", 0.0)),
                "count": int(snap.get("count", 0)),
            }
            if snap.get("exemplars"):
                base["exemplars"] = dict(snap["exemplars"])
            continue
        if list(buckets) != base["buckets"]:
            continue
        base["counts"] = [a + b for a, b in zip(base["counts"], counts)]
        base["sum"] += float(snap.get("sum", 0.0))
        base["count"] += int(snap.get("count", 0))
        for i, e in (snap.get("exemplars") or {}).items():
            cur = base.setdefault("exemplars", {}).get(i)
            if cur is None or e[2] > cur[2]:
                base["exemplars"][i] = e
    return base


def _delta_snap(
    cur: dict[str, Any], prev: Optional[dict[str, Any]]
) -> dict[str, Any]:
    """Interval delta of two cumulative snapshots. A regressed count
    (worker left the fleet / restarted) resets the baseline: the current
    cumulative snapshot is returned whole rather than a negative delta."""
    if prev is None or prev.get("buckets") != cur.get("buckets"):
        return cur
    d_count = cur["count"] - prev["count"]
    d_counts = [a - b for a, b in zip(cur["counts"], prev["counts"])]
    if d_count < 0 or any(c < 0 for c in d_counts):
        return cur
    out: dict[str, Any] = {
        "buckets": list(cur["buckets"]),
        "counts": d_counts,
        "sum": cur["sum"] - prev["sum"],
        "count": d_count,
    }
    if cur.get("exemplars"):
        out["exemplars"] = dict(cur["exemplars"])
    return out


class FleetLatencyFeed:
    """Latest per-worker histogram snapshots + the fleet-wide merge.

    Thread-safe: store-follower tasks observe while scrape handlers and
    the consumers read. ``clock`` is injectable (monotonic seconds) so a
    virtual clock can govern staleness."""

    def __init__(
        self,
        stale_after_s: float = 10.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.stale_after_s = stale_after_s
        self._clock = clock or time.monotonic
        # worker -> (observed_at, {worker family name: snapshot})
        self._per_worker: dict[str, tuple[float, dict[str, dict]]] = {}
        # advance() baseline: fleet family name -> last cumulative merge
        self._prev_merged: dict[str, dict[str, Any]] = {}
        self._lock = threading.Lock()

    def observe(self, m: Any) -> None:
        """Fold one ForwardPassMetrics-shaped update (anything with
        ``worker_id`` and ``histograms``) into the per-worker table."""
        hists = getattr(m, "histograms", None)
        if not hists:
            return
        worker = str(getattr(m, "worker_id", "") or "")
        keep = {n: s for n, s in hists.items() if n in FLEET_FAMILIES}
        if not keep:
            return
        with self._lock:
            self._per_worker[worker] = (self._clock(), keep)

    def _fresh(self) -> dict[str, dict[str, dict]]:
        now = self._clock()
        with self._lock:
            stale = [w for w, (ts, _) in self._per_worker.items()
                     if now - ts > self.stale_after_s]
            for w in stale:
                del self._per_worker[w]
            return {w: snaps for w, (_, snaps) in self._per_worker.items()}

    def workers(self) -> list[str]:
        return sorted(self._fresh())

    def merged(self) -> dict[str, dict[str, Any]]:
        """Fleet family name -> merged cumulative snapshot (with
        ``help``), summed over non-stale workers."""
        per_worker = self._fresh()
        out: dict[str, dict[str, Any]] = {}
        for worker_name, (fleet_name, help_) in FLEET_FAMILIES.items():
            snaps = [snaps[worker_name] for snaps in per_worker.values()
                     if worker_name in snaps]
            merged = _merge_snaps(snaps)
            if merged is not None:
                merged["help"] = help_
                out[fleet_name] = merged
        return out

    def percentile(self, fleet_name: str, q: float) -> Optional[float]:
        snap = self.merged().get(fleet_name)
        return percentile_from_snapshot(snap, q) if snap else None

    def advance(self) -> dict[str, dict[str, Any]]:
        """Interval-delta snapshots since the previous ``advance()`` —
        what the fleet's latency looked like over the last interval, not
        since process start."""
        cur = self.merged()
        with self._lock:
            prev, self._prev_merged = self._prev_merged, cur
        return {name: _delta_snap(snap, prev.get(name))
                for name, snap in cur.items()}

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text for the merged families + the contributing
        worker-count gauge (same families on every scrape surface)."""
        merged = self.merged()
        lines: list[str] = [
            f"# HELP {_WORKERS_GAUGE[0]} {_WORKERS_GAUGE[1]}",
            f"# TYPE {_WORKERS_GAUGE[0]} gauge",
            f"{_WORKERS_GAUGE[0]} {len(self._fresh())}",
        ]
        for name in sorted(merged):
            snap = merged[name]
            lines.extend(render_histogram(
                name, snap.get("help", name), snap,
                openmetrics=openmetrics,
            ))
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._per_worker.clear()
            self._prev_merged.clear()


# process-wide feed shared by the frontend watcher and the scrape
# surfaces (a consumer running its OWN store subscription constructs a
# private instance instead)
FLEET_FEED = FleetLatencyFeed()
