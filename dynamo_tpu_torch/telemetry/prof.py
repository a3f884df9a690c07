"""Performance-attribution plane: where the engine's host milliseconds go
(a copy of the JAX package's telemetry/prof.py).

Every host-side slice of ``TorchEngine._round`` is charged to a named
segment with a flat current-segment switch model: ``enter(seg)`` charges
the elapsed time since the previous switch to the previous segment, so
the per-round segment sums equal the measured round wall EXACTLY
(self-coverage ~1.0 by construction) and the cost per switch is one
``time.monotonic()`` call plus a float add, cheap enough to stay
always-on. The segments time the host only (dispatch to result): no
switch reads the device or synchronizes it.

Per-round records accumulate in a bounded per-engine ring
(:class:`RoundProf`) and fold into the process-global :data:`PROF`
registry at the engine's metrics-publish cadence (~10 Hz), which renders
``dynamo_host_round_seconds{segment=...}`` histograms, a coverage-ratio
gauge, and the SLO burn-rate gauges on the frontend's and the system
server's ``/metrics``. ``/debug/prof`` serves the live top-segment
summary.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np

from .metrics import Histogram, render_histogram

# the host-round segment enum — the contract shared by the engine's
# enter() calls, `dynamo_host_round_seconds{segment=...}`, the
# `host_breakdown` JSON field (python -m dynamo_tpu_torch.tools.
# profile_round --dispatch-budget), and /debug/prof. Order is the approximate order the
# segments run inside _round.
SEGMENTS = (
    "intake",         # _drain_intake: waiting-queue pulls
    "slot_scan",      # bounds enforcement + active/inflight slot scans
    "fetch",          # _process_entries: result fetch + token emission
    "annotate",       # _final_annotations: finishing-output assembly
    "releases",       # _apply_releases: freed-lane patches
    "transfer",       # _process_transfers + export-stream servicing
    "offload",        # _dispatch_offloads + _drain_host_ingest
    "admit",          # _admit: prefill dispatch + admission patches
    "seal_assembly",  # _take_seal_batch: seal-batch packing
    "dispatch",       # _dispatch_round: fused-round program launch
    "spec_dispatch",  # _dispatch_spec: draft + verify launches
    "seal_flush",     # _flush_seals: standalone overflow seal dispatch
    "metrics_fold",   # metrics build/publish + prof fold
    "other",          # unattributed remainder of the round
)
_SEG_INDEX = {s: i for i, s in enumerate(SEGMENTS)}
_N_SEG = len(SEGMENTS)
_OTHER = _SEG_INDEX["other"]

# host segments run at µs scale — DEFAULT_TIME_BUCKETS' 0.5 ms floor
# would flatten the whole distribution into one bucket. Same ~1.6x step
# ladder, shifted three decades down, topping out at 0.1 s (a host slice
# beyond that is a bug the +Inf bucket makes visible).
HOST_BUCKETS = (
    0.000002, 0.000005, 0.00001, 0.00002, 0.000035, 0.00005, 0.000075,
    0.0001, 0.0002, 0.00035, 0.0005, 0.00075,
    0.001, 0.002, 0.0035, 0.005, 0.0075,
    0.01, 0.02, 0.035, 0.05, 0.1,
)

HOST_ROUND = ("dynamo_host_round_seconds",
              "host wall time per engine round by attribution segment")
COVERAGE = ("dynamo_host_round_coverage_ratio",
            "sum of attributed segment time / measured round wall "
            "(1.0 = fully attributed)")
SLO_TTFT_BURN = ("dynamo_slo_ttft_burn_rate",
                 "TTFT SLO burn rate: fraction of requests over the "
                 "target divided by the error budget (1-objective); "
                 ">1 burns budget")
SLO_ITL_BURN = ("dynamo_slo_itl_burn_rate",
                "ITL SLO burn rate: fraction of token gaps over the "
                "target divided by the error budget (1-objective); "
                ">1 burns budget")


class RoundProf:
    """Per-engine round-segment accumulator (flat switch model).

    Single-writer (the engine thread); readers take snapshots of the
    totals under the GIL via plain dict/list copies — per-field tearing
    across a read is acceptable for a profiler. ``enabled=False`` turns
    every method into an early-out so `prof_attribution=false` engines
    pay one attribute load + branch per call site.
    """

    RING = 256  # recent per-round records kept for /debug/prof + timeline

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._acc = [0.0] * _N_SEG     # current round, per segment
        self._seg = _OTHER
        self._t = 0.0
        self._t_begin = 0.0
        self._in_round = False
        # cumulative since engine start (fold-independent, what
        # host_breakdown deltas read)
        self.total = np.zeros(_N_SEG)
        self.rounds = 0
        self.wall_total = 0.0
        # recent rounds live in PREALLOCATED numpy rings (metrics_fold
        # diet: end_round writes one row, no per-round tuple/list churn,
        # and the fold side reads whole columns vectorized). Record k
        # occupies row k % RING; _rec_n counts records ever written and
        # _fold_mark the count already drained — the unfolded window is
        # the (at most RING) rows between them.
        self._ring_ts = np.zeros(self.RING)       # end unix time
        self._ring_wall = np.zeros(self.RING)     # round wall seconds
        self._ring_acc = np.zeros((self.RING, _N_SEG))
        self._rec_n = 0
        self._fold_mark = 0

    # -- engine-thread hot path ----------------------------------------

    def begin_round(self) -> None:
        if not self.enabled:
            return
        t = time.monotonic()
        self._acc = [0.0] * _N_SEG
        self._seg = _OTHER
        self._t = t
        self._t_begin = t
        self._in_round = True

    def enter(self, seg: int) -> None:
        """Charge time since the last switch to the PREVIOUS segment and
        make ``seg`` (an index into SEGMENTS) current."""
        if not self.enabled or not self._in_round:
            return
        t = time.monotonic()
        self._acc[self._seg] += t - self._t
        self._t = t
        self._seg = seg

    def push(self, seg: int) -> int:
        """Nested attribution (e.g. annotation build inside the fetch
        segment): switch to ``seg``, return the segment to restore."""
        prev = self._seg
        self.enter(seg)
        return prev

    def end_round(self, record: bool = True) -> None:
        if not self.enabled or not self._in_round:
            return
        self.enter(_OTHER)  # close the open segment
        self._in_round = False
        if not record:
            return  # idle spin — keep µs no-op rounds out of the stats
        wall = self._t - self._t_begin
        row = self._rec_n % self.RING
        self._ring_acc[row] = self._acc
        self._ring_wall[row] = wall
        self._ring_ts[row] = time.time()
        self._rec_n += 1
        self.total += self._ring_acc[row]
        self.rounds += 1
        self.wall_total += wall

    # -- fold / read side ----------------------------------------------

    def _rows(self, n: int) -> np.ndarray:
        """Ring rows of the newest ``n`` records, oldest first."""
        return np.arange(self._rec_n - n, self._rec_n) % self.RING

    def drain_arrays(self) -> Optional[np.ndarray]:
        """Unfolded per-round segment matrix [n, N_SEG] (None if empty)
        — the vectorized-fold feed. Advances the fold mark."""
        n = min(self._rec_n - self._fold_mark, self.RING)
        self._fold_mark = self._rec_n
        if n <= 0:
            return None
        return self._ring_acc[self._rows(n)]

    def drain(self) -> list[tuple]:
        """Unfolded rounds as (end_unix_s, wall_s, (per-seg s, ...))
        tuples — the legacy wire form (tests, ad-hoc tooling); the hot
        fold path uses drain_arrays() and never builds these."""
        n = min(self._rec_n - self._fold_mark, self.RING)
        rows = self._rows(n)
        self._fold_mark = self._rec_n
        return [
            (float(self._ring_ts[r]), float(self._ring_wall[r]),
             tuple(self._ring_acc[r]))
            for r in rows
        ]

    def recent(self, n: int = 64) -> list[tuple]:
        n = min(n, self._rec_n, self.RING)
        return [
            (float(self._ring_ts[r]), float(self._ring_wall[r]),
             tuple(self._ring_acc[r]))
            for r in self._rows(n)
        ]

    def totals(self) -> dict[str, Any]:
        """Cumulative attribution since engine start (seconds)."""
        return {
            "rounds": self.rounds,
            "wall_s": self.wall_total,
            "segments": {
                s: float(self.total[i]) for i, s in enumerate(SEGMENTS)
            },
        }

    def coverage(self) -> float:
        return (float(self.total.sum()) / self.wall_total
                if self.wall_total > 0 else 1.0)

    def summary(self, top: int = 0) -> dict[str, Any]:
        """The /debug/prof payload: cumulative per-segment share plus a
        recent-window (ring) per-round mean, sorted hottest first."""
        totals = self.totals()
        wall = totals["wall_s"]
        n_recent = min(self._rec_n, self.RING)
        rows_idx = self._rows(n_recent)
        r_wall = float(self._ring_wall[rows_idx].sum())
        r_seg = self._ring_acc[rows_idx].sum(axis=0)
        rows = []
        for i, s in enumerate(SEGMENTS):
            tot = totals["segments"][s]
            rows.append({
                "segment": s,
                "total_s": round(tot, 6),
                "share": round(tot / wall, 4) if wall > 0 else 0.0,
                "recent_mean_us": round(
                    float(r_seg[i]) / n_recent * 1e6, 2
                ) if n_recent else 0.0,
            })
        rows.sort(key=lambda r: r["total_s"], reverse=True)
        if top:
            rows = rows[:top]
        return {
            "enabled": self.enabled,
            "rounds": totals["rounds"],
            "wall_s": round(wall, 6),
            "recent_rounds": n_recent,
            "recent_wall_ms_per_round": round(
                r_wall / n_recent * 1e3, 4) if n_recent else 0.0,
            "coverage_ratio": round(self.coverage(), 4),
            "segments": rows,
        }


class ProfRegistry:
    """Process-global render surface for the attribution plane: one
    ``dynamo_host_round_seconds`` histogram per segment plus the
    coverage and SLO burn-rate gauges. Appended to all three scrape
    surfaces exactly like the RESILIENCE / KV_TRANSFER registries —
    live in engine processes, zeros elsewhere."""

    def __init__(self) -> None:
        self._hists = {
            s: Histogram(HOST_ROUND[0], HOST_ROUND[1], HOST_BUCKETS)
            for s in SEGMENTS
        }
        self._lock = threading.Lock()
        self._coverage = 1.0
        self._burn = {"ttft": 0.0, "itl": 0.0}
        # SLO targets (EngineConfig/RuntimeConfig slo_* knobs); engines
        # and frontends configure() at init so scrape-time refreshes use
        # the deployed targets
        self.ttft_target_s = 0.5
        self.itl_target_s = 0.05
        self.objective = 0.99

    def configure(
        self,
        ttft_target_s: float,
        itl_target_s: float,
        objective: float,
    ) -> None:
        with self._lock:
            self.ttft_target_s = ttft_target_s
            self.itl_target_s = itl_target_s
            self.objective = objective

    def fold(self, prof: RoundProf) -> None:
        """Drain a RoundProf's unfolded rounds into the histograms —
        called from the engine thread inside the metrics_fold segment, at
        the publish cadence rather than per round. Vectorized: one
        observe_many per segment COLUMN of the drained [n, N_SEG] matrix
        instead of a Python observe per (round, segment) cell."""
        accs = prof.drain_arrays()
        if accs is not None:
            hists = self._hists
            for i, s in enumerate(SEGMENTS):
                col = accs[:, i]
                hists[s].observe_many(col[col > 0.0])
        with self._lock:
            self._coverage = prof.coverage()

    def fold_burn_rates(
        self,
        ttft_snap: Optional[dict[str, Any]],
        itl_snap: Optional[dict[str, Any]],
        ttft_target_s: Optional[float] = None,
        itl_target_s: Optional[float] = None,
        objective: Optional[float] = None,
    ) -> dict[str, float]:
        """Recompute the SLO burn-rate gauges from live TTFT/ITL
        histogram snapshots. Burn rate = (fraction of observations over
        the target) / (1 - objective): 1.0 means the error budget is
        being consumed exactly at the sustainable rate, >1 faster.
        Targets default to the configure()d ones."""
        with self._lock:
            if ttft_target_s is None:
                ttft_target_s = self.ttft_target_s
            if itl_target_s is None:
                itl_target_s = self.itl_target_s
            if objective is None:
                objective = self.objective
        budget = max(1.0 - objective, 1e-9)
        burn = {
            "ttft": frac_over_target(ttft_snap, ttft_target_s) / budget,
            "itl": frac_over_target(itl_snap, itl_target_s) / budget,
        }
        with self._lock:
            self._burn = burn
        return burn

    def burn_rates(self) -> dict[str, float]:
        with self._lock:
            return dict(self._burn)

    def coverage_ratio(self) -> float:
        with self._lock:
            return self._coverage

    def snapshot(self) -> dict[str, dict[str, Any]]:
        return {s: h.snapshot() for s, h in self._hists.items()}

    def reset(self) -> None:
        for h in self._hists.values():
            h.reset()
        with self._lock:
            self._coverage = 1.0
            self._burn = {"ttft": 0.0, "itl": 0.0}

    def render(self) -> str:
        lines: list[str] = []
        for i, s in enumerate(SEGMENTS):
            seg_lines = render_histogram(
                HOST_ROUND[0], HOST_ROUND[1],
                self._hists[s].snapshot(), label=f'segment="{s}"',
            )
            # one HELP/TYPE head for the family; later segments drop it
            lines.extend(seg_lines if i == 0 else seg_lines[2:])
        with self._lock:
            cov, burn = self._coverage, dict(self._burn)
        for (name, help_), v in (
            (COVERAGE, cov),
            (SLO_TTFT_BURN, burn["ttft"]),
            (SLO_ITL_BURN, burn["itl"]),
        ):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {round(v, 6)}")
        return "\n".join(lines) + "\n"


def frac_over_target(
    snap: Optional[dict[str, Any]], target_s: float
) -> float:
    """Fraction of a histogram snapshot's observations above ``target_s``,
    linearly interpolated inside the bucket the target falls in (the
    CDF complement of histogram_quantile's estimator). 0.0 when empty."""
    if not snap:
        return 0.0
    total = snap.get("count", 0)
    buckets = snap.get("buckets") or []
    counts = snap.get("counts") or []
    if not total or not buckets or len(counts) != len(buckets) + 1:
        return 0.0
    prev_cum = 0
    lo = 0.0
    for edge, cum in zip(buckets, counts[:-1]):
        if target_s <= edge:
            in_bucket = cum - prev_cum
            width = edge - lo
            frac = (target_s - lo) / width if width > 0 else 1.0
            cum_at = prev_cum + in_bucket * frac
            return max(0.0, min(1.0, (total - cum_at) / total))
        prev_cum = cum
        lo = edge
    # target beyond the top finite edge: only +Inf observations exceed it
    return (total - counts[-2]) / total if len(counts) >= 2 else 0.0


PROF = ProfRegistry()

__all__ = [
    "SEGMENTS",
    "HOST_BUCKETS",
    "HOST_ROUND",
    "COVERAGE",
    "SLO_TTFT_BURN",
    "SLO_ITL_BURN",
    "RoundProf",
    "ProfRegistry",
    "frac_over_target",
    "PROF",
]
