"""Request-lifecycle telemetry of the port (a copy of the JAX package's
telemetry/): trace spans, latency histograms, the per-worker flight
recorder, the performance-attribution plane, timelines, SLO-breach
forensics and the fleet latency feed.

  trace.py      trace context minted at the frontend, spans recorded at
                every pipeline stage, worker spans returned in-band via
                output annotations and merged into one tree served at
                ``/debug/trace/{request_id}``
  metrics.py    explicit-bucket Prometheus histograms (TTFT / ITL / E2E /
                queue wait / engine round) with exemplars, rendered by the
                frontend and the per-worker system server
  flight.py     fixed-size ring of recent engine dispatches served at
                ``/debug/flight`` and dumped to the log on engine failure
  prof.py       per-round host-segment attribution (where the host
                milliseconds go): ``dynamo_host_round_seconds{segment}``
                histograms, the SLO burn-rate gauges, ``/debug/prof``
  timeline.py   Perfetto/Chrome-trace assembly merging spans, round
                segments, flight events, and kv-transfer stream events
                (``python -m dynamo_tpu_torch.tools.trace_export``)
  forensics.py  SLO-breach dossiers in the ``/debug/outliers`` ring
  fleet_feed.py worker latency histograms merged into fleet families
"""
from dynamo_tpu_torch.telemetry.fleet_feed import FLEET_FEED, FleetLatencyFeed
from dynamo_tpu_torch.telemetry.flight import FlightRecorder
from dynamo_tpu_torch.telemetry.forensics import (
    FORENSICS,
    OUTLIERS,
    Dossier,
    DossierRing,
    ForensicsCapture,
    kv_path_from_spans,
)
from dynamo_tpu_torch.telemetry.metrics import (
    DEFAULT_TIME_BUCKETS,
    Histogram,
    TelemetryRegistry,
    percentile_from_snapshot,
    request_histograms,
)
from dynamo_tpu_torch.telemetry.prof import (
    HOST_BUCKETS,
    PROF,
    SEGMENTS,
    ProfRegistry,
    RoundProf,
)
from dynamo_tpu_torch.telemetry.timeline import (
    STREAM_EVENTS,
    StreamEventRing,
    to_chrome_trace,
    trace_to_chrome,
)
from dynamo_tpu_torch.telemetry.trace import TRACES, Span, Trace, TraceStore

__all__ = [
    "DEFAULT_TIME_BUCKETS",
    "Dossier",
    "DossierRing",
    "FLEET_FEED",
    "FleetLatencyFeed",
    "FlightRecorder",
    "FORENSICS",
    "ForensicsCapture",
    "kv_path_from_spans",
    "OUTLIERS",
    "Histogram",
    "HOST_BUCKETS",
    "PROF",
    "ProfRegistry",
    "RoundProf",
    "SEGMENTS",
    "Span",
    "STREAM_EVENTS",
    "StreamEventRing",
    "TelemetryRegistry",
    "Trace",
    "TraceStore",
    "TRACES",
    "percentile_from_snapshot",
    "request_histograms",
    "to_chrome_trace",
    "trace_to_chrome",
]
