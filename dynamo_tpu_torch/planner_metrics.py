"""Autoscaling-plane observability: one registry, three surfaces (the
port's copy of the JAX package's planner_metrics.py).

The planner's observe->decide->scale loop increments counters here; the
frontend ``/metrics``, the per-worker system server and the aggregating
exporter all append ``render()``'s Prometheus text (zero-valued in
processes that run no planner), so a scaling storm — or a planner that
silently stopped deciding — is visible on every scrape surface.
"""
from __future__ import annotations

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

# (name, type, help) — naming contract as in runtime/store_metrics.py:
# counters `*_total`, gauges plain names.
FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_planner_replicas", "gauge",
     "replica target of the planner's most recent decision"),
    ("dynamo_planner_decisions_total", "counter",
     "planner adjustment decisions taken (one per interval)"),
    ("dynamo_planner_scale_ups_total", "counter",
     "decisions that raised the replica target"),
    ("dynamo_planner_scale_downs_total", "counter",
     "decisions that lowered the replica target"),
    ("dynamo_planner_predicted_load", "gauge",
     "predictor forecast for the next interval (concurrent streams in "
     "predictive/SLA mode, mean KV usage in load mode)"),
    ("dynamo_planner_fleet_ttft_p99_seconds", "gauge",
     "p99 TTFT over the last decide interval from the fleet-merged "
     "latency feed (0 until the feed has data)"),
    ("dynamo_planner_fleet_queue_p99_seconds", "gauge",
     "p99 admission queue wait over the last decide interval from the "
     "fleet-merged latency feed (0 until the feed has data)"),
)

# process-wide registry shared by every planner in the process (parity
# with store_metrics.STORE)
PLANNER = CounterRegistry(FAMILIES, label="planner")
