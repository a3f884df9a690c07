"""Overload-protection counters (a copy of the JAX package's
overload/metrics.py, cut to the KV router's spill counter; admission
rejections, sheds, preemptions and 429s bring theirs with ROADMAP Queue 1
item 8). The frontend's ``/metrics`` appends ``render()``'s Prometheus
text."""
from __future__ import annotations

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

# (name, type, help) — the JAX package's family name and help text
FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_overload_router_spills_total", "counter",
     "requests bounced off an overloaded worker and re-routed to a peer"),
)

# process-wide registry: routers in one process share it
OVERLOAD = CounterRegistry(FAMILIES, label="overload")
