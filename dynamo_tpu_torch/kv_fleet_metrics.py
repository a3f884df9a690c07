"""Fleet prefix-economy metrics: one process-wide registry (a copy of the
JAX package's kv_fleet_metrics.py).

Dedup-by-hash admission (the engine consults the fleet hints before a G4
probe round), the frontend's replication controller
(kv_router/prefetch.py) and replication-aware tier eviction
(engine/offload.py) all count here. The frontend's ``/metrics`` and each
worker's system server (runtime/system_server.py) append ``render()``'s
Prometheus text, so the series exist on both surfaces. The aggregating
exporter that adds a third surface in the reference comes with ROADMAP
Queue 1 item 14.
"""
from __future__ import annotations

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

# (name, type, help): the JAX package's families and help texts
FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_kv_fleet_recompute_avoided_blocks_total", "counter",
     "prefix blocks pulled from a peer by hash instead of recomputed"),
    ("dynamo_kv_fleet_dedup_skipped_probes_total", "counter",
     "G4 fetch rounds skipped because fleet hints showed no peer holder"),
    ("dynamo_kv_fleet_prefetched_blocks_total", "counter",
     "blocks pushed into a worker host tier by the replication controller"),
    ("dynamo_kv_fleet_prefetch_rounds_total", "counter",
     "replication-controller passes that examined the fleet hot set"),
    ("dynamo_kv_fleet_warm_starts_total", "counter",
     "cold workers warm-started from the fleet top-K hot prefixes"),
    ("dynamo_kv_fleet_hint_pushes_total", "counter",
     "fleet replica/holder hint digests delivered to workers"),
    ("dynamo_kv_fleet_replicated_evictions_total", "counter",
     "tier evictions that chose a fleet-replicated block over unique ones"),
    ("dynamo_kv_fleet_last_copy_evictions_total", "counter",
     "tier evictions forced to drop the last known fleet copy of a block"),
)

# process-wide: the frontend controller and the worker-side admission and
# eviction hooks in one process share it
KV_FLEET = CounterRegistry(FAMILIES, label="kv-fleet")
