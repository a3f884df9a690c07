"""Control-plane survivability counters (a copy of the JAX package's
runtime/store_metrics.py, on the port's CounterRegistry, with the same
family names).

The store WAL replay path and the ``StoreSession`` resync machinery
increment counters here; the frontend ``/metrics``, the per-worker
system server and the aggregating exporter all append ``render()``'s
Prometheus text, so a store bounce is visible on every scrape surface
(zero-valued where the event class can't occur in that process). The
``dynamo_store_degraded`` gauge is the operator's first-look signal:
1 while this process serves from last-known control-plane state.
"""
from __future__ import annotations

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

# (name, type, help) — the fixed family set (naming contract as in
# resilience/metrics.py: counters `*_total`, gauges plain names).
FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_store_reconnects_total", "counter",
     "control-plane connections re-established by a StoreSession after loss"),
    ("dynamo_store_resyncs_total", "counter",
     "session resyncs completed (leases re-granted, registrations re-put, "
     "watches re-established with synthesized deltas)"),
    ("dynamo_store_replayed_keys_total", "counter",
     "keys restored from the store WAL journal at startup"),
    ("dynamo_store_replayed_queue_items_total", "counter",
     "durable queue items restored from the store WAL journal at startup"),
    ("dynamo_store_degraded", "gauge",
     "1 while this process serves from last-known control-plane state "
     "(store unreachable, stale-while-revalidate)"),
    ("dynamo_store_wal_batched_syncs_total", "counter",
     "coalesced WAL flush+fsync drains in --store-fsync batch mode (each "
     "covers every mutation landed in one event-loop drain)"),
)

# process-wide registry: the store server, sessions and watchers in one
# process share it (parity with resilience.RESILIENCE)
STORE = CounterRegistry(FAMILIES, label="store")
