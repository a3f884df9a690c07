"""KV-transfer data-plane metrics: one process-wide registry (a copy of
the JAX package's kv_transfer_metrics.py).

Every bulk KV move (chunk-streamed disagg prefill pushes, monolithic page
writes and reads, G4 hash-addressed peer fetches) increments counters
and observes histograms here; the frontend's ``/metrics`` and each
worker's system server (runtime/system_server.py) append ``render()``'s
Prometheus text, so the series exist on both surfaces.

tx_* families count the SENDING side of a move (frames written to a
peer), rx_* the RECEIVING side (frames scattered into the local pool);
a loopback test increments both in one process.
"""
from __future__ import annotations

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

# (name, type, help): the JAX package's families and help texts
FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("dynamo_kv_transfer_tx_chunks_total", "counter",
     "KV page chunks sent to a peer (streamed frames + monolithic writes)"),
    ("dynamo_kv_transfer_rx_chunks_total", "counter",
     "KV page chunks received and scattered into the local pool"),
    ("dynamo_kv_transfer_tx_bytes_total", "counter",
     "KV payload bytes sent to peers over the transfer plane"),
    ("dynamo_kv_transfer_rx_bytes_total", "counter",
     "KV payload bytes received over the transfer plane"),
    ("dynamo_kv_transfer_streams_total", "counter",
     "multi-frame chunk streams completed (eof acknowledged)"),
    ("dynamo_kv_transfer_errors_total", "counter",
     "transfer-plane operations that failed (send or scatter side)"),
    ("dynamo_disagg_fallback_total", "counter",
     "remote-prefill attempts that fell back to local prefill"),
)

# per-chunk wire/scatter wall + whole-move wall
_HISTOGRAMS: tuple[tuple[str, str], ...] = (
    ("dynamo_kv_transfer_chunk_seconds",
     "wall time of one chunk hop (export+send on tx, scatter on rx)"),
    ("dynamo_kv_transfer_seconds",
     "wall time of one whole bulk KV move (all chunks of a stream)"),
)

# process-wide registry: the transfer client and server, the disagg
# wrapper and the G4 fetcher in one process share it
KV_TRANSFER = CounterRegistry(FAMILIES, _HISTOGRAMS, label="kv-transfer")
