"""Standalone metrics re-exporter: worker load plane -> Prometheus (the
port's copy of the JAX package's metrics_exporter.py, served by the port's
own HTTP server, frontend/http.py).

Parity: reference components/metrics (src/main.rs:258) — a separate
process that consumes the workers' ForwardPassMetrics stream and
re-exposes it as Prometheus gauges, so dashboards/alerting scrape one
place instead of every worker. Here the stream is the store's
``load_metrics.{worker_id}`` topics (NATS-subject parity).

Exposed (all labelled by worker):
  dynamo_worker_active_slots / total_slots / waiting_requests
  dynamo_kv_active_blocks / total_blocks / usage_perc / hit_rate
  dynamo_kv_host_blocks / host_onboard_hits
  dynamo_spec_proposed_total / accepted_total / acceptance_rate
  dynamo_spec_effective_k (mean adaptive K over speculating slots)
  dynamo_request_{ttft,itl,e2e,queue}_seconds / dynamo_engine_round_seconds
      (latency histograms shipped inside ForwardPassMetrics.histograms)
  dynamo_fleet_request_* (the same histograms MERGED across workers —
      telemetry/fleet_feed.py; exemplars preserved under OpenMetrics)
  dynamo_tenant_* (process-local tenant-sliced admission/latency
      families — dynamo_tpu_torch/tenancy/metrics.py)
Run: ``python -m dynamo_tpu_torch.cli metrics --control-plane HOST:PORT
--port 9090``. An Accept header naming ``application/openmetrics-text``
gets OpenMetrics (exemplars and ``# EOF``).
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Optional

from dynamo_tpu_torch.frontend.http import HttpServer, Request, Response
from dynamo_tpu_torch.kv_router.metrics_aggregator import MetricsAggregator
from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.publisher import METRICS_TOPIC
from dynamo_tpu_torch.telemetry.fleet_feed import FLEET_FEED
from dynamo_tpu_torch.telemetry.forensics import FORENSICS
from dynamo_tpu_torch.telemetry.metrics import render_histogram
from dynamo_tpu_torch.tenancy import TENANT

log = logging.getLogger(__name__)


class MetricsExporter:
    """Subscribe the load-metrics plane; serve Prometheus text format."""

    def __init__(
        self,
        kv: KvClient,
        *,
        host: str = "0.0.0.0",
        port: int = 9090,
        stale_after_s: float = 10.0,
    ):
        self.kv = kv
        self.host = host
        self.port = port
        self.aggregator = MetricsAggregator(stale_after_s=stale_after_s)
        self.server = HttpServer({("GET", "/metrics"): self.handle_metrics})
        self._serving = False
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> "MetricsExporter":
        sub = await self.kv.subscribe(f"{METRICS_TOPIC}.>")
        self._task = asyncio.get_running_loop().create_task(self._follow(sub))
        self.port = await self.server.start(self.host, self.port)
        self._serving = True
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._serving:
            await self.server.stop()
            self._serving = False

    async def _follow(self, sub) -> None:
        async for ev in sub:
            try:
                m = ForwardPassMetrics.from_dict(json.loads(ev["value"]))
            except (KeyError, ValueError, TypeError):
                continue
            self.aggregator.update(m)
            # fleet-merged latency feed: per-worker histogram snapshots
            # sum into the dynamo_fleet_request_* families
            FLEET_FEED.observe(m)

    def render(self, openmetrics: bool = False) -> str:
        snap = self.aggregator.snapshot()
        lines: list[str] = []

        def gauge(name: str, help_: str, values) -> None:
            """Emit one gauge family with HELP/TYPE; ``values`` is either
            a worker->value dict (labelled series) or a scalar."""
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            if isinstance(values, dict):
                for worker, v in sorted(values.items()):
                    lines.append(f'{name}{{worker="{worker}"}} {v}')
            else:
                lines.append(f"{name} {values}")

        gauge("dynamo_worker_active_slots", "requests in decode slots",
              {w: m.worker_stats.request_active_slots
               for w, m in snap.metrics.items()})
        gauge("dynamo_worker_total_slots", "decode slot capacity",
              {w: m.worker_stats.request_total_slots
               for w, m in snap.metrics.items()})
        gauge("dynamo_worker_waiting_requests", "queued requests",
              {w: m.worker_stats.num_requests_waiting
               for w, m in snap.metrics.items()})
        gauge("dynamo_worker_waiting_prefill_tokens",
              "prompt tokens waiting for prefill",
              {w: m.worker_stats.num_waiting_prefill_tokens
               for w, m in snap.metrics.items()})
        gauge("dynamo_worker_max_waiting_requests",
              "admission queue-depth budget (0 = unbounded)",
              {w: m.worker_stats.max_waiting_requests
               for w, m in snap.metrics.items()})
        gauge("dynamo_worker_max_waiting_prefill_tokens",
              "admission prefill-token budget (0 = unbounded)",
              {w: m.worker_stats.max_waiting_prefill_tokens
               for w, m in snap.metrics.items()})
        gauge("dynamo_kv_active_blocks", "KV pages in use",
              {w: m.kv_stats.kv_active_blocks
               for w, m in snap.metrics.items()})
        gauge("dynamo_kv_total_blocks", "KV page capacity",
              {w: m.kv_stats.kv_total_blocks
               for w, m in snap.metrics.items()})
        gauge("dynamo_kv_usage_perc", "KV pool usage fraction",
              {w: m.kv_stats.gpu_cache_usage_perc
               for w, m in snap.metrics.items()})
        gauge("dynamo_kv_hit_rate", "prefix cache hit rate",
              {w: m.kv_stats.gpu_prefix_cache_hit_rate
               for w, m in snap.metrics.items()})
        gauge("dynamo_kv_host_blocks", "host-tier (G2) cached pages",
              {w: m.kv_stats.host_blocks for w, m in snap.metrics.items()})
        gauge("dynamo_kv_host_onboard_hits", "G2 onboard hits",
              {w: m.kv_stats.host_onboard_hits
               for w, m in snap.metrics.items()})
        gauge("dynamo_spec_proposed_total",
              "speculative tokens proposed",
              {w: m.worker_stats.spec_proposed_total
               for w, m in snap.metrics.items()})
        gauge("dynamo_spec_accepted_total",
              "speculative tokens accepted",
              {w: m.worker_stats.spec_accepted_total
               for w, m in snap.metrics.items()})
        gauge("dynamo_spec_acceptance_rate",
              "rolling speculative acceptance rate",
              {w: m.worker_stats.spec_acceptance_rate
               for w, m in snap.metrics.items()})
        gauge("dynamo_spec_effective_k",
              "mean acceptance-adaptive effective K over speculating slots",
              {w: m.worker_stats.spec_effective_k
               for w, m in snap.metrics.items()})
        gauge("dynamo_spec_effective_k_p50",
              "median per-slot effective K over speculating slots",
              {w: m.worker_stats.spec_effective_k_p50
               for w, m in snap.metrics.items()})
        gauge("dynamo_spec_effective_k_p95",
              "p95 per-slot effective K over speculating slots",
              {w: m.worker_stats.spec_effective_k_p95
               for w, m in snap.metrics.items()})
        # latency histograms shipped inside ForwardPassMetrics: one
        # HELP/TYPE block per family, all workers' labelled series under
        # it (the Prometheus text-format grouping requirement)
        families: dict[str, dict[str, dict]] = {}
        for w, m in snap.metrics.items():
            for name, hsnap in (getattr(m, "histograms", None) or {}).items():
                families.setdefault(name, {})[w] = hsnap
        for name in sorted(families):
            per_worker = families[name]
            first = next(iter(per_worker.values()))
            help_ = first.get("help", name)
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} histogram")
            for w in sorted(per_worker):
                # render_histogram's own HELP/TYPE head is dropped: it
                # must appear once per family, not once per worker
                lines.extend(render_histogram(
                    name, help_, per_worker[w], label=f'worker="{w}"',
                    openmetrics=openmetrics,
                )[2:])
        gauge("dynamo_metrics_workers",
              "workers in the last load-plane snapshot", len(snap.metrics))
        # resilience + KV-transfer + overload planes: process-local
        # counters, same families on every scrape surface
        from dynamo_tpu_torch.kv_fleet_metrics import KV_FLEET
        from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY
        from dynamo_tpu_torch.kv_quant import KV_QUANT
        from dynamo_tpu_torch.kv_transfer_metrics import KV_TRANSFER
        from dynamo_tpu_torch.overload.metrics import OVERLOAD
        from dynamo_tpu_torch.planner_metrics import PLANNER
        from dynamo_tpu_torch.resilience.metrics import RESILIENCE
        from dynamo_tpu_torch.runtime.store_metrics import STORE
        from dynamo_tpu_torch.spec.metrics import SPEC
        from dynamo_tpu_torch.telemetry.prof import PROF

        return ("\n".join(lines) + "\n" + RESILIENCE.render()
                + KV_TRANSFER.render() + KV_QUANT.render()
                + KV_INTEGRITY.render() + OVERLOAD.render()
                + PROF.render() + STORE.render() + PLANNER.render()
                + KV_FLEET.render() + SPEC.render()
                + FLEET_FEED.render(openmetrics=openmetrics)
                + TENANT.render(openmetrics=openmetrics)
                + FORENSICS.render())

    async def handle_metrics(self, request: Request) -> Response:
        if "application/openmetrics-text" in request.headers.get(
                "Accept", ""):
            return Response(
                (self.render(openmetrics=True) + "# EOF\n").encode(),
                content_type="application/openmetrics-text; charset=utf-8")
        return Response(self.render().encode(),
                        content_type="text/plain; charset=utf-8")


async def run_exporter(args) -> None:
    """CLI entry: serve until SIGTERM (a clean exit, code 0)."""
    from dynamo_tpu_torch.launch.run import sigterm_event

    host, _, port = args.control_plane.partition(":")
    kv = await KvClient(host or "127.0.0.1", int(port or 7111)).connect()
    exp = await MetricsExporter(
        kv, host=args.host, port=args.port
    ).start()
    stop = sigterm_event()
    print(f"metrics exporter on http://{args.host}:{exp.port}/metrics",
          flush=True)
    try:
        await stop.wait()
    finally:
        await exp.stop()
        await kv.close()
