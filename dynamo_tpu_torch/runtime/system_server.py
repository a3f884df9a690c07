"""Per-process system HTTP server: /metrics, /health and the resilience
controls on every worker (a copy of the JAX package's
runtime/system_server.py, served by the port's own HTTP server,
frontend/http.py; reference lib/runtime/src/http_server.rs:27-45,91).

Each worker exposes its own Prometheus endpoint (uptime, the engine's
ForwardPassMetrics gauges and latency histograms, and this process's
counter registries), so operators scrape workers directly, apart from the
frontend's metrics:

  GET /metrics                plain text, or OpenMetrics (exemplars and
                              ``# EOF``) when the scraper's Accept asks
                              for it
  GET /health, GET /live      liveness
  GET/POST /drain             graceful drain state / trigger (stop
                              admitting, finish in-flight, exit)
  GET/POST/DELETE /chaos      list / arm / disarm fault-injection points
                              (``python -m dynamo_tpu_torch.tools.chaos``)
  GET /debug/kv_fleet         this worker's fleet hints (the last digest
                              the frontend's controller applied)
  GET /debug/tenants          this worker's tenancy plane: the engine's
                              per-tenant quota and queue view and this
                              process's tenant metric snapshot
  GET /debug/flight           recent engine dispatches (the flight ring)
  GET /debug/prof[?top=N]     host-round attribution (per-segment totals
                              and shares, coverage, SLO burn rates)
  GET /debug/trace            recent completed trace ids
  GET /debug/trace/{id}       this worker's span tree for a request
  GET /debug/outliers         this worker's SLO-breach dossier ring
  GET /debug/outliers/{id}[?format=perfetto]
                              one dossier, as JSON or a Perfetto timeline
"""
from __future__ import annotations

import logging
import time
from typing import Any

from dynamo_tpu_torch.frontend.http import HttpServer, Request, Response
from dynamo_tpu_torch.kv_fleet_metrics import KV_FLEET
from dynamo_tpu_torch.spec.metrics import SPEC
from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY
from dynamo_tpu_torch.kv_quant import KV_QUANT
from dynamo_tpu_torch.kv_transfer_metrics import KV_TRANSFER
from dynamo_tpu_torch.overload.metrics import OVERLOAD
from dynamo_tpu_torch.planner_metrics import PLANNER
from dynamo_tpu_torch.resilience.chaos import CHAOS
from dynamo_tpu_torch.resilience.metrics import RESILIENCE
from dynamo_tpu_torch.runtime.store_metrics import STORE
from dynamo_tpu_torch.telemetry.fleet_feed import FLEET_FEED
from dynamo_tpu_torch.telemetry.forensics import FORENSICS, OUTLIERS
from dynamo_tpu_torch.telemetry.metrics import render_histogram
from dynamo_tpu_torch.telemetry.prof import PROF
from dynamo_tpu_torch.telemetry.timeline import to_chrome_trace
from dynamo_tpu_torch.telemetry.trace import TRACES
from dynamo_tpu_torch.tenancy.metrics import TENANT

log = logging.getLogger(__name__)

# the reference's answers (aiohttp's text responses name their charset)
PROMETHEUS_CONTENT_TYPE = "text/plain; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text"
OPENMETRICS_RESPONSE_TYPE = f"{OPENMETRICS_CONTENT_TYPE}; charset=utf-8"


class SystemServer:
    """Tiny per-process observability and control server. ``engine`` is
    optional: when it exposes ``metrics()`` (ForwardPassMetrics), those
    gauges are rendered beside uptime. ``drain`` is an optional
    DrainController enabling /drain. ``start()`` binds ``port`` (0: a
    free one, set on ``self.port``)."""

    def __init__(
        self,
        engine: Any = None,
        *,
        host: str = "0.0.0.0",
        port: int = 0,
        worker_id: str = "",
        drain: Any = None,
    ):
        self.engine = engine
        self.host = host
        self.port = port
        self.worker_id = worker_id
        self.drain = drain
        self._started = time.monotonic()
        routes = {
            ("GET", "/metrics"): self.handle_metrics,
            ("GET", "/health"): self.handle_health,
            ("GET", "/live"): self.handle_health,
            ("GET", "/drain"): self.handle_drain_status,
            ("POST", "/drain"): self.handle_drain,
            ("GET", "/chaos"): self.handle_chaos_list,
            ("POST", "/chaos"): self.handle_chaos_arm,
            ("DELETE", "/chaos"): self.handle_chaos_disarm,
            ("GET", "/debug/kv_fleet"): self.handle_kv_fleet,
            ("GET", "/debug/tenants"): self.handle_tenants,
            ("GET", "/debug/flight"): self.handle_flight,
            ("GET", "/debug/prof"): self.handle_prof,
            ("GET", "/debug/trace"): self.handle_trace_index,
            ("GET", "/debug/trace/{request_id}"): self.handle_trace,
            ("GET", "/debug/outliers"): self.handle_outliers,
            ("GET", "/debug/outliers/{request_id}"): self.handle_outlier,
        }
        self.server = HttpServer(routes)

    async def start(self) -> "SystemServer":
        self.port = await self.server.start(self.host, self.port)
        log.info("system server on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        await self.server.stop()

    def render(self, openmetrics: bool = False) -> str:
        lines = [
            "# HELP dynamo_system_uptime_seconds process uptime",
            "# TYPE dynamo_system_uptime_seconds gauge",
            f"dynamo_system_uptime_seconds "
            f"{time.monotonic() - self._started:.3f}",
        ]
        metrics_fn = getattr(self.engine, "metrics", None)
        m = None
        if metrics_fn is not None:
            try:
                m = metrics_fn()
            except Exception:  # noqa: BLE001 — observability must not throw
                log.exception("engine metrics failed")
        if m is not None:
            # this worker's histograms feed the (fleet-of-one) merge, so
            # the dynamo_fleet_* families render here too
            FLEET_FEED.observe(m)
            w = self.worker_id or m.worker_id

            def g(name: str, help_: str, v) -> None:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} gauge")
                lines.append(f'{name}{{worker="{w}"}} {v}')

            ws, ks = m.worker_stats, m.kv_stats
            g("dynamo_worker_active_slots", "requests in decode slots",
              ws.request_active_slots)
            g("dynamo_worker_total_slots", "decode slot capacity",
              ws.request_total_slots)
            g("dynamo_worker_waiting_requests", "queued requests",
              ws.num_requests_waiting)
            g("dynamo_worker_waiting_prefill_tokens",
              "prompt tokens waiting for prefill",
              ws.num_waiting_prefill_tokens)
            g("dynamo_worker_max_waiting_requests",
              "admission queue-depth budget (0 = unbounded)",
              ws.max_waiting_requests)
            g("dynamo_worker_max_waiting_prefill_tokens",
              "admission prefill-token budget (0 = unbounded)",
              ws.max_waiting_prefill_tokens)
            g("dynamo_kv_active_blocks", "KV pages in use",
              ks.kv_active_blocks)
            g("dynamo_kv_total_blocks", "KV page capacity",
              ks.kv_total_blocks)
            g("dynamo_kv_usage_perc", "KV pool usage fraction",
              ks.gpu_cache_usage_perc)
            g("dynamo_kv_hit_rate", "prefix cache hit rate",
              ks.gpu_prefix_cache_hit_rate)
            g("dynamo_kv_host_blocks", "host-tier (G2) cached pages",
              ks.host_blocks)
            g("dynamo_spec_proposed_total",
              "speculative tokens proposed", ws.spec_proposed_total)
            g("dynamo_spec_accepted_total",
              "speculative tokens accepted", ws.spec_accepted_total)
            g("dynamo_spec_acceptance_rate",
              "rolling speculative acceptance rate",
              ws.spec_acceptance_rate)
            g("dynamo_spec_effective_k",
              "mean acceptance-adaptive effective K over speculating "
              "slots", ws.spec_effective_k)
            g("dynamo_spec_effective_k_p50",
              "median per-slot effective K over speculating slots",
              ws.spec_effective_k_p50)
            g("dynamo_spec_effective_k_p95",
              "p95 per-slot effective K over speculating slots",
              ws.spec_effective_k_p95)
            for name, snap in sorted((m.histograms or {}).items()):
                lines.extend(render_histogram(
                    name, snap.get("help", name), snap,
                    label=f'worker="{w}"', openmetrics=openmetrics))
        # the counters of THIS process's planes
        return ("\n".join(lines) + "\n" + RESILIENCE.render()
                + KV_TRANSFER.render() + KV_QUANT.render()
                + KV_INTEGRITY.render() + OVERLOAD.render()
                + PROF.render() + TENANT.render() + STORE.render()
                + PLANNER.render() + KV_FLEET.render() + SPEC.render()
                + FLEET_FEED.render(openmetrics=openmetrics)
                + FORENSICS.render())

    async def handle_metrics(self, request: Request) -> Response:
        if OPENMETRICS_CONTENT_TYPE in request.headers.get("Accept", ""):
            return Response(
                (self.render(openmetrics=True) + "# EOF\n").encode(),
                content_type=OPENMETRICS_RESPONSE_TYPE)
        return Response(self.render().encode(),
                        content_type=PROMETHEUS_CONTENT_TYPE)

    async def handle_health(self, request: Request) -> Response:
        return Response.json({
            "status": "ok",
            "uptime_s": round(time.monotonic() - self._started, 3),
            "worker_id": self.worker_id,
        })

    async def handle_flight(self, request: Request) -> Response:
        flight = getattr(self.engine, "flight", None)
        if flight is None:
            return Response.json(
                {"error": "engine exposes no flight recorder"}, status=404)
        return Response.json({
            "worker_id": self.worker_id,
            "recorded_total": flight.recorded_total,
            "events": flight.snapshot(),
        })

    async def handle_prof(self, request: Request) -> Response:
        """GET /debug/prof[?top=N]: host-round attribution, per-segment
        totals and shares, recent-window means a round, the coverage
        ratio, and the live SLO burn rates."""
        prof = getattr(self.engine, "prof", None)
        if prof is None:
            return Response.json(
                {"error": "engine exposes no round profiler"}, status=404)
        try:
            top = int(request.query.get("top", 0))
        except ValueError:
            top = 0
        body = prof.summary(top=top)
        body["worker_id"] = self.worker_id
        body["slo_burn_rates"] = PROF.burn_rates()
        return Response.json(body)

    async def handle_trace_index(self, request: Request) -> Response:
        return Response.json({"recent": TRACES.recent_ids()})

    async def handle_trace(self, request: Request) -> Response:
        rid = request.match_info["request_id"]
        tr = TRACES.get(rid)
        if tr is None:
            # the body says WHY: evicted, unsampled or never seen
            return Response.json(TRACES.describe_missing(rid), status=404)
        return Response.json(tr.to_dict())

    async def handle_outliers(self, request: Request) -> Response:
        """GET /debug/outliers: this worker's dossier ring (captures for
        requests whose frontend runs in another process)."""
        body = OUTLIERS.index()
        body["worker_id"] = self.worker_id
        return Response.json(body)

    async def handle_outlier(self, request: Request) -> Response:
        """GET /debug/outliers/{request_id}[?format=perfetto]: one dossier
        from this worker's ring."""
        rid = request.match_info["request_id"]
        d = OUTLIERS.get(rid)
        if d is None:
            return Response.json({
                "error": f"no dossier for request {rid!r}",
                "worker_id": self.worker_id,
                "capacity": OUTLIERS.capacity,
                "captured_total": OUTLIERS.captured_total,
                "evicted_total": OUTLIERS.evicted_total,
                "oldest_retained_id": OUTLIERS.oldest_id(),
            }, status=404)
        if request.query.get("format") == "perfetto":
            return Response.json(to_chrome_trace(
                spans=list(d.trace.get("spans") or []),
                round_records=d.rounds, flight_events=d.flight,
                stream_events=d.stream, label=rid))
        return Response.json(d.to_dict())

    async def handle_kv_fleet(self, request: Request) -> Response:
        """GET /debug/kv_fleet: this WORKER's view of the fleet prefix
        economy, the last hint digest the frontend's controller applied
        (the frontend's own /debug/kv_fleet serves the whole fleet map)."""
        hints = getattr(self.engine, "fleet_hints", None)
        return Response.json({
            "worker_id": self.worker_id,
            "hints": None if hints is None else hints.to_dict()})

    async def handle_tenants(self, request: Request) -> Response:
        """GET /debug/tenants: this WORKER's tenancy plane, the engine's
        per-tenant quota and queue view plus the process-local tenant
        metric snapshot (the frontend serves its own)."""
        body: dict = {"worker_id": self.worker_id,
                      "tenants": TENANT.snapshot()}
        dbg = getattr(self.engine, "tenant_debug", None)
        if dbg is not None:
            try:
                body["engine"] = dbg()
            except Exception:  # noqa: BLE001 — debug surface never throws
                log.exception("tenant debug failed")
        return Response.json(body)

    # ---- resilience controls ----

    async def handle_drain_status(self, request: Request) -> Response:
        if self.drain is None:
            return Response.json({"error": "no drain controller wired"},
                                 status=404)
        return Response.json(self.drain.status())

    async def handle_drain(self, request: Request) -> Response:
        """POST /drain: stop admitting, finish in-flight, then exit."""
        if self.drain is None:
            return Response.json({"error": "no drain controller wired"},
                                 status=404)
        self.drain.request_drain(reason="http /drain")
        return Response.json(self.drain.status())

    async def handle_chaos_list(self, request: Request) -> Response:
        return Response.json({
            "worker_id": self.worker_id,
            "points": CHAOS.list_points(),
        })

    async def handle_chaos_arm(self, request: Request) -> Response:
        """POST /chaos {"point": name, "probability": p, "delay_s": t,
        "after_outputs": n, "once": bool}: arm one injection point."""
        try:
            body = request.json()
            name = body.get("point")
        except (ValueError, AttributeError):
            return Response.json({"error": "invalid JSON"}, status=400)
        if name not in CHAOS.points:
            return Response.json(
                {"error": f"unknown chaos point {name!r}"}, status=400)
        try:
            p = CHAOS.arm(
                name,
                probability=float(body.get("probability", 1.0)),
                delay_s=float(body.get("delay_s", 0.0)),
                after_outputs=int(body.get("after_outputs", 0)),
                once=bool(body.get("once", False)),
            )
        except (TypeError, ValueError) as e:
            return Response.json(
                {"error": f"invalid chaos parameters: {e}"}, status=400)
        return Response.json(p.to_dict())

    async def handle_chaos_disarm(self, request: Request) -> Response:
        """DELETE /chaos[?point=name]: disarm one point or all."""
        name = request.query.get("point")
        if name:
            if name not in CHAOS.points:
                return Response.json(
                    {"error": f"unknown chaos point {name!r}"}, status=400)
            CHAOS.disarm(name)
        else:
            CHAOS.disarm_all()
        return Response.json({"points": CHAOS.list_points()})
