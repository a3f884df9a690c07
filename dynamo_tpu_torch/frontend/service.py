"""OpenAI HTTP service (a copy of the JAX package's frontend/service.py on
the port's standard-library HTTP server; reference lib/llm/src/http/
service: service_v2.rs:50 HttpService, openai.rs:133,287 handlers,
metrics.rs:104).

Endpoints:
  POST /v1/chat/completions   (streamed SSE or aggregated JSON)
  POST /v1/completions
  POST /v1/embeddings         (any engine with ``embed``; not counted in
                               the requests_total family, as in the
                               reference)
  POST /v1/responses          (the Responses API lowered onto the chat
                               pipeline; typed SSE events when streamed)
  GET  /v1/models
  GET  /health, /live
  GET  /metrics               (Prometheus text, or OpenMetrics with
                               exemplars and ``# EOF`` when the scraper's
                               Accept asks for
                               application/openmetrics-text; with the KV
                               planes' dynamo_kv_transfer_*,
                               dynamo_disagg_*, dynamo_kv_quant_* and
                               dynamo_kv_integrity_* families, the store's
                               dynamo_store_*, and the KV router's
                               dynamo_resilience_* and dynamo_migration_*,
                               the overload plane's dynamo_overload_*, the
                               attribution plane's dynamo_host_round_*
                               and dynamo_slo_*, the tenancy plane's
                               dynamo_tenant_*, the fleet's
                               dynamo_kv_fleet_* and dynamo_fleet_*, the
                               speculation's dynamo_spec_* and the
                               forensics' dynamo_forensics_*)
  POST /clear_kv_blocks       (every served engine's clear_kv_blocks:
                               {"cleared": [model, ...]}; a KV-routed
                               model's router fans it out to its workers
                               and empties its indexer)
  GET  /debug/kv_fleet[?model=NAME][&top=K]
                              (each KV-routed model's fleet view:
                               replica map and top-K hot prefixes)
  GET  /debug/tenants         (the frontend's tenant metric slice and
                               every local engine's quota and queue view)
  GET  /debug/trace           (recent completed trace ids)
  GET  /debug/trace/{id}      (one request's merged span tree; a 404 body
                               says why it is absent: never_seen, evicted
                               or unsampled)
  GET  /debug/flight          (every local engine's flight ring)
  GET  /debug/prof            (every local engine's round attribution)
  GET  /debug/outliers        (the SLO-breach dossier ring)
  GET  /debug/outliers/{id}[?format=perfetto]
                              (one dossier, as JSON or a Perfetto timeline)

Each request mints a trace at tokenize (``trace_sample_rate`` of them
full, the rest shells that a failure or a migration promotes); the
worker's spans come back in the finishing output's annotations and merge
into it, and a request past an SLO target (or a
``forensics_sample_rate`` draw) leaves a dossier.

A request every worker (or the local engine) refused at admission
(EngineOverloadedError) answers 429 with a whole-second Retry-After,
unary and streamed: a stream answers 429 before the SSE stream is
prepared when every choice bounced before its first output.

Streaming honours client disconnect: the server cancels the handler when
the connection drops, and the handler closes its response generators,
which cancels the engine requests (the engine's drop-to-cancel contract —
reference AsyncEngineContext::stop_generating).

Chat requests that declare ``tools`` get the model's tool calls parsed
(tool_calls.py): unary answers carry ``message.tool_calls`` with
``finish_reason: "tool_calls"``; streams hold tool-shaped text back and
send the calls before the finish. ``nvext.annotations: ["llm_metrics"]``
adds one event before ``[DONE]`` with the request's token counts, TTFT
and ITL figures.
"""
from __future__ import annotations

import asyncio
import copy
import json
import logging
import math
import random
import time
import uuid
from collections import deque
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.frontend.http import (
    HttpServer,
    Request,
    Response,
    StreamResponse,
)
from dynamo_tpu_torch.frontend.model_manager import ModelManager, ModelNotFound
from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY
from dynamo_tpu_torch.kv_quant import KV_QUANT
from dynamo_tpu_torch.kv_fleet_metrics import KV_FLEET
from dynamo_tpu_torch.spec.metrics import SPEC
from dynamo_tpu_torch.kv_transfer_metrics import KV_TRANSFER
from dynamo_tpu_torch.tenancy.metrics import TENANT
from dynamo_tpu_torch.tenancy.quotas import DEFAULT_TENANT
from dynamo_tpu_torch.overload.deadline import apply_request_hints
from dynamo_tpu_torch.overload.errors import EngineOverloadedError
from dynamo_tpu_torch.overload.metrics import OVERLOAD
from dynamo_tpu_torch.planner_metrics import PLANNER
from dynamo_tpu_torch.protocols.common import FinishReason, LLMEngineOutput
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    DeltaGenerator,
    EmbeddingRequest,
    ResponsesRequest,
    ValidationError,
    chat_completion_response,
    completion_logprobs,
    completion_response,
    embedding_response,
    make_id,
    model_list_response,
    responses_response,
)
from dynamo_tpu_torch.protocols.sse import encode_done, encode_event
from dynamo_tpu_torch.resilience.metrics import RESILIENCE
from dynamo_tpu_torch.runtime.remote_engine import invoke_clear
from dynamo_tpu_torch.runtime.store_metrics import STORE
from dynamo_tpu_torch.telemetry import metrics as tmetrics
from dynamo_tpu_torch.telemetry.fleet_feed import FLEET_FEED
from dynamo_tpu_torch.telemetry.forensics import (
    FORENSICS,
    OUTLIERS,
    ForensicsCapture,
)
from dynamo_tpu_torch.telemetry.prof import PROF
from dynamo_tpu_torch.telemetry.timeline import to_chrome_trace
from dynamo_tpu_torch.telemetry.trace import TRACES, span_now
from dynamo_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    LabeledHistogram,
    MetricsRegistry,
    TelemetryRegistry,
    request_histograms,
)
from dynamo_tpu_torch.tool_calls import (
    ToolCallAccumulator,
    parse_tool_calls_with_content,
)

log = logging.getLogger(__name__)

# the reference's plain scrape: prometheus_client's type, parameters cut
PROMETHEUS_CONTENT_TYPE = "text/plain"
# OpenMetrics negotiation: exemplars only ship to scrapers that ask
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text"


def wants_openmetrics(request: Request) -> bool:
    return OPENMETRICS_CONTENT_TYPE in request.headers.get("Accept", "")


class ServiceMetrics:
    """Frontend Prometheus metrics (reference metrics.rs
    nv_llm_http_service_{requests_total,inflight_requests,request_duration_seconds})."""

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        # prometheus_client families in the reference: each labelled
        # child also carries its creation time as a ``_created`` sample
        self.requests_total = Counter(
            "dynamo_http_service_requests_total",
            "HTTP requests by model/endpoint/status",
            ("model", "endpoint", "status"),
            self.registry, created=True,
        )
        self.inflight = Gauge(
            "dynamo_http_service_inflight_requests",
            "In-flight requests",
            ("model",),
            self.registry,
        )
        self.duration = LabeledHistogram(
            "dynamo_http_service_request_duration_seconds",
            "Request duration",
            ("model",),
            self.registry, created=True,
        )

    def render(self) -> bytes:
        return self.registry.render().encode()


def _error(status: int, message: str,
           err_type: str = "invalid_request_error",
           headers: Optional[dict] = None) -> Response:
    return Response.json(
        {"error": {"message": message, "type": err_type, "code": status}},
        status=status, headers=headers,
    )


def _overloaded_response(e: EngineOverloadedError) -> Response:
    """HTTP 429 with the load-derived Retry-After (whole seconds, rounded
    up: RFC 7231 delta-seconds)."""
    OVERLOAD.inc("dynamo_overload_http_429_total")
    # a tenant-quota refusal names its tenant; a global-backlog one ("")
    # lands on the default slice, so the series' totals reconcile
    TENANT.inc("dynamo_tenant_http_429_total", e.tenant or DEFAULT_TENANT)
    retry_after = max(1, int(-(-e.retry_after_s // 1)))
    return _error(429, str(e) or "engine overloaded", "overloaded_error",
                  headers={"Retry-After": str(retry_after)})


class _ApiError(Exception):
    """Endpoint-local error mapped to an OpenAI error response by
    _run_endpoint (the shared request envelope)."""

    def __init__(self, status: int, message: str,
                 etype: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.message = message
        self.etype = etype


class _RequestTiming:
    """Per-request latency bookkeeping shared by the unary and streaming
    paths: frontend-observed TTFT / per-token ITL gaps / E2E into the
    service histograms (the request id as exemplar), and worker-side
    trace spans merged into the trace store."""

    def __init__(self, svc: "HttpService", request_id: str, t_start: float,
                 tenant: str = ""):
        self.svc = svc
        self.rid = request_id
        self.t_start = t_start
        self.tenant = tenant
        self.t_first: dict[int, float] = {}
        self.t_last: dict[int, float] = {}
        self.tok_counts: dict[int, int] = {}
        self.gaps: list[tuple[float, int]] = []   # (gap_s, n) all streams
        self.worker_timing: dict[str, Any] = {}   # last timing annotation
        self._finished = False

    def on_output(self, i: int, out: LLMEngineOutput) -> None:
        if out.token_ids:
            now = time.monotonic()
            prev = self.t_last.get(i)
            n = len(out.token_ids)
            if prev is not None:
                gap = (now - prev) / n
                self.svc._h_itl.observe(gap, n, exemplar_id=self.rid)
                if len(self.gaps) < 4096:  # percentile fidelity cap
                    self.gaps.append((gap, n))
            self.t_last[i] = now
            self.t_first.setdefault(i, now)
            self.tok_counts[i] = self.tok_counts.get(i, 0) + n
        ann = out.annotations or {}
        spans = (ann.get("trace") or {}).get("spans")
        if spans:
            TRACES.merge(self.rid, spans)
        if ann.get("timing"):
            self.worker_timing = ann["timing"]

    @property
    def ttft(self) -> Optional[float]:
        if not self.t_first:
            return None
        return min(self.t_first.values()) - self.t_start

    def itl_avg(self) -> Optional[float]:
        # per generation, not the n-way interleave
        itls = [
            (self.t_last[i] - self.t_first[i]) / (self.tok_counts[i] - 1)
            for i in self.t_first
            if self.tok_counts.get(i, 0) > 1
        ]
        return sum(itls) / len(itls) if itls else None

    def itl_percentile(self, q: float) -> Optional[float]:
        return tmetrics.weighted_percentile(self.gaps, q)

    def finish(self) -> None:
        """Observe the request-level histograms (once). Runs from the
        finally paths too — a client that disconnects mid-stream already
        contributed ITL gaps, so TTFT/E2E must count it as well; a
        request that never produced a token contributes to none of the
        three series (counts stay mutually consistent)."""
        if self._finished:
            return
        self._finished = True
        if not self.t_first:
            return
        ttft = self.ttft
        e2e = time.monotonic() - self.t_start
        self.svc._h_ttft.observe(ttft, exemplar_id=self.rid)
        self.svc._h_e2e.observe(e2e, exemplar_id=self.rid)
        # SLO-breach forensics: the no-breach path is a couple of float
        # compares; this runs before the trace is finished, so a breach
        # promotion still adopts a shell's buffered spans
        timing = dict(self.worker_timing)
        if self.tenant:
            timing.setdefault("tenant", self.tenant)
        self.svc.forensics.on_finish(
            self.rid, ttft_s=ttft, itl_p95_s=self.itl_percentile(0.95),
            e2e_s=e2e, queue_s=self.worker_timing.get("queue_s"),
            timing=timing)


class HttpService:
    """The OpenAI-compatible frontend over a ModelManager."""

    def __init__(
        self,
        manager: Optional[ModelManager] = None,
        *,
        host: str = "0.0.0.0",
        port: int = 8080,
        trace_sample_rate: float = 1.0,
        forensics_sample_rate: float = 0.0,
    ):
        # the share of requests minting a FULL trace; the rest carry a
        # shell trace that the failure and migration paths promote
        self.trace_sample_rate = trace_sample_rate
        self._trace_rng = random.Random()
        # SLO-breach dossiers: every finishing request runs the breach
        # check; breaches (and a forensics_sample_rate draw) land in the
        # OUTLIERS ring at /debug/outliers
        self.forensics = ForensicsCapture(
            sample_rate=forensics_sample_rate,
            engines_fn=self._local_engines)
        # `is not None`, NOT truthiness: an EMPTY manager (len 0 -> falsy)
        # must be kept — models registered into it later must be served
        self.manager = manager if manager is not None else ModelManager()
        self.host = host
        self.port = port
        # the fleet prefix economy: per-model FleetKvView registry served
        # at /debug/kv_fleet; the launcher points it at the ModelWatcher's
        # live dict, so discovered KV-routed models appear in it
        self.fleet_views: dict[str, Any] = {}
        self.metrics = ServiceMetrics()
        # request-latency histograms (TTFT / ITL / E2E), observed at the
        # frontend's measurement points and appended to /metrics
        self.telemetry = request_histograms(TelemetryRegistry())
        self._h_ttft = self.telemetry.get(tmetrics.TTFT[0])
        self._h_itl = self.telemetry.get(tmetrics.ITL[0])
        self._h_e2e = self.telemetry.get(tmetrics.E2E[0])
        self.server = HttpServer({
            ("POST", "/v1/chat/completions"): self.handle_chat,
            ("POST", "/v1/completions"): self.handle_completion,
            ("POST", "/v1/embeddings"): self.handle_embeddings,
            ("POST", "/v1/responses"): self.handle_responses,
            ("GET", "/v1/models"): self.handle_models,
            ("GET", "/health"): self.handle_health,
            ("GET", "/live"): self.handle_health,
            ("GET", "/metrics"): self.handle_metrics,
            ("POST", "/clear_kv_blocks"): self.handle_clear_kv,
            ("GET", "/debug/kv_fleet"): self.handle_kv_fleet,
            ("GET", "/debug/tenants"): self.handle_tenants,
            ("GET", "/debug/trace"): self.handle_trace_index,
            ("GET", "/debug/trace/{request_id}"): self.handle_trace,
            ("GET", "/debug/flight"): self.handle_flight,
            ("GET", "/debug/prof"): self.handle_prof,
            ("GET", "/debug/outliers"): self.handle_outliers,
            ("GET", "/debug/outliers/{request_id}"): self.handle_outlier,
        })
        self._start_time = time.monotonic()

    # ------------------------------------------------------------------
    # lifecycle

    async def start(self) -> None:
        """Listen on host:port; with port 0 the bound port is set on
        ``self.port``."""
        self.port = await self.server.start(self.host, self.port)
        log.info("http service listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        await self.server.stop()

    # ------------------------------------------------------------------
    # handlers

    async def handle_health(self, request: Request) -> Response:
        return Response.json(
            {
                "status": "healthy",
                "uptime_s": round(time.monotonic() - self._start_time, 3),
                "models": self.manager.list_models(),
            }
        )

    async def handle_models(self, request: Request) -> Response:
        return Response.json(model_list_response(self.manager.list_models()))

    async def handle_metrics(self, request: Request) -> Response:
        # the SLO burn rates refresh at scrape time from the frontend's
        # own latency histograms (an in-process engine also folds its
        # view at the publish cadence)
        if self._h_ttft.count or self._h_itl.count:
            PROF.fold_burn_rates(self._h_ttft.snapshot(),
                                 self._h_itl.snapshot())
        om = wants_openmetrics(request)
        body = (self.metrics.render()
                + self.telemetry.render(openmetrics=om).encode()
                + KV_TRANSFER.render().encode()
                + KV_QUANT.render().encode()
                + KV_INTEGRITY.render().encode()
                + STORE.render().encode()
                + RESILIENCE.render().encode()
                + OVERLOAD.render().encode()
                + PROF.render().encode()
                + TENANT.render().encode()
                + PLANNER.render().encode()
                + KV_FLEET.render().encode()
                + SPEC.render().encode()
                + FLEET_FEED.render(openmetrics=om).encode()
                + FORENSICS.render().encode())
        if om:
            return Response(body + b"# EOF\n",
                            content_type=OPENMETRICS_CONTENT_TYPE)
        return Response(body, content_type=PROMETHEUS_CONTENT_TYPE)

    # ------------------------------------------------------------------
    # debug plane: span trees, flight rings, attribution and dossiers

    async def handle_trace_index(self, request: Request) -> Response:
        return Response.json({"recent": TRACES.recent_ids()})

    async def handle_trace(self, request: Request) -> Response:
        rid = request.match_info["request_id"]
        tr = TRACES.get(rid)
        if tr is None:
            # the body says WHY: evicted, unsampled or never seen
            return Response.json(TRACES.describe_missing(rid), status=404)
        return Response.json(tr.to_dict())

    def _local_engines(self) -> list:
        """In-process engines whose prof and flight rings feed dossiers
        (remote workers assemble their own behind their system server)."""
        engines = []
        for name in self.manager.list_models():
            try:
                engines.append(self.manager.get(name).engine)
            except Exception as e:  # noqa: BLE001 — forensics never throws
                log.debug("forensics: skipping engine %s: %s", name, e)
        return engines

    async def handle_flight(self, request: Request) -> Response:
        """Flight rings of every local engine, keyed by model (remote
        workers serve their own at their system servers)."""
        out = {}
        for name in self.manager.list_models():
            flight = getattr(self.manager.get(name).engine, "flight", None)
            if flight is not None:
                out[name] = {"recorded_total": flight.recorded_total,
                             "events": flight.snapshot()}
        return Response.json({"engines": out})

    async def handle_prof(self, request: Request) -> Response:
        """GET /debug/prof[?top=N]: every local engine's host-round
        attribution (the system server's body, keyed by model) and the
        live SLO burn rates."""
        try:
            top = int(request.query.get("top", 0))
        except ValueError:
            top = 0
        out = {}
        for name in self.manager.list_models():
            prof = getattr(self.manager.get(name).engine, "prof", None)
            if prof is not None:
                out[name] = prof.summary(top=top)
        return Response.json({"engines": out,
                              "slo_burn_rates": PROF.burn_rates()})

    async def handle_outliers(self, request: Request) -> Response:
        """GET /debug/outliers: the dossier ring's capture counts and
        newest-first summaries."""
        return Response.json(OUTLIERS.index())

    async def handle_outlier(self, request: Request) -> Response:
        """GET /debug/outliers/{request_id}[?format=perfetto]: one
        dossier, as JSON or as a Perfetto/Chrome timeline merging its
        spans, host rounds, flight and stream events."""
        rid = request.match_info["request_id"]
        d = OUTLIERS.get(rid)
        if d is None:
            return Response.json({
                "error": f"no dossier for request {rid!r}",
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

    async def handle_tenants(self, request: Request) -> Response:
        """GET /debug/tenants: the tenancy plane in one JSON page, the
        frontend's own tenant metric snapshot plus every local engine's
        quota and queue view, keyed by model (remote workers serve the
        same shape from their system servers)."""
        engines: dict[str, Any] = {}
        for name in self.manager.list_models():
            dbg = getattr(self.manager.get(name).engine, "tenant_debug",
                          None)
            if dbg is None:
                continue
            try:
                engines[name] = dbg()
            except Exception as e:  # noqa: BLE001 — debug page never throws
                log.debug("tenant debug for %s failed: %s", name, e)
        return Response.json({"tenants": TENANT.snapshot(),
                              "engines": engines})

    async def handle_kv_fleet(self, request: Request) -> Response:
        """GET /debug/kv_fleet[?model=NAME][&top=K]: the live fleet prefix
        economy per KV-routed model, its replica map and top-K hot
        prefixes (kv_router/fleet.py FleetKvView.to_dict)."""
        try:
            top = int(request.query.get("top", 32))
        except ValueError:
            top = 32
        want = request.query.get("model")
        views = self.fleet_views
        if want is not None:
            if want not in views:
                return Response.json(
                    {"error": f"no fleet view for model {want!r}"},
                    status=404)
            views = {want: views[want]}
        return Response.json({
            "models": {
                name: view.to_dict(top=top)
                for name, view in sorted(views.items())
            },
        })

    async def handle_clear_kv(self, request: Request) -> Response:
        """Drop every reusable cached KV block of every served engine
        that has a cache (reference clear_kv_blocks.rs): a local engine's
        clear runs in a worker thread, a remote engine or a KV router fans
        the clear out to its workers."""
        cleared = []
        for name in self.manager.list_models():
            clear = getattr(self.manager.get(name).engine,
                            "clear_kv_blocks", None)
            if clear is not None:
                await invoke_clear(clear)
                cleared.append(name)
        return Response.json({"cleared": cleared})

    async def handle_embeddings(self, request: Request) -> Response:
        """OpenAI /v1/embeddings over any engine exposing ``embed``
        (reference protocols/openai embeddings surface): each input is
        tokenized (or taken as token ids) and embedded on a worker
        thread; ``dimensions`` truncates each vector and normalizes it
        again."""
        try:
            body = request.json()
        except ValueError:
            return _error(400, "invalid JSON body")
        try:
            req = EmbeddingRequest.from_dict(body)
        except ValidationError as e:
            return _error(400, e.msg)
        try:
            chain = self.manager.get(req.model)
        except ModelNotFound:
            return _error(404, f"model '{req.model}' not found",
                          "not_found_error")
        embed = getattr(chain.engine, "embed", None)
        if embed is None:
            return _error(400, f"model '{req.model}' does not serve "
                               "embeddings")
        # normalize input to a list of token-id lists
        raw = req.input
        if isinstance(raw, str):
            raw = [raw]
        elif raw and isinstance(raw[0], int):
            raw = [raw]
        if not raw:
            return _error(400, "empty input")
        token_lists = [
            chain.preprocessor.tokenizer.encode(item)
            if isinstance(item, str) else list(item)
            for item in raw
        ]
        if any(not t for t in token_lists):
            return _error(400, "empty input")
        try:
            vectors = list(await asyncio.gather(*[
                asyncio.to_thread(embed, toks) for toks in token_lists]))
        except ValueError as e:  # the engine's input bound
            return _error(400, str(e))
        if req.dimensions:
            # OpenAI contract: truncate, then normalize again
            def shrink(v):
                v = v[: req.dimensions]
                norm = math.sqrt(sum(x * x for x in v)) or 1.0
                return [x / norm for x in v]

            vectors = [shrink(v) for v in vectors]
        return Response.json(embedding_response(
            req.model, vectors,
            prompt_tokens=sum(len(t) for t in token_lists),
            encoding_format=req.encoding_format,
        ))

    async def handle_responses(self, request: Request):
        """OpenAI Responses API (reference protocols/openai/responses.rs):
        lowered onto the chat pipeline through ResponsesRequest.to_chat().
        Stateless: ``previous_response_id`` chaining is refused at
        validation. A LENGTH finish answers ``incomplete`` with reason
        ``max_output_tokens``."""

        async def run(body: Any, env: dict):
            try:
                rreq = ResponsesRequest.from_dict(body)
                chat_req = rreq.to_chat()
            except ValueError as e:  # ValidationError's str is its msg
                raise _ApiError(400, str(e)) from None
            env["model"] = rreq.model
            chain = self._resolve_model(rreq.model, chat=True)
            try:
                pre = chain.preprocess(chat_req)
            except ValueError as e:
                raise _ApiError(400, str(e)) from None

            rid = make_id("resp")
            self.metrics.inflight.labels(rreq.model).inc()
            try:
                if rreq.stream:
                    return await self._stream_responses_api(
                        request, rreq, chain, pre, rid)
                text = ""
                n_tok = 0
                finish: Optional[FinishReason] = None
                stream = chain.generate(pre)
                try:
                    async for out in stream:
                        if out.text:
                            text += out.text
                        n_tok += len(out.token_ids)
                        if out.finish_reason is not None:
                            finish = out.finish_reason
                finally:
                    await _close_stream(stream)
                incomplete = finish == FinishReason.LENGTH
                return Response.json(responses_response(
                    rid=rid, model=rreq.model, text=text,
                    prompt_tokens=len(pre.token_ids),
                    completion_tokens=n_tok,
                    status="incomplete" if incomplete else "completed",
                    incomplete_reason=(
                        "max_output_tokens" if incomplete else None),
                ))
            finally:
                self.metrics.inflight.labels(rreq.model).dec()

        return await self._run_endpoint(request, "responses", run)

    async def _stream_responses_api(self, request: Request, rreq, chain,
                                    pre, rid: str) -> StreamResponse:
        """Responses-API SSE: typed events, each with an ``event:`` line
        (response.created -> response.output_text.delta* ->
        response.output_text.done -> response.completed, or
        response.incomplete on a LENGTH finish; response.failed in-band
        when the engine stream fails after the stream is prepared)."""
        resp = StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            },
        )
        await resp.prepare(request)

        async def event(etype: str, data: dict) -> None:
            await resp.write(encode_event(
                json.dumps({"type": etype, **data}), event=etype))

        snapshot = responses_response(
            rid=rid, model=rreq.model, text="",
            prompt_tokens=len(pre.token_ids), completion_tokens=0,
            status="in_progress",
        )
        await event("response.created", {"response": snapshot})
        text = ""
        n_tok = 0
        finish: Optional[FinishReason] = None
        stream = chain.generate(pre)
        try:
            try:
                async for out in stream:
                    if out.text:
                        text += out.text
                        await event("response.output_text.delta",
                                    {"delta": out.text, "output_index": 0,
                                     "content_index": 0})
                    n_tok += len(out.token_ids)
                    if out.finish_reason is not None:
                        finish = out.finish_reason
            except Exception as e:  # noqa: BLE001 — in-band: the stream
                # is already prepared, a 500 can no longer be returned
                log.warning("responses stream failed: %s", e)
                await event("response.failed", {"response": {
                    "id": rid, "object": "response", "status": "failed",
                    "error": {"message": str(e)},
                }})
                await resp.write_eof()
                return resp
            await event("response.output_text.done",
                        {"text": text, "output_index": 0, "content_index": 0})
            incomplete = finish == FinishReason.LENGTH
            final = responses_response(
                rid=rid, model=rreq.model, text=text,
                prompt_tokens=len(pre.token_ids), completion_tokens=n_tok,
                status="incomplete" if incomplete else "completed",
                incomplete_reason="max_output_tokens" if incomplete else None,
            )
            await event(
                "response.incomplete" if incomplete else "response.completed",
                {"response": final})
        except ConnectionResetError:
            # routine client disconnect: not an error; the prepared
            # StreamResponse is all we can return
            log.info("client disconnected mid-stream")
            return resp
        finally:
            await _close_stream(stream)
        await resp.write_eof()
        return resp

    def _resolve_model(self, name: str, *, chat: bool = False,
                       completion: bool = False):
        try:
            return self.manager.get(name, chat=chat, completion=completion)
        except ModelNotFound:
            raise _ApiError(404, f"model '{name}' not found",
                            "not_found_error") from None

    async def _run_endpoint(self, request: Request, endpoint: str, fn):
        """Shared request envelope: JSON-parse, _ApiError mapping, metrics
        accounting (requests_total/duration), 499 on cancellation.
        `fn(body, env)` does the endpoint-specific work and sets
        env["model"] as soon as it is known."""
        env = {"model": "", "t0": time.monotonic()}
        status = "500"
        t0 = env["t0"]
        try:
            try:
                body = request.json()
            except ValueError:
                status = "400"
                return _error(400, "invalid JSON body")
            try:
                resp = await fn(body, env)
            except _ApiError as e:
                status = str(e.status)
                return _error(e.status, e.message, e.etype)
            except EngineOverloadedError as e:
                # every worker (or the local engine) refused admission:
                # retriable by construction, so 429 + Retry-After, never
                # a 500
                status = "429"
                return _overloaded_response(e)
            status = str(resp.status)
            return resp
        except asyncio.CancelledError:
            status = "499"
            raise
        except Exception:  # noqa: BLE001 — every request gets an answer
            log.exception("%s handler failed", endpoint)
            return _error(500, "internal error", "internal_server_error")
        finally:
            self.metrics.requests_total.labels(
                env["model"], endpoint, status).inc()
            self.metrics.duration.labels(env["model"]).observe(
                time.monotonic() - t0)

    async def handle_chat(self, request: Request):
        return await self._handle_openai(request, chat=True)

    async def handle_completion(self, request: Request):
        return await self._handle_openai(request, chat=False)

    # ------------------------------------------------------------------
    # core request path

    async def _handle_openai(self, request: Request, *, chat: bool):
        endpoint = "chat_completions" if chat else "completions"

        async def run(body: Any, env: dict):
            try:
                req = (ChatCompletionRequest if chat
                       else CompletionRequest).from_dict(body)
            except ValidationError as e:
                raise _ApiError(400, e.msg) from None
            env["model"] = req.model
            chain = self._resolve_model(req.model, chat=chat,
                                        completion=not chat)
            t_tok = time.monotonic()
            try:
                pre = chain.preprocess(req)
            except ValueError as e:
                raise _ApiError(400, str(e)) from None
            # the trace, minted here and keyed by the engine-facing
            # request id (the router's and the worker's spans come back
            # under it); below the sample rate an unsampled shell
            sampled = (self.trace_sample_rate >= 1.0
                       or self._trace_rng.random() < self.trace_sample_rate)
            trace = TRACES.start(pre.request_id, sampled=sampled)
            trace.add(span_now("tokenize", t_tok, model=req.model,
                               prompt_tokens=len(pre.token_ids)))
            # a breach is only known at finish: the worker keeps the
            # request's full round-span history until then
            if "trace_detail" not in pre.annotations:
                pre.annotations.append("trace_detail")
            # header hints land on top of the nvext fields the
            # preprocessor already applied (headers win; nvext is NOT
            # re-applied — re-minting its deadline here would silently
            # extend it by the tokenize latency)
            apply_request_hints(pre, request.headers, None)

            self.metrics.inflight.labels(req.model).inc()
            try:
                if req.stream:
                    return await self._stream_response(
                        request, req, chain, pre, chat,
                        t_received=env["t0"])
                return await self._unary_response(
                    req, chain, pre, chat, t_received=env["t0"])
            finally:
                self.metrics.inflight.labels(req.model).dec()
                tr = TRACES.finish(pre.request_id)
                # a breach decision made by timing.finish() assembles its
                # dossier here, from the fully merged trace
                self.forensics.on_trace_finished(pre.request_id, tr)

        return await self._run_endpoint(request, endpoint, run)

    def _fanout(self, req, chain, pre) -> list[AsyncIterator[LLMEngineOutput]]:
        """n>1: run n independent engine streams (distinct seeds per choice,
        like the reference's engines do for best-of/n sampling)."""
        n = max(1, req.n)
        streams = []
        for i in range(n):
            p = _with_choice_seed(pre, i)
            if p.request_id != pre.request_id:
                # an extra choice's fresh request id: its spans belong on
                # the parent request's tree
                TRACES.alias(p.request_id, pre.request_id)
            streams.append(chain.generate(p))
        return streams

    async def _unary_response(
        self, req, chain, pre, chat: bool,
        t_received: Optional[float] = None,
    ) -> Response:
        streams = self._fanout(req, chain, pre)
        texts = [""] * len(streams)
        tokens = [0] * len(streams)
        finishes: list[FinishReason] = [FinishReason.EOS] * len(streams)
        lp_entries: list[list[dict]] = [[] for _ in streams]
        t_start = t_received if t_received is not None else time.monotonic()
        timing = _RequestTiming(self, pre.request_id, t_start,
                                tenant=getattr(pre, "tenant", "") or "")

        async def drain(i: int) -> None:
            try:
                async for out in streams[i]:
                    if out.text:
                        texts[i] += out.text
                    tokens[i] += len(out.token_ids)
                    timing.on_output(i, out)
                    if out.logprob_entries:
                        lp_entries[i].extend(out.logprob_entries)
                    if out.finish_reason is not None:
                        finishes[i] = out.finish_reason
            finally:
                await streams[i].aclose()

        try:
            results = await asyncio.gather(
                *[drain(i) for i in range(len(streams))],
                return_exceptions=True,
            )
            for r in results:
                if isinstance(r, BaseException):
                    raise r
        finally:
            timing.finish()
        if chat:
            choices = []
            for i in range(len(streams)):
                message: dict = {"role": "assistant", "content": texts[i]}
                finish = finishes[i].to_openai()
                if req.tools:
                    calls, content = parse_tool_calls_with_content(
                        texts[i], _declared_tool_names(req)
                    )
                    if calls is not None:
                        message = {"role": "assistant", "content": content,
                                   "tool_calls": calls}
                        finish = "tool_calls"
                choices.append({
                    "index": i,
                    "message": message,
                    "finish_reason": finish,
                    "logprobs": (
                        {"content": lp_entries[i]} if lp_entries[i] else None
                    ),
                })
            body = chat_completion_response(
                rid=make_id("chatcmpl"),
                model=req.model,
                choices=choices,
                prompt_tokens=len(pre.token_ids),
                completion_tokens=sum(tokens),
            )
        else:
            choices = [
                {
                    "index": i,
                    "text": texts[i],
                    "finish_reason": finishes[i].to_openai(),
                    "logprobs": (
                        completion_logprobs(lp_entries[i])
                        if lp_entries[i] else None
                    ),
                }
                for i in range(len(streams))
            ]
            body = completion_response(
                rid=make_id("cmpl"),
                model=req.model,
                choices=choices,
                prompt_tokens=len(pre.token_ids),
                completion_tokens=sum(tokens),
            )
        return Response.json(body, headers={"X-Request-Id": pre.request_id})

    async def _stream_response(
        self, request: Request, req, chain, pre, chat: bool,
        t_received: Optional[float] = None,
    ) -> StreamResponse:
        resp = StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
                "X-Request-Id": pre.request_id,
            },
        )
        gen = DeltaGenerator(req.model, chat=chat, n=max(1, req.n))
        streams = self._fanout(req, chain, pre)
        completion_tokens = 0
        # in-band per-request metrics annotation (reference
        # ANNOTATION_LLM_METRICS, preprocessor.rs:68-90): opt in via
        # nvext {"annotations": ["llm_metrics"]} — the preprocessor has
        # already normalized them onto the request
        want_llm_metrics = "llm_metrics" in pre.annotations
        # per-stream first/last token times: ITL must be per generation,
        # not the n-way interleave; TTFT runs from request RECEIPT
        # (envelope entry — includes preprocess time, matching the
        # reference's measurement point)
        t_start = t_received if t_received is not None else time.monotonic()
        timing = _RequestTiming(self, pre.request_id, t_start,
                                tenant=getattr(pre, "tenant", "") or "")
        # tool-call detection: hold back tool-shaped text until it parses
        tool_accs: dict[int, ToolCallAccumulator] = {}
        if chat and req.tools:
            allowed = _declared_tool_names(req)
            tool_accs = {i: ToolCallAccumulator(allowed)
                         for i in range(len(streams))}
        queue: asyncio.Queue = asyncio.Queue()
        DONE = object()

        async def pump(i: int) -> None:
            try:
                async for out in streams[i]:
                    await queue.put((i, out))
            except Exception as e:  # noqa: BLE001 — surfaced in-band per choice
                await queue.put((i, e))
            finally:
                await queue.put((i, DONE))

        tasks = [asyncio.create_task(pump(i)) for i in range(len(streams))]
        live = len(streams)

        async def close_all() -> None:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for s in streams:
                try:
                    await s.aclose()
                except Exception:  # noqa: BLE001 — closing must not mask
                    log.debug("stream close failed", exc_info=True)

        # admission probe before the SSE stream is prepared: when every
        # choice bounces with EngineOverloadedError before any output, the
        # client gets a clean 429 + Retry-After (a prepared 200 stream
        # carrying an error event is not retriable by standard clients).
        # The first real item, or another error (reported in-band), ends
        # the probe; stashed overload errors then go in-band too
        pending: deque = deque()
        overloads: list = []
        try:
            while live and not pending:
                i, item = await queue.get()
                if item is DONE:
                    live -= 1
                elif isinstance(item, EngineOverloadedError):
                    overloads.append((i, item))
                else:
                    pending.append((i, item))
        except asyncio.CancelledError:
            await close_all()
            raise
        if not pending and not live and overloads:
            timing.finish()
            await close_all()
            raise overloads[0][1]  # -> _run_endpoint answers 429
        pending.extend(overloads)
        try:
            await resp.prepare(request)
            while live or pending:
                i, item = (pending.popleft() if pending
                           else await queue.get())
                if item is DONE:
                    live -= 1
                    continue
                if isinstance(item, Exception):
                    # the failed pump's DONE sentinel still arrives and
                    # decrements `live`; just surface the error in-band.
                    # Flush any tool-detection buffer first — held-back
                    # text must not vanish with the error.
                    if i in tool_accs:
                        _calls, leftover = tool_accs[i].finalize()
                        if leftover:
                            await resp.write(encode_event(
                                gen.text_chunk(leftover, index=i)
                            ))
                    log.warning("engine stream %d failed: %s", i, item)
                    # a failed request is always traced: a shell is
                    # promoted so the failure's context survives
                    TRACES.promote(pre.request_id)
                    await resp.write(
                        encode_event({"error": {"message": str(item)}})
                    )
                    continue
                timing.on_output(i, item)
                completion_tokens += len(item.token_ids)
                text = item.text or ""
                if i in tool_accs and text:
                    text = tool_accs[i].feed(text)
                if text or item.logprob_entries:
                    # entries may arrive on a text-less output (final token
                    # eaten by the stop jail / partial UTF-8) — still owed
                    # to the client, one entry per token
                    await resp.write(
                        encode_event(gen.text_chunk(
                            text, index=i,
                            logprob_entries=item.logprob_entries,
                        ))
                    )
                if item.finish_reason is not None:
                    finish_override = None
                    if i in tool_accs:
                        calls, leftover = tool_accs[i].finalize()
                        if leftover:
                            # hermes prose / text that wasn't a tool call
                            await resp.write(encode_event(
                                gen.text_chunk(leftover, index=i)
                            ))
                        if calls is not None:
                            await resp.write(encode_event(
                                gen.tool_calls_chunk(calls, index=i)
                            ))
                            finish_override = "tool_calls"
                    await resp.write(
                        encode_event(gen.finish_chunk(
                            item.finish_reason, index=i,
                            finish_override=finish_override,
                        ))
                    )
            if req.stream_options and req.stream_options.include_usage:
                await resp.write(
                    encode_event(
                        gen.usage_chunk(len(pre.token_ids), completion_tokens)
                    )
                )
            if want_llm_metrics:
                await resp.write(encode_event(_llm_metrics_event(
                    timing, len(pre.token_ids), completion_tokens)))
            await resp.write(encode_done())
        except ConnectionResetError:
            # routine client disconnect: not an error; the prepared
            # StreamResponse is all we can return
            log.info("client disconnected mid-stream")
        finally:
            # disconnect/cancel paths too: tokens already streamed must
            # count in TTFT/E2E alongside their observed ITL gaps
            timing.finish()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for s in streams:
                try:
                    await s.aclose()
                except Exception:  # noqa: BLE001 — closing must not mask
                    log.debug("stream close failed", exc_info=True)
        return resp


async def _close_stream(stream) -> None:
    """Close an engine stream; a failure to close must not mask what
    the caller is returning."""
    close = getattr(stream, "aclose", None)
    if close is not None:
        try:
            await close()
        except Exception:  # noqa: BLE001
            log.debug("stream close failed", exc_info=True)


def _llm_metrics_event(timing: _RequestTiming, prompt_tokens: int,
                       completion_tokens: int) -> dict[str, Any]:
    """The in-band ``llm_metrics`` annotation sent before ``[DONE]``."""

    def r6(v: Optional[float]) -> Optional[float]:
        return round(v, 6) if v is not None else None

    return {"nvext": {"annotation": "llm_metrics", "metrics": {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "ttft_s": r6(timing.ttft),
        "itl_avg_s": r6(timing.itl_avg()),
        "itl_p50_s": r6(timing.itl_percentile(0.50)),
        "itl_p95_s": r6(timing.itl_percentile(0.95)),
    }}}


def _declared_tool_names(req) -> Optional[set]:
    """Function names declared in the request's tools (None when they
    can't be extracted — then any well-formed call name is accepted)."""
    names = set()
    for t in req.tools or []:
        if isinstance(t, dict):
            n = (t.get("function") or {}).get("name") or t.get("name")
            if n:
                names.add(n)
    return names or None


def _with_choice_seed(pre, i: int):
    """Give choice i>0 a distinct sampling seed and request id so n
    choices differ."""
    if i == 0:
        return pre
    p = copy.copy(pre)
    p.sampling_options = copy.copy(pre.sampling_options)
    if p.sampling_options.seed is not None:
        p.sampling_options.seed = p.sampling_options.seed + i
    else:
        p.sampling_options.seed = 0x5EED ^ (i * 0x9E3779B9)
    p.request_id = uuid.uuid4().hex
    return p
