"""OpenAI HTTP service (a copy of the JAX package's frontend/service.py on
the port's standard-library HTTP server; reference lib/llm/src/http/
service: service_v2.rs:50 HttpService, openai.rs:133,287 handlers,
metrics.rs:104).

Endpoints:
  POST /v1/chat/completions   (streamed SSE or aggregated JSON)
  POST /v1/completions
  GET  /v1/models
  GET  /health, /live
  GET  /metrics               (Prometheus text, with the KV planes'
                               dynamo_kv_quant_* and dynamo_kv_integrity_*
                               families, the store's dynamo_store_*, and
                               the KV router's dynamo_resilience_*,
                               dynamo_migration_* and
                               dynamo_overload_router_spills_total)
  POST /clear_kv_blocks       (every served engine's clear_kv_blocks:
                               {"cleared": [model, ...]}; a KV-routed
                               model's router fans it out to its workers
                               and empties its indexer)

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

Not ported yet: /v1/responses, /v1/embeddings, tracing and the /debug/*
routes, overload 429s (the engine has no admission budgets).
"""
from __future__ import annotations

import asyncio
import copy
import logging
import time
import uuid
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
from dynamo_tpu_torch.overload.deadline import apply_request_hints
from dynamo_tpu_torch.overload.metrics import OVERLOAD
from dynamo_tpu_torch.protocols.common import FinishReason, LLMEngineOutput
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    DeltaGenerator,
    ValidationError,
    chat_completion_response,
    completion_logprobs,
    completion_response,
    make_id,
    model_list_response,
)
from dynamo_tpu_torch.protocols.sse import encode_done, encode_event
from dynamo_tpu_torch.resilience.metrics import RESILIENCE
from dynamo_tpu_torch.runtime.remote_engine import invoke_clear
from dynamo_tpu_torch.runtime.store_metrics import STORE
from dynamo_tpu_torch.telemetry import metrics as tmetrics
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

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class ServiceMetrics:
    """Frontend Prometheus metrics (reference metrics.rs
    nv_llm_http_service_{requests_total,inflight_requests,request_duration_seconds})."""

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.requests_total = Counter(
            "dynamo_http_service_requests_total",
            "HTTP requests by model/endpoint/status",
            ("model", "endpoint", "status"),
            self.registry,
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
            self.registry,
        )

    def render(self) -> bytes:
        return self.registry.render().encode()


def _error(status: int, message: str,
           err_type: str = "invalid_request_error") -> Response:
    return Response.json(
        {"error": {"message": message, "type": err_type, "code": status}},
        status=status,
    )


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
    service histograms."""

    def __init__(self, svc: "HttpService", t_start: float):
        self.svc = svc
        self.t_start = t_start
        self.t_first: dict[int, float] = {}
        self.t_last: dict[int, float] = {}
        self.tok_counts: dict[int, int] = {}
        self.gaps: list[tuple[float, int]] = []   # (gap_s, n) all streams
        self._finished = False

    def on_output(self, i: int, out: LLMEngineOutput) -> None:
        if out.token_ids:
            now = time.monotonic()
            prev = self.t_last.get(i)
            n = len(out.token_ids)
            if prev is not None:
                gap = (now - prev) / n
                self.svc._h_itl.observe(gap, n)
                if len(self.gaps) < 4096:  # percentile fidelity cap
                    self.gaps.append((gap, n))
            self.t_last[i] = now
            self.t_first.setdefault(i, now)
            self.tok_counts[i] = self.tok_counts.get(i, 0) + n

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
        self.svc._h_ttft.observe(self.ttft)
        self.svc._h_e2e.observe(time.monotonic() - self.t_start)


class HttpService:
    """The OpenAI-compatible frontend over a ModelManager."""

    def __init__(
        self,
        manager: Optional[ModelManager] = None,
        *,
        host: str = "0.0.0.0",
        port: int = 8080,
    ):
        # `is not None`, NOT truthiness: an EMPTY manager (len 0 -> falsy)
        # must be kept — models registered into it later must be served
        self.manager = manager if manager is not None else ModelManager()
        self.host = host
        self.port = port
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
            ("GET", "/v1/models"): self.handle_models,
            ("GET", "/health"): self.handle_health,
            ("GET", "/live"): self.handle_health,
            ("GET", "/metrics"): self.handle_metrics,
            ("POST", "/clear_kv_blocks"): self.handle_clear_kv,
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
        body = (self.metrics.render() + self.telemetry.render().encode()
                + KV_QUANT.render().encode()
                + KV_INTEGRITY.render().encode()
                + STORE.render().encode()
                + RESILIENCE.render().encode()
                + OVERLOAD.render().encode())
        return Response(body, content_type=PROMETHEUS_CONTENT_TYPE)

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
            try:
                pre = chain.preprocess(req)
            except ValueError as e:
                raise _ApiError(400, str(e)) from None
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

        return await self._run_endpoint(request, endpoint, run)

    def _fanout(self, req, chain, pre) -> list[AsyncIterator[LLMEngineOutput]]:
        """n>1: run n independent engine streams (distinct seeds per choice,
        like the reference's engines do for best-of/n sampling)."""
        n = max(1, req.n)
        return [chain.generate(_with_choice_seed(pre, i)) for i in range(n)]

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
        timing = _RequestTiming(self, t_start)

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
        timing = _RequestTiming(self, t_start)
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
        try:
            await resp.prepare(request)
            while live:
                i, item = await queue.get()
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
