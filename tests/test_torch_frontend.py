"""The port's OpenAI HTTP service (dynamo_tpu_torch/frontend/) against the
JAX package's aiohttp service: over EchoEngine both answer the same
requests with the same statuses and bodies on every route; the port's
/metrics parses as Prometheus text; a client that goes away mid-stream
leaves no engine request behind; and the slice as a whole — the
reference HttpService(TpuEngine) and the port's HttpService(TorchEngine
on the CPU), ModelConfig.tiny in f32 with the same weights and the test
tokenizer — gives the same texts, finish reasons and usage, unary and
streamed, with logprobs within 1e-4."""
import asyncio
import math

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.backend import Backend as RBackend
from dynamo_tpu.engines import EchoEngine as REcho
from dynamo_tpu.frontend import HttpService as RService
from dynamo_tpu.frontend import ModelChain as RChain
from dynamo_tpu.frontend import ModelManager as RManager
from dynamo_tpu.preprocessor import OpenAIPreprocessor as RPre
from dynamo_tpu.preprocessor import PromptFormatter as RFormatter
from dynamo_tpu.protocols.sse import SseDecoder as RSseDecoder
from dynamo_tpu.tokenizer import make_test_tokenizer as r_tokenizer
from dynamo_tpu_torch.backend import Backend as PBackend
from dynamo_tpu_torch.engines import EchoEngine as PEcho
from dynamo_tpu_torch.frontend.http import HttpClient
from dynamo_tpu_torch.frontend.model_manager import ModelChain as PChain
from dynamo_tpu_torch.frontend.model_manager import ModelManager as PManager
from dynamo_tpu_torch.frontend.service import HttpService as PService
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor as PPre
from dynamo_tpu_torch.preprocessor import PromptFormatter as PFormatter
from dynamo_tpu_torch.protocols.sse import SseDecoder as PSseDecoder
from dynamo_tpu_torch.tokenizer import make_test_tokenizer as p_tokenizer

WORDS = [f"w{i}" for i in range(50)] + ["hello", "world", "STOP"]
TEMPLATE = "{% for m in messages %}{{ m.content }} {% endfor %}"


def _manager(port: bool, name: str, engine, template=None):
    tok = (p_tokenizer if port else r_tokenizer)(WORDS)
    kw = {"template": template} if template else {}
    fmt = (PFormatter if port else RFormatter)(**kw)
    chain = (PChain if port else RChain)(
        name=name,
        preprocessor=(PPre if port else RPre)(
            tokenizer=tok, formatter=fmt, model_name=name),
        engine=engine, backend=(PBackend if port else RBackend)(tok))
    m = (PManager if port else RManager)()
    m.register(chain)
    return m


class _Port:
    """The port's service on a free port, driven by the port's client."""

    def __init__(self, manager):
        self.svc = PService(manager, host="127.0.0.1", port=0)

    async def __aenter__(self):
        await self.svc.start()
        return self

    async def __aexit__(self, *exc):
        await self.svc.stop()

    async def call(self, method, path, body=None, stream=False,
                   headers=None):
        async with HttpClient("127.0.0.1", self.svc.port) as c:
            r = await c.request(method, path, json_body=body,
                                headers=headers, stream=stream)
            if not stream or r.status != 200:
                await r.read() if stream else None
                return r.status, r.headers, r.json()
            dec, events = PSseDecoder(), []
            async for chunk in r.chunks():
                events.extend(dec.feed(chunk))
            return r.status, r.headers, [e.data for e in events]


class _Ref:
    """The reference aiohttp service through aiohttp's test client."""

    def __init__(self, manager):
        self.client = TestClient(TestServer(RService(manager).app))

    async def __aenter__(self):
        await self.client.start_server()
        return self

    async def __aexit__(self, *exc):
        await self.client.close()

    async def call(self, method, path, body=None, stream=False,
                   headers=None):
        r = await self.client.request(method, path, json=body,
                                      headers=headers)
        if not stream or r.status != 200:
            return r.status, r.headers, await r.json()
        dec, events = RSseDecoder(), []
        async for chunk in r.content.iter_any():
            events.extend(dec.feed(chunk))
        return r.status, r.headers, [e.data for e in events]


def _strip(x):
    """Ids, creation times and uptimes aside."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k not in ("id", "created", "uptime_s")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    if isinstance(x, str) and x.startswith("{"):
        import json
        return _strip(json.loads(x))
    return x


def _assert_close(got, want, tol=1e-4, where="body"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _assert_close(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert math.isclose(got, want, rel_tol=0, abs_tol=tol), \
            f"{where}: {got} != {want}"
    else:
        assert got == want, f"{where}: {got!r} != {want!r}"


CHAT = "/v1/chat/completions"
COMPL = "/v1/completions"
ECHO_REQUESTS = [
    ("chat unary", "POST", CHAT, {"model": "echo", "messages": [
        {"role": "user", "content": "hello world"}], "max_tokens": 2}),
    ("chat stream usage", "POST", CHAT, {
        "model": "echo", "stream": True,
        "stream_options": {"include_usage": True},
        "messages": [{"role": "system", "content": "w1"},
                     {"role": "user", "content": "hello world"}]}),
    ("completion unary n=2", "POST", COMPL, {
        "model": "echo", "prompt": "w1 w2 w3", "n": 2, "max_tokens": 3}),
    ("completion stream n=2", "POST", COMPL, {
        "model": "echo", "prompt": [5, 6, 7], "n": 2, "stream": True}),
    ("stop string unary", "POST", COMPL, {
        "model": "echo", "prompt": "hello world STOP w1", "stop": "STOP"}),
    ("stop string stream", "POST", CHAT, {
        "model": "echo", "stream": True, "stop": ["world"],
        "messages": [{"role": "user", "content": "hello world w1"}]}),
    ("logprobs on an engine without them", "POST", COMPL, {
        "model": "echo", "prompt": "w1", "logprobs": 2}),
    ("unknown model", "POST", CHAT, {
        "model": "nope", "messages": [{"role": "user", "content": "x"}]}),
    ("invalid body", "POST", CHAT, {"model": "echo", "messages": []}),
    ("invalid field", "POST", COMPL, {
        "model": "echo", "prompt": "w1", "temperature": 3}),
    ("missing field", "POST", COMPL, {"model": "echo"}),
    ("preprocess error", "POST", COMPL, {
        "model": "echo", "prompt": ["w1", "w2"]}),
    ("models", "GET", "/v1/models", None),
    ("health", "GET", "/health", None),
    ("live", "GET", "/live", None),
    ("flight", "GET", "/debug/flight", None),
]


@pytest.mark.parametrize("label,method,path,body", ECHO_REQUESTS,
                         ids=[r[0] for r in ECHO_REQUESTS])
async def test_echo_service_matches_reference(label, method, path, body):
    stream = bool(body and body.get("stream"))
    out = []
    for port, svc_cls in ((True, _Port), (False, _Ref)):
        engine = (PEcho if port else REcho)(delay_s=0.0)
        async with svc_cls(_manager(port, "echo", engine, TEMPLATE)) as s:
            out.append(await s.call(method, path, body, stream=stream))
    (ps, ph, pb), (rs, rh, rb) = out
    assert ps == rs
    assert ph["Content-Type"] == rh["Content-Type"]
    assert _strip(pb) == _strip(rb)
    if path in (CHAT, COMPL) and ps == 200:
        assert ph.get("X-Request-Id")
        if stream:
            assert ph["Content-Type"].startswith("text/event-stream")
            assert pb[-1] == "[DONE]"


async def _scrape(svc, port, headers):
    """(Content-Type, sample names) of one /metrics scrape."""
    if port:
        async with HttpClient("127.0.0.1", svc.svc.port) as c:
            r = await c.request("GET", "/metrics", headers=headers)
            ctype, text = r.headers["Content-Type"], r.body.decode()
    else:
        r = await svc.client.request("GET", "/metrics", headers=headers)
        ctype, text = r.headers["Content-Type"], await r.text()
    if "# EOF" in text:
        # OpenMetrics: the exemplars aside, the same sample lines
        text = "\n".join(line.split(" # ")[0]
                         for line in text.splitlines() if line != "# EOF")
    names = {s.name for f in text_string_to_metric_families(text)
             for s in f.samples}
    return ctype, names


@pytest.mark.parametrize("accept", [None, "application/openmetrics-text"],
                         ids=["plain", "openmetrics"])
async def test_echo_metrics_match_reference(accept):
    """After the same requests, both /metrics answers carry the same
    Content-Type and the same sample names (prometheus_client's
    ``_created`` samples and the planner's ``dynamo_planner_*`` families
    included)."""
    headers = {"Accept": accept} if accept else None
    out = []
    for port, svc_cls in ((True, _Port), (False, _Ref)):
        engine = (PEcho if port else REcho)(delay_s=0.0)
        async with svc_cls(_manager(port, "echo", engine, TEMPLATE)) as s:
            for _, method, path, body in ECHO_REQUESTS[:3]:
                await s.call(method, path, body,
                             stream=bool(body.get("stream")))
            out.append(await _scrape(s, port, headers))
    (pt, pn), (rt, rn) = out
    assert pt == rt
    assert "dynamo_planner_replicas" in rn
    assert "dynamo_http_service_requests_created" in rn
    assert "dynamo_http_service_request_duration_seconds_created" in rn
    assert pn == rn


@pytest.mark.parametrize("accept", [None, "application/openmetrics-text"],
                         ids=["plain", "openmetrics"])
async def test_system_server_metrics_header_matches_reference(accept):
    """A worker's system server answers /metrics with the reference's
    Content-Type (``text/plain; charset=utf-8`` in plain text) and the
    same metric families, the planner's included. The fleet-merged
    request histograms render only while some worker of this process fed
    the feed in the last 10 s, so they may differ by what ran before."""
    from dynamo_tpu.runtime.system_server import SystemServer as RSystem
    from dynamo_tpu_torch.runtime.system_server import SystemServer as PSystem

    headers = {"Accept": accept} if accept else None
    out = []
    for cls in (PSystem, RSystem):
        srv = await cls(None, host="127.0.0.1", port=0,
                        worker_id="w1").start()
        try:
            async with HttpClient("127.0.0.1", srv.port) as c:
                r = await c.request("GET", "/metrics", headers=headers)
                text = r.body.decode()
        finally:
            await srv.stop()
        if "# EOF" in text:
            text = "\n".join(line.split(" # ")[0] for line in
                             text.splitlines() if line != "# EOF")
        out.append((r.headers["Content-Type"],
                    {f.name for f in text_string_to_metric_families(text)}))
    (pt, pn), (rt, rn) = out
    assert pt == rt
    assert rt == ("application/openmetrics-text; charset=utf-8" if accept
                  else "text/plain; charset=utf-8")
    assert "dynamo_planner_replicas" in rn and "dynamo_planner_replicas" in pn
    assert all(n.startswith("dynamo_fleet_request_") for n in pn ^ rn)


async def test_invalid_json_and_routes():
    async with _Port(_manager(True, "echo", PEcho(delay_s=0.0))) as s:
        async with HttpClient("127.0.0.1", s.svc.port) as c:
            r = await c.request("POST", CHAT, body=b"{not json")
            assert r.status == 400
            assert r.json()["error"]["message"] == "invalid JSON body"
            r = await c.request("GET", "/nope")
            assert r.status == 404 and r.json()["error"]["code"] == 404
            r = await c.request("GET", CHAT)
            assert r.status == 405


async def test_metrics_parse_as_prometheus_text():
    async with _Port(_manager(True, "echo", PEcho(delay_s=0.001))) as s:
        for body in ECHO_REQUESTS[:4] + ECHO_REQUESTS[7:9]:
            await s.call(body[1], body[2], body[3],
                         stream=bool(body[3].get("stream")))
        status, headers, _ = await s.call("GET", "/health")
        async with HttpClient("127.0.0.1", s.svc.port) as c:
            r = await c.request("GET", "/metrics")
    assert r.status == 200 and r.headers["Content-Type"].startswith(
        "text/plain")
    fams = {f.name: f for f in text_string_to_metric_families(
        r.body.decode())}
    reqs = {(s.labels["model"], s.labels["endpoint"], s.labels["status"]):
            s.value for s in fams["dynamo_http_service_requests"].samples}
    assert reqs[("echo", "chat_completions", "200")] == 2
    assert reqs[("echo", "completions", "200")] == 2
    assert reqs[("nope", "chat_completions", "404")] == 1
    # a body refused before its model is read counts under model ""
    assert reqs[("", "chat_completions", "400")] == 1
    assert fams["dynamo_http_service_inflight_requests"].type == "gauge"
    assert all(s.value == 0 for s in
               fams["dynamo_http_service_inflight_requests"].samples)
    dur = fams["dynamo_http_service_request_duration_seconds"]
    assert dur.type == "histogram"
    assert {s.labels["le"] for s in dur.samples
            if s.name.endswith("_bucket")} >= {"0.005", "10.0", "+Inf"}
    for name in ("dynamo_request_ttft_seconds", "dynamo_request_itl_seconds",
                 "dynamo_request_e2e_seconds"):
        count = [s.value for s in fams[name].samples
                 if s.name == name + "_count"]
        assert fams[name].type == "histogram" and count[0] > 0, name


class _Counting:
    """An engine wrapper that counts its live generate() streams."""

    def __init__(self, engine):
        self.engine = engine
        self.live = 0
        self.started = 0

    async def generate(self, request):
        self.live += 1
        self.started += 1
        try:
            async for out in self.engine.generate(request):
                yield out
        finally:
            self.live -= 1


async def test_client_disconnect_mid_stream_leaves_no_request():
    engine = _Counting(PEcho(delay_s=0.01))
    async with _Port(_manager(True, "echo", engine)) as s:
        c = HttpClient("127.0.0.1", s.svc.port)
        r = await c.request("POST", COMPL, json_body={
            "model": "echo", "prompt": "w1 w2", "max_tokens": 10_000,
            "stream": True, "n": 2}, stream=True)
        assert r.status == 200
        first = await r.chunks().__anext__()
        assert first.startswith(b"data: ")
        assert engine.live == 2
        await c.close()
        for _ in range(500):
            if engine.live == 0:
                break
            await asyncio.sleep(0.01)
        assert engine.live == 0 and engine.started == 2
        metrics = s.svc.metrics.render().decode()
        assert 'status="499"' in metrics
        assert 'dynamo_http_service_inflight_requests{model="echo"} 0.0' \
            in metrics


async def test_keep_alive_chunked_body_and_expect_continue():
    async with _Port(_manager(True, "echo", PEcho(delay_s=0.0))) as s:
        async with HttpClient("127.0.0.1", s.svc.port) as c:
            await c.request("GET", "/health")
            writer = c._writer
            r = await c.request("POST", COMPL, json_body={
                "model": "echo", "prompt": "w1", "max_tokens": 1})
            assert r.status == 200 and c._writer is writer  # one connection
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       s.svc.port)
        body = b'{"model": "echo", "prompt": "w1 w2", "max_tokens": 2}'
        writer.write(
            b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
            b"Transfer-Encoding: chunked\r\nExpect: 100-continue\r\n"
            b"Connection: close\r\n\r\n")
        await writer.drain()
        assert await reader.readuntil(b"\r\n\r\n") == \
            b"HTTP/1.1 100 Continue\r\n\r\n"
        writer.write(b"%x\r\n%s\r\n%x\r\n%s\r\n0\r\n\r\n" % (
            10, body[:10], len(body) - 10, body[10:]))
        await writer.drain()
        raw = await reader.read()  # the server closes: Connection: close
        writer.close()
        head, _, payload = raw.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200 OK")
        assert b"Connection: close" in head
        assert b'"text": " w1 w2"' in payload
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       s.svc.port)
        writer.write(b"garbage\r\n\r\n")
        raw = await reader.read()
        writer.close()
        assert raw.startswith(b"HTTP/1.1 400 Bad Request")


# ---------------------------------------------------------------------------
# the slice: HttpService over TpuEngine and over TorchEngine on the CPU

ENGINE_KW = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                 max_decode_slots=4, prefill_buckets=(32, 64),
                 cache_dtype="float32")


@pytest.fixture(scope="module")
def tiny_managers():
    from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
    from dynamo_tpu.engine.engine import TpuEngine
    from dynamo_tpu.models import llama as jl
    from dynamo_tpu.models.config import ModelConfig as JConfig
    from dynamo_tpu.parallel.mesh import MeshConfig
    from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig as TConfig
    from dynamo_tpu_torch.models.llama import params_from_jax

    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    ref = TpuEngine(JConfig.tiny(dtype="float32"), JEngineConfig(**ENGINE_KW),
                    params=jparams, mesh_config=MeshConfig(tp=1))
    port = TorchEngine(
        TConfig.tiny(dtype="float32"), TEngineConfig(**ENGINE_KW),
        params=params_from_jax(jax.tree.map(np.asarray, jparams),
                               device="cpu"),
        device="cpu")
    yield _manager(True, "tiny", port), _manager(False, "tiny", ref)
    asyncio.run(port.stop())
    asyncio.run(ref.stop())


SLICE_REQUESTS = [
    ("chat unary", CHAT, {"model": "tiny", "max_tokens": 6, "messages": [
        {"role": "user", "content": "hello world w1 w2"}]}),
    ("chat stream", CHAT, {"model": "tiny", "max_tokens": 6, "stream": True,
                           "stream_options": {"include_usage": True},
                           "messages": [{"role": "system", "content": "w3"},
                                        {"role": "user", "content": "w4"}]}),
    ("completion token ids", COMPL, {"model": "tiny", "max_tokens": 8,
                                     "prompt": list(range(5, 40))}),
    ("completion token ids stream", COMPL, {
        "model": "tiny", "max_tokens": 8, "stream": True,
        "prompt": list(range(40, 60)),
        "stream_options": {"include_usage": True}}),
    ("completion logprobs 2", COMPL, {"model": "tiny", "max_tokens": 5,
                                      "prompt": "w5 w6 w7", "logprobs": 2}),
    ("chat logprobs stream", CHAT, {
        "model": "tiny", "max_tokens": 5, "stream": True, "logprobs": True,
        "top_logprobs": 2,
        "messages": [{"role": "user", "content": "w8 w9"}]}),
]


def _joined(events: list) -> dict:
    """A stream's chunks folded: text per choice, finish reasons, usage,
    logprob entries."""
    import json
    out = {"text": {}, "finish": {}, "usage": None, "lp": {},
           "done": events[-1] == "[DONE]"}
    for e in events[:-1]:
        ch = json.loads(e)
        out["usage"] = ch.get("usage", out["usage"])
        for c in ch["choices"]:
            i = c["index"]
            piece = c["delta"].get("content") if "delta" in c else c["text"]
            out["text"][i] = out["text"].get(i, "") + (piece or "")
            if c["finish_reason"]:
                out["finish"][i] = c["finish_reason"]
            if c.get("logprobs"):
                out["lp"].setdefault(i, []).append(c["logprobs"])
    return out


@pytest.mark.parametrize("label,path,body", SLICE_REQUESTS,
                         ids=[r[0] for r in SLICE_REQUESTS])
async def test_slice_port_service_matches_reference(tiny_managers, label,
                                                    path, body):
    port_mgr, ref_mgr = tiny_managers
    stream = bool(body.get("stream"))
    async with _Port(port_mgr) as p:
        ps, _, pb = await p.call("POST", path, body, stream=stream)
    async with _Ref(ref_mgr) as r:
        rs, _, rb = await r.call("POST", path, body, stream=stream)
    assert ps == rs == 200
    if stream:
        pj, rj = _joined(pb), _joined(rb)
        assert pj["done"] and rj["done"]
        _assert_close(pj, rj)
        assert pj["finish"]
        assert (pj["usage"] is not None) == ("stream_options" in body)
    else:
        _assert_close(_strip(pb), _strip(rb))
        assert pb["usage"]["completion_tokens"] > 0
    if body.get("logprobs"):
        assert "top_logprobs" in str(pb)


async def test_slice_disconnect_frees_the_torch_engine_slot(tiny_managers):
    port_mgr, _ = tiny_managers
    eng = port_mgr.get("tiny").engine
    async with _Port(port_mgr) as s:
        c = HttpClient("127.0.0.1", s.svc.port)
        r = await c.request("POST", COMPL, json_body={
            "model": "tiny", "prompt": list(range(5, 20)), "max_tokens": 100,
            "stream": True, "nvext": {"ignore_eos": True}}, stream=True)
        assert r.status == 200
        await r.chunks().__anext__()
        assert eng._slot_active.any()
        steps = eng.step_count
        await c.close()
        for _ in range(1000):
            if not (eng._slot_active.any() or eng._waiting
                    or eng._prefilling):
                break
            await asyncio.sleep(0.01)
        assert not eng._slot_active.any()
        assert not eng._waiting and not eng._prefilling
        # freed by the cancel within a few rounds, not after the ~100
        # steps the request had left
        assert eng.step_count - steps < 40
