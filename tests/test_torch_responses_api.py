"""The port's /v1/embeddings and /v1/responses against the JAX package's
aiohttp service on the echo chain: unary, streamed (the Responses API's
typed ``event:`` lines) and refused requests answer with the same
statuses and bodies (ids and timestamps aside); an engine without
``embed`` gets the same 400; the request counters move alike (embeddings
are not counted, responses are, under the endpoint label
``responses``); and the request types validate as the reference's
pydantic models do."""
import base64
import json
import struct

import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.engines import EchoEngine as REcho
from dynamo_tpu.protocols import openai as ropenai
from dynamo_tpu.protocols.sse import SseDecoder as RSseDecoder
from dynamo_tpu_torch.engines import EchoEngine as PEcho
from dynamo_tpu_torch.frontend.http import HttpClient
from dynamo_tpu_torch.protocols import openai as popenai
from dynamo_tpu_torch.protocols.sse import SseDecoder as PSseDecoder
from tests.test_torch_frontend import TEMPLATE, _manager, _Port, _Ref

EMB = "/v1/embeddings"
RESP = "/v1/responses"


def _strip(x):
    """Ids and creation times aside."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k not in ("id", "created", "created_at")}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


async def _call(svc, port, path, body):
    """(status, Content-Type, body): a JSON body, or for an SSE answer
    the list of (event, data) pairs."""
    if port:
        async with HttpClient("127.0.0.1", svc.svc.port) as c:
            raw = body if isinstance(body, bytes) else None
            r = await c.request("POST", path,
                                json_body=None if raw else body, body=raw,
                                stream=True)
            ctype = r.headers["Content-Type"]
            if not ctype.startswith("text/event-stream"):
                return r.status, ctype, json.loads(await r.read())
            dec, events = PSseDecoder(), []
            async for chunk in r.chunks():
                events.extend(dec.feed(chunk))
    else:
        kw = {"data": body} if isinstance(body, bytes) else {"json": body}
        r = await svc.client.request("POST", path, **kw)
        ctype = r.headers["Content-Type"]
        if not ctype.startswith("text/event-stream"):
            return r.status, ctype, await r.json()
        dec, events = RSseDecoder(), []
        async for chunk in r.content.iter_any():
            events.extend(dec.feed(chunk))
    return r.status, ctype, [[e.event, json.loads(e.data)] for e in events]


class _NoEmbed:
    """An engine with generate() and no embed()."""

    def __init__(self, engine):
        self.engine = engine

    async def generate(self, request):
        async for out in self.engine.generate(request):
            yield out


REQUESTS = [
    ("emb str", EMB, {"model": "echo", "input": "w1 w2 w3"}),
    ("emb batch", EMB, {"model": "echo", "input": ["w1 w2", "w3 w4 w5"]}),
    ("emb base64", EMB, {"model": "echo", "input": "w1 w2",
                         "encoding_format": "base64"}),
    ("emb ids", EMB, {"model": "echo", "input": [3, 4, 5]}),
    ("emb id lists", EMB, {"model": "echo", "input": [[3, 4], [5, 6, 7]]}),
    ("emb dimensions", EMB, {"model": "echo", "input": "w1 w2 w3",
                             "dimensions": 8}),
    ("emb unknown model", EMB, {"model": "nope", "input": "x"}),
    ("emb empty string", EMB, {"model": "echo", "input": ""}),
    ("emb empty list", EMB, {"model": "echo", "input": []}),
    ("emb empty id list", EMB, {"model": "echo", "input": [[]]}),
    ("emb bad format", EMB, {"model": "echo", "input": "w1",
                             "encoding_format": "hex"}),
    ("emb missing input", EMB, {"model": "echo"}),
    ("emb bad ids", EMB, {"model": "echo", "input": [1, "a"]}),
    ("emb invalid json", EMB, b"{nope"),
    ("resp unary", RESP, {"model": "echo", "input": "hello world",
                          "max_output_tokens": 2}),
    ("resp unary whole", RESP, {"model": "echo", "input": "w1 w2"}),
    ("resp messages", RESP, {
        "model": "echo", "instructions": "hello", "max_output_tokens": 2,
        "input": [{"type": "message", "role": "user",
                   "content": [{"type": "input_text", "text": "world"}]}]}),
    ("resp parts", RESP, {
        "model": "echo", "temperature": 0.5, "top_p": 0.9,
        "input": [{"role": "assistant", "content": [
            {"type": "output_text", "text": "w1 "},
            {"type": "text", "text": "w2"}]},
            {"content": "w3"}]}),
    ("resp stream", RESP, {"model": "echo", "input": "hello world",
                           "max_output_tokens": 2, "stream": True}),
    ("resp stream whole", RESP, {"model": "echo", "input": "w1 w2 w3",
                                 "stream": True, "store": True}),
    ("resp empty input", RESP, {"model": "echo", "input": ""}),
    ("resp empty list", RESP, {"model": "echo", "input": []}),
    ("resp chaining", RESP, {"model": "echo", "input": "x",
                             "previous_response_id": "resp_123"}),
    ("resp unknown model", RESP, {"model": "nope", "input": "x"}),
    ("resp max_output_tokens 0", RESP, {"model": "echo", "input": "x",
                                        "max_output_tokens": 0}),
    ("resp temperature", RESP, {"model": "echo", "input": "x",
                                "temperature": 3}),
    ("resp top_p", RESP, {"model": "echo", "input": "x", "top_p": 0}),
    ("resp item type", RESP, {"model": "echo", "input": [
        {"type": "function_call", "name": "f"}]}),
    ("resp part type", RESP, {"model": "echo", "input": [
        {"role": "user", "content": [{"type": "input_image",
                                      "image_url": "data:,"}]}]}),
    ("resp role", RESP, {"model": "echo", "input": [
        {"role": "bogus", "content": "x"}]}),
    ("resp content type", RESP, {"model": "echo", "input": [
        {"role": "user", "content": 5}]}),
    ("resp input items", RESP, {"model": "echo", "input": ["x"]}),
    ("resp user cap", RESP, {"model": "echo", "input": "x",
                             "user": "u" * 300}),
    ("resp missing model", RESP, {"input": "x"}),
    ("resp invalid json", RESP, b"[1,"),
]


@pytest.mark.parametrize("label,path,body", REQUESTS,
                         ids=[r[0] for r in REQUESTS])
async def test_echo_routes_match_reference(label, path, body):
    out = []
    for port, svc_cls in ((True, _Port), (False, _Ref)):
        engine = (PEcho if port else REcho)(delay_s=0.0)
        async with svc_cls(_manager(port, "echo", engine, TEMPLATE)) as s:
            out.append(await _call(s, port, path, body))
    (ps, pt, pb), (rs, rt, rb) = out
    assert ps == rs, (pb, rb)
    assert pt.split(";")[0] == rt.split(";")[0]
    assert _strip(pb) == _strip(rb)
    if isinstance(pb, list):     # an SSE answer: every event is typed
        assert [e for e, _ in pb][0] == "response.created"
        assert all(e == d["type"] for e, d in pb)
    if label == "emb base64":
        v = struct.unpack("<16f", base64.b64decode(
            pb["data"][0]["embedding"]))
        assert abs(sum(x * x for x in v) - 1.0) < 1e-5


@pytest.mark.parametrize("path,body", [
    (EMB, {"model": "echo", "input": "w1"}),
    (RESP, {"model": "echo", "input": "w1", "max_output_tokens": 1}),
], ids=["embeddings", "responses"])
async def test_engine_without_embed_matches_reference(path, body):
    """/v1/embeddings answers 400 for an engine without ``embed``; the
    Responses API does not need it."""
    out = []
    for port, svc_cls in ((True, _Port), (False, _Ref)):
        engine = _NoEmbed((PEcho if port else REcho)(delay_s=0.0))
        async with svc_cls(_manager(port, "echo", engine, TEMPLATE)) as s:
            out.append(await _call(s, port, path, body))
    (ps, _, pb), (rs, _, rb) = out
    assert ps == rs == (400 if path == EMB else 200)
    assert _strip(pb) == _strip(rb)


async def _request_samples(svc, port):
    if port:
        async with HttpClient("127.0.0.1", svc.svc.port) as c:
            text = (await c.request("GET", "/metrics")).body.decode()
    else:
        text = await (await svc.client.request("GET", "/metrics")).text()
    fams = {f.name: f for f in text_string_to_metric_families(text)}
    return sorted((s.labels["model"], s.labels["endpoint"],
                   s.labels["status"], s.value)
                  for s in fams["dynamo_http_service_requests"].samples
                  if s.name == "dynamo_http_service_requests_total")


async def test_request_counters_match_reference():
    """Embeddings requests are not counted in requests_total (as in the
    reference); responses requests are, with their statuses."""
    out = []
    for port, svc_cls in ((True, _Port), (False, _Ref)):
        engine = (PEcho if port else REcho)(delay_s=0.0)
        async with svc_cls(_manager(port, "echo", engine, TEMPLATE)) as s:
            for _, path, body in REQUESTS:
                await _call(s, port, path, body)
            out.append(await _request_samples(s, port))
    assert out[0] == out[1]
    assert not any(ep == "embeddings" for _, ep, _, _ in out[0])
    assert ("echo", "responses", "200", 6.0) in out[0]


@pytest.mark.parametrize("cls,body", [
    ("EmbeddingRequest", {"model": "m", "input": "x", "dimensions": "4",
                          "user": "u"}),
    ("EmbeddingRequest", {"model": "m", "input": [[1, 2], [3]],
                          "encoding_format": "base64"}),
    ("EmbeddingRequest", {"model": "m", "input": [1.0, 2]}),
    ("EmbeddingRequest", {"model": "m", "input": {"a": 1}}),
    ("EmbeddingRequest", {"model": "m", "input": "x", "dimensions": 1.5}),
    ("ResponsesRequest", {"model": "m", "input": "x", "stream": "yes",
                          "max_output_tokens": "3", "metadata": {"k": 1}}),
    ("ResponsesRequest", {"model": "m", "input": "x", "metadata": [1]}),
    ("ResponsesRequest", {"model": "m", "input": [{"content": "a"}],
                          "instructions": "sys", "temperature": 2}),
    ("ResponsesRequest", {"model": "m", "input": "x", "top_p": 1.5}),
    ("ResponsesRequest", {"model": "m", "input": "x",
                          "max_output_tokens": 2_000_000}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_request_types_validate_as_reference(cls, body):
    """Each body gives the same fields (and the chat request they lower
    to), or the same first error message, in both packages."""
    def run(mod):
        try:
            req = getattr(mod, cls).from_dict(body) if mod is popenai \
                else getattr(mod, cls)(**body)
        except ValueError as e:
            return "error", (e.msg if mod is popenai
                             else e.errors()[0]["msg"])
        fields = {k: getattr(req, k) for k in body}
        if cls != "ResponsesRequest":
            return "ok", fields
        try:
            chat = req.to_chat()
        except ValueError as e:
            return "chat error", (e.msg if mod is popenai
                                  else e.errors()[0]["msg"])
        return "ok", fields, [(m.role, m.content) for m in chat.messages], (
            chat.max_tokens, chat.temperature, chat.top_p, chat.stream)

    assert run(popenai) == run(ropenai)


def test_response_builders_match_reference():
    for kw in (dict(status="completed"), dict(status="in_progress"),
               dict(status="incomplete",
                    incomplete_reason="max_output_tokens")):
        args = dict(rid="resp-1", model="m", text="hi", prompt_tokens=3,
                    completion_tokens=2, created=7, **kw)
        assert _strip(popenai.responses_response(**args)) == _strip(
            ropenai.responses_response(**args))
    vecs = [[0.25, -1.5, 3.0], [1e-3, 2.0, 0.0]]
    for fmt in ("float", "base64"):
        assert popenai.embedding_response("m", vecs, 5, fmt) == \
            ropenai.embedding_response("m", vecs, 5, fmt)
