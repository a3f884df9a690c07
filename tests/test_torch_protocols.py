"""The port's OpenAI protocol layer (dynamo_tpu_torch/protocols/) against
the JAX package's: request validation (dataclasses on the standard
library against the pydantic models) accepts and refuses the same bodies
with the same first error, fills in the same values and gives the same
sampling, stop and output options; the response builders, DeltaGenerator
chunks, the SSE codec and aggregate_chunks agree."""
import dataclasses
import math

import pydantic
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.protocols import aggregator as ragg
from dynamo_tpu.protocols import common as rcommon
from dynamo_tpu.protocols import openai as ropenai
from dynamo_tpu.protocols import sse as rsse
from dynamo_tpu_torch.protocols import aggregator as pagg
from dynamo_tpu_torch.protocols import common as pcommon
from dynamo_tpu_torch.protocols import openai as popenai
from dynamo_tpu_torch.protocols import sse as psse

DEL = object()  # a patch value that removes the key


def _norm(x):
    """Plain data with each scalar's type kept (True != 1 here)."""
    if isinstance(x, pydantic.BaseModel):
        return {k: _norm(v) for k, v in x}
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, float) and math.isnan(x):
        return ("float", "nan")
    return (type(x).__name__, x)


def _validate(chat: bool, body):
    """(reference outcome, port outcome): ("ok", fields, sampling, stop,
    output) or ("err", first message)."""
    rcls = ropenai.ChatCompletionRequest if chat else ropenai.CompletionRequest
    pcls = popenai.ChatCompletionRequest if chat else popenai.CompletionRequest
    out = []
    for cls, err, build in ((rcls, pydantic.ValidationError,
                             lambda b: rcls(**b)),
                            (pcls, popenai.ValidationError, pcls.from_dict)):
        try:
            req = build(body)
        except err as e:
            out.append(("err", e.errors()[0]["msg"] if err is
                        pydantic.ValidationError else e.msg))
            continue
        out.append(("ok", _norm(req), _norm(req.to_sampling()),
                    _norm(req.to_stop_conditions(16)),
                    _norm(req.to_output_options())))
    return out


CHAT = {"model": "m", "messages": [{"role": "user", "content": "hi"}]}
COMPLETION = {"model": "m", "prompt": "hi"}

# (label, chat?, patch of the base body)
CASES = [
    ("base chat", True, {}),
    ("base completion", False, {}),
    ("missing model", True, {"model": DEL}),
    ("model not a string", True, {"model": 5}),
    ("missing messages", True, {"messages": DEL}),
    ("empty messages", True, {"messages": []}),
    ("unknown role", True, {"messages": [{"role": "bot", "content": "x"}]}),
    ("message without role", True, {"messages": [{"content": "x"}]}),
    ("content parts", True, {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "a"}]}]}),
    ("content part not a dict", True,
     {"messages": [{"role": "user", "content": ["a"]}]}),
    ("content None, extra key", True,
     {"messages": [{"role": "user", "content": None, "extra": 1}]}),
    ("unknown top-level key", True, {"frobnicate": 1}),
    ("stream as 'yes'", True, {"stream": "yes"}),
    ("stream as 2", True, {"stream": 2}),
    ("stream None", True, {"stream": None}),
    ("max_tokens float", True, {"max_tokens": 5.0}),
    ("max_tokens fractional", True, {"max_tokens": 5.5}),
    ("max_tokens string", True, {"max_tokens": " 7 "}),
    ("max_tokens 0", True, {"max_tokens": 0}),
    ("max_tokens over the cap", True, {"max_tokens": 10**7}),
    ("max_completion_tokens wins", True,
     {"max_tokens": 3, "max_completion_tokens": 9}),
    ("temperature int", True, {"temperature": 1}),
    ("temperature True", True, {"temperature": True}),
    ("temperature string", True, {"temperature": "0.5"}),
    ("temperature above 2", True, {"temperature": 2.5}),
    ("temperature nan", True, {"temperature": float("nan")}),
    ("top_p 0", True, {"top_p": 0}),
    ("top_k -1 and -2", True, {"top_k": -2}),
    ("penalties at the bounds", True,
     {"frequency_penalty": -2, "presence_penalty": 2,
      "repetition_penalty": 0.5}),
    ("repetition_penalty 0", True, {"repetition_penalty": 0}),
    ("stop string", True, {"stop": "END"}),
    ("stop list", True, {"stop": ["a", "b"]}),
    ("stop empty string", True, {"stop": ""}),
    ("stop nine", True, {"stop": ["a"] * 9}),
    ("stop too long", True, {"stop": "x" * 257}),
    ("stop not strings", True, {"stop": ["a", 5]}),
    ("seed", True, {"seed": 7}),
    ("seed negative", True, {"seed": -1}),
    ("seed 2^63", True, {"seed": 2**63}),
    ("seed string", True, {"seed": "7"}),
    ("n 2", True, {"n": 2}),
    ("n 9", True, {"n": 9}),
    ("n None", True, {"n": None}),
    ("logprobs True with top_logprobs", True,
     {"logprobs": True, "top_logprobs": 3}),
    ("logprobs True alone", True, {"logprobs": True}),
    ("logprobs int", False, {"logprobs": 2}),
    ("logprobs 1.0", True, {"logprobs": 1.0}),
    ("logprobs '2'", True, {"logprobs": "2"}),
    ("logprobs 2.5", True, {"logprobs": 2.5}),
    ("top_logprobs 21", True, {"top_logprobs": 21}),
    ("nvext ignore_eos", True, {"nvext": {"ignore_eos": True}}),
    ("nvext not a dict", True, {"nvext": ["x"]}),
    ("stream_options", True,
     {"stream": True, "stream_options": {"include_usage": True}}),
    ("stream_options bad", True, {"stream_options": "a"}),
    ("user too long", True, {"user": "x" * 257}),
    ("tools and tool_choice", True,
     {"tools": [{"type": "function"}], "tool_choice": "auto"}),
    ("chat_template_args not a dict", True, {"chat_template_args": "x"}),
    ("prompt token ids", False, {"prompt": [5, 6, 7]}),
    ("prompt token ids as floats", False, {"prompt": [1.0, 2]}),
    ("prompt mixed strings and ids", False, {"prompt": ["1", 2]}),
    ("prompt nested ids", False, {"prompt": [[1, 2]]}),
    ("prompt empty", False, {"prompt": ""}),
    ("prompt empty list", False, {"prompt": []}),
    ("prompt id out of range", False, {"prompt": [2**32]}),
    ("prompt None", False, {"prompt": None}),
    ("prompt list of strings", False, {"prompt": ["a", "b"]}),
    ("best_of 9", False, {"best_of": 9}),
    ("echo 'on'", False, {"echo": "on"}),
]


@pytest.mark.parametrize("label,chat,patch", CASES,
                         ids=[c[0] for c in CASES])
def test_request_validation_matches_pydantic(label, chat, patch):
    body = dict(CHAT if chat else COMPLETION)
    for k, v in patch.items():
        if v is DEL:
            body.pop(k, None)
        else:
            body[k] = v
    ref, port = _validate(chat, body)
    assert port == ref


_VALUES = st.sampled_from([
    None, True, False, 0, 1, 2, -1, 0.0, 0.5, 1.0, 2.0, 2.5, 21, "1", "0",
    "2", "true", "off", "abc", "", " 3 ", "1.5", "1e3", "inf", "nan",
    float("nan"), float("inf"), [], ["a"], ["a", ""], [1, 2], [[1]],
    [True], {"a": 1}, {}, {"ignore_eos": True}, {"include_usage": "yes"},
    10**7, 2**63, 1e20, "x" * 257, [{"role": "user", "content": "hi"}],
    [{"role": "bot"}], [-1], [1.0, 2], ["1", 2],
])


@settings(max_examples=300, deadline=None)
@given(chat=st.booleans(), data=st.data())
def test_request_validation_matches_pydantic_on_random_bodies(chat, data):
    cls = popenai.ChatCompletionRequest if chat else popenai.CompletionRequest
    names = [f.name for f in dataclasses.fields(cls)]
    body = dict(CHAT if chat else COMPLETION)
    for name in data.draw(st.lists(st.sampled_from(names), max_size=3)):
        body[name] = data.draw(_VALUES)
    ref, port = _validate(chat, body)
    assert port == ref


def test_non_dict_body_is_refused():
    with pytest.raises(popenai.ValidationError, match="valid dictionary"):
        popenai.ChatCompletionRequest.from_dict(["not", "a", "dict"])


def _strip_ids(x):
    if isinstance(x, dict):
        return {k: _strip_ids(v) for k, v in x.items()
                if k not in ("id", "created")}
    if isinstance(x, list):
        return [_strip_ids(v) for v in x]
    return x


ENTRIES = [
    {"token": "w1", "logprob": -0.5, "bytes": [119, 49],
     "top_logprobs": [{"token": "w1", "logprob": -0.5, "bytes": [119, 49]},
                      {"token": "w2", "logprob": -1.5, "bytes": [119, 50]}]},
    {"token": "x", "logprob": -0.25, "bytes": [120]},
]


@pytest.mark.parametrize("builder", [
    "chat_completion_response", "completion_response"])
def test_response_builders_match(builder):
    kw = dict(rid="r1", model="m", created=5, prompt_tokens=3,
              completion_tokens=4,
              choices=[{"index": 0, "text": "a", "finish_reason": "stop"}])
    assert getattr(popenai, builder)(**kw) == getattr(ropenai, builder)(**kw)
    assert _strip_ids(popenai.model_list_response(["a", "b"])) == \
        _strip_ids(ropenai.model_list_response(["a", "b"]))
    assert popenai.completion_logprobs(ENTRIES) == \
        ropenai.completion_logprobs(ENTRIES)
    assert popenai.make_id("cmpl").startswith("cmpl-")


@pytest.mark.parametrize("chat", [True, False])
def test_delta_generator_chunks_match(chat):
    chunks = {}
    for mod, common in ((popenai, pcommon), (ropenai, rcommon)):
        g = mod.DeltaGenerator("m", chat=chat, n=2)
        chunks[mod] = [
            g.text_chunk("a", index=0),
            g.text_chunk("b", index=1, logprob_entries=ENTRIES),
            g.text_chunk("c", index=0, logprob_entries=ENTRIES[:1]),
            g.finish_chunk(common.FinishReason.LENGTH, index=1),
            g.finish_chunk(common.FinishReason.EOS, index=0),
            g.usage_chunk(3, 4),
        ]
    assert _strip_ids(chunks[popenai]) == _strip_ids(chunks[ropenai])


@pytest.mark.parametrize("payload", [
    {"a": 1, "b": [1, "x\ny"]}, "[DONE]", {"unicode": "é≈"}])
def test_sse_round_trip_between_packages(payload):
    for enc, dec in ((psse, rsse), (rsse, psse)):
        raw = enc.encode_event(payload, event="e") + enc.encode_done() \
            + enc.encode_comment("c")
        assert raw == dec.encode_event(payload, event="e") \
            + dec.encode_done() + dec.encode_comment("c")
        d = dec.SseDecoder()
        events = []
        for i in range(0, len(raw), 3):  # split across feeds
            events.extend(d.feed(raw[i:i + 3]))
        assert [(e.data, e.event) for e in events] == [
            (payload if isinstance(payload, str) else
             enc.encode_event(payload).decode()[6:-2], "e"),
            ("[DONE]", None)]
        assert events[1].is_done


@pytest.mark.parametrize("chat", [True, False])
def test_aggregate_chunks_match(chat):
    g = popenai.DeltaGenerator("m", chat=chat, n=2)
    chunks = [g.text_chunk("he", 0), g.text_chunk("x", 1),
              g.text_chunk("llo", 0),
              g.finish_chunk(pcommon.FinishReason.STOP, 0),
              g.finish_chunk(pcommon.FinishReason.LENGTH, 1),
              g.usage_chunk(2, 3)]
    got = pagg.aggregate_chunks(chunks)
    assert got == ragg.aggregate_chunks(chunks)
    texts = [c.get("message", {}).get("content", c.get("text"))
             for c in got["choices"]]
    assert texts == ["hello", "x"]
    assert got["usage"]["total_tokens"] == 5
