"""Tool calls and the llm_metrics annotation of the port's frontend, held
against the JAX package: the parser cases of tests/test_tool_calls.py run
through both packages' parsers, and both HTTP services over EchoEngine
answer the same tool-declaring and llm_metrics requests alike."""
import json

import pytest

import dynamo_tpu.tool_calls as rtc
import dynamo_tpu_torch.tool_calls as ptc
from dynamo_tpu.engines import EchoEngine as REcho
from dynamo_tpu_torch.engines import EchoEngine as PEcho
from tests import test_torch_frontend as tf
from tests.test_torch_frontend import _Port, _Ref, _strip

MODS = pytest.mark.parametrize("tc", [ptc, rtc], ids=["port", "reference"])


# ---------------------------------------------------------------------------
# the parser, through both packages


@MODS
def test_parse_llama3_json_single_and_array(tc):
    calls = tc.parse_tool_calls(
        ' {"name": "get_weather", "parameters": {"city": "SF"}} '
    )
    assert len(calls) == 1
    assert calls[0]["type"] == "function"
    assert calls[0]["function"]["name"] == "get_weather"
    assert json.loads(calls[0]["function"]["arguments"]) == {"city": "SF"}
    assert calls[0]["id"].startswith("call_")
    arr = tc.parse_tool_calls(
        '[{"name": "a", "arguments": {}}, {"name": "b", "parameters": {"x": 1}}]'
    )
    assert [c["function"]["name"] for c in arr] == ["a", "b"]


@MODS
def test_parse_hermes_tags(tc):
    calls = tc.parse_tool_calls(
        'something\n<tool_call>{"name": "f", "arguments": {"k": 2}}</tool_call>'
        '<tool_call>{"name": "g", "arguments": {}}</tool_call>'
    )
    assert [c["function"]["name"] for c in calls] == ["f", "g"]


@MODS
def test_parse_rejects_non_tool_text(tc):
    assert tc.parse_tool_calls("hello there") is None
    assert tc.parse_tool_calls('{"not": "a tool"}') is None
    assert tc.parse_tool_calls('{"name": broken json') is None
    assert tc.parse_tool_calls("<tool_call>{unterminated") is None
    assert tc.parse_tool_calls("") is None


@MODS
def test_parse_strict_rejects_content_objects_and_unknown_names(tc):
    assert tc.parse_tool_calls('{"name": "Alice", "age": 30}') is None
    assert tc.parse_tool_calls('{"name": "evil", "arguments": {}}',
                               allowed={"get_weather"}) is None
    assert tc.parse_tool_calls('{"name": "get_weather", "arguments": {}}',
                               allowed={"get_weather"}) is not None


@MODS
def test_parse_hermes_preserves_surrounding_prose(tc):
    calls, content = tc.parse_tool_calls_with_content(
        "Let me check.\n"
        '<tool_call>{"name": "f", "arguments": {}}</tool_call>'
        "\nOne moment."
    )
    assert calls and calls[0]["function"]["name"] == "f"
    assert "Let me check." in content and "One moment." in content


@MODS
def test_accumulator_releases_plain_text_immediately(tc):
    acc = tc.ToolCallAccumulator()
    assert acc.feed("Hello") == "Hello"
    assert acc.feed(" world") == " world"
    calls, leftover = acc.finalize()
    assert calls is None and not leftover


@MODS
def test_accumulator_buffers_and_parses_tool_call(tc):
    acc = tc.ToolCallAccumulator()
    assert acc.feed('{"name": "f",') == ""
    assert acc.feed(' "parameters": {}}') == ""
    calls, leftover = acc.finalize()
    assert calls is not None and calls[0]["function"]["name"] == "f"
    assert not leftover


@MODS
def test_accumulator_releases_failed_parse_as_content(tc):
    acc = tc.ToolCallAccumulator()
    assert acc.feed("{oops not json") == ""
    calls, leftover = acc.finalize()
    assert calls is None and leftover == "{oops not json"


@MODS
def test_accumulator_releases_diverged_tag_early(tc):
    acc = tc.ToolCallAccumulator()
    assert acc.feed("<p>") == "<p>"
    assert acc.feed("hello") == "hello"
    calls, leftover = acc.finalize()
    assert calls is None and not leftover


@MODS
def test_accumulator_releases_non_tool_json_once_complete(tc):
    acc = tc.ToolCallAccumulator()
    assert acc.feed('{"answer":') == ""
    assert acc.feed(' 42}') == '{"answer": 42}'
    calls, leftover = acc.finalize()
    assert calls is None and leftover is None


@MODS
def test_accumulator_catches_mid_stream_hermes_tag(tc):
    acc = tc.ToolCallAccumulator()
    released = acc.feed("Okay. ")
    released += acc.feed('<tool_call>{"name": "f", ')
    released += acc.feed('"arguments": {}}</tool_call>')
    assert released.startswith("Okay. ")
    assert "<tool_call>" not in released
    calls, leftover = acc.finalize()
    assert calls is not None and calls[0]["function"]["name"] == "f"


@MODS
def test_accumulator_gives_up_past_the_buffer_cap(tc):
    acc = tc.ToolCallAccumulator()
    assert acc.feed('{"name": "f", "arguments": "') == ""
    big = "x" * (tc.MAX_TOOL_BUFFER + 1)
    assert acc.feed(big).endswith(big)
    assert acc.finalize() == (None, None)


PARSER_TEXTS = [
    '{"name": "get_w", "arguments": {"city": "x"}}',
    '[{"name": "a", "arguments": {}}, {"name": "b", "parameters": {"x": 1}}]',
    'pre <tool_call>{"name": "f", "arguments": {"k": [1, 2]}}</tool_call> post',
    '<tool_call>{"name": "f", "arguments": {}}',
    '{"name": "Alice", "age": 30}',
    'plain prose',
    '   ',
    '{"name": "f", "arguments": "{\\"a\\": 1}"}',
]


@pytest.mark.parametrize("allowed", [None, {"get_w", "a", "b"}])
def test_parsers_agree_on_a_table_of_outputs(allowed):
    def strip(res):
        calls, content = res
        if calls is not None:
            calls = [{k: v for k, v in c.items() if k != "id"}
                     for c in calls]
        return calls, content

    for text in PARSER_TEXTS:
        assert (strip(ptc.parse_tool_calls_with_content(text, allowed))
                == strip(rtc.parse_tool_calls_with_content(text, allowed))
                ), text
        # the stream in 5-character deltas
        accs = [ptc.ToolCallAccumulator(allowed),
                rtc.ToolCallAccumulator(allowed)]
        outs = []
        for acc in accs:
            released = "".join(acc.feed(text[i:i + 5])
                               for i in range(0, len(text), 5))
            outs.append((released, strip(acc.finalize())))
        assert outs[0] == outs[1], text


# ---------------------------------------------------------------------------
# both services over EchoEngine: the echo engine streams the prompt's
# words back, so a prompt that spells a tool call is answered with one

CALL_WORDS = ['{"name":"get_w",', '"arguments":{"city":"x"}}']
HERMES_WORDS = ["Checking.", '<tool_call>{"name":"get_w",',
                '"arguments":{}}</tool_call>', "done."]
WORDS = ([f"w{i}" for i in range(50)] + ["hello", "world"] + CALL_WORDS
         + HERMES_WORDS)
TEMPLATE = "{% for m in messages %}{{ m.content }} {% endfor %}"
TOOLS = [{"type": "function",
          "function": {"name": "get_w", "parameters": {}}}]
CHAT = "/v1/chat/completions"


def _chat(words, *, tools=True, stream=False, **extra):
    body = {"model": "echo", "max_tokens": len(words),
            "messages": [{"role": "user", "content": " ".join(words)}]}
    if tools:
        body["tools"] = TOOLS
    if stream:
        body["stream"] = True
    body.update(extra)
    return body


def _manager(port: bool):
    tok = (tf.p_tokenizer if port else tf.r_tokenizer)(WORDS)
    name = "echo"
    chain = (tf.PChain if port else tf.RChain)(
        name=name,
        preprocessor=(tf.PPre if port else tf.RPre)(
            tokenizer=tok,
            formatter=(tf.PFormatter if port else tf.RFormatter)(
                template=TEMPLATE),
            model_name=name),
        engine=(PEcho if port else REcho)(delay_s=0.0),
        backend=(tf.PBackend if port else tf.RBackend)(tok))
    m = (tf.PManager if port else tf.RManager)()
    m.register(chain)
    return m


async def _both(body, stream):
    out = []
    for port, svc_cls in ((True, _Port), (False, _Ref)):
        async with svc_cls(_manager(port)) as s:
            out.append(await s.call("POST", CHAT, body, stream=stream))
    return out


TOOL_REQUESTS = [
    ("llama3 call unary", CALL_WORDS, True, False),
    ("llama3 call stream", CALL_WORDS, True, True),
    ("hermes call with prose unary", HERMES_WORDS, True, False),
    ("hermes call with prose stream", HERMES_WORDS, True, True),
    ("plain text with tools stream", ["hello", "world"], True, True),
    ("undeclared tools: content unary", CALL_WORDS, False, False),
]


@pytest.mark.parametrize("label,words,tools,stream", TOOL_REQUESTS,
                         ids=[r[0] for r in TOOL_REQUESTS])
async def test_tool_calls_match_reference_service(label, words, tools,
                                                  stream):
    (ps, _, pb), (rs, _, rb) = await _both(
        _chat(words, tools=tools, stream=stream), stream)
    assert ps == rs == 200
    assert _strip(pb) == _strip(rb)
    if not tools:
        return
    calls_expected = words is not TOOL_REQUESTS[4][1]
    if stream:
        chunks = [json.loads(e) for e in pb[:-1]]
        finish = [c["choices"][0]["finish_reason"] for c in chunks
                  if c["choices"] and c["choices"][0]["finish_reason"]]
        deltas = [d for c in chunks for d in
                  c["choices"][0]["delta"].get("tool_calls", [])]
        assert finish == (["tool_calls"] if calls_expected else ["length"])
        text = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in chunks)
        assert '"name"' not in text
        if calls_expected:
            assert deltas[0]["function"]["name"] == "get_w"
            assert deltas[0]["id"].startswith("call_")
    else:
        choice = pb["choices"][0]
        assert choice["finish_reason"] == "tool_calls"
        call = choice["message"]["tool_calls"][0]
        assert call["function"]["name"] == "get_w"
        if words is CALL_WORDS:
            assert choice["message"]["content"] is None
            assert json.loads(call["function"]["arguments"]) == {"city": "x"}
        else:
            assert choice["message"]["content"] == "Checking.\ndone."


async def test_llm_metrics_event_matches_reference_shape():
    body = _chat(["w1", "w2", "w3", "w4"], tools=False, stream=True,
                 nvext={"annotations": ["llm_metrics"]},
                 stream_options={"include_usage": True})
    (ps, _, pb), (rs, _, rb) = await _both(body, True)
    assert ps == rs == 200
    assert pb[-1] == rb[-1] == "[DONE]"
    pev, rev = json.loads(pb[-2]), json.loads(rb[-2])
    assert pev["nvext"]["annotation"] == rev["nvext"]["annotation"] \
        == "llm_metrics"
    pm, rm = pev["nvext"]["metrics"], rev["nvext"]["metrics"]
    assert pm.keys() == rm.keys() == {
        "prompt_tokens", "completion_tokens", "ttft_s", "itl_avg_s",
        "itl_p50_s", "itl_p95_s"}
    assert (pm["prompt_tokens"], pm["completion_tokens"]) \
        == (rm["prompt_tokens"], rm["completion_tokens"]) == (4, 4)
    for k in ("ttft_s", "itl_avg_s", "itl_p50_s", "itl_p95_s"):
        assert isinstance(pm[k], float) and pm[k] >= 0.0, k
    # the events before it are the reference's, timing aside
    assert _strip(pb[:-2]) == _strip(rb[:-2])
    # without the annotation there is no such event
    body.pop("nvext")
    (_, _, pb), _ = await _both(body, True)
    assert not any("nvext" in e for e in pb)
