"""The port's chat template, test tokenizer, preprocessor and backend
against the JAX package's: the standard-library Jinja subset renders as
jinja2 does (with the reference's trim_blocks/lstrip_blocks settings) and
refuses anything outside the subset when it is compiled; the test
tokenizer, DecodeStream, StopJail and Backend.transform give the same
outputs on the same inputs."""
import asyncio
import json

import jinja2
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu import backend as rbackend
from dynamo_tpu import preprocessor as rpre
from dynamo_tpu import tokenizer as rtok
from dynamo_tpu.protocols import common as rcommon
from dynamo_tpu.protocols import openai as ropenai
from dynamo_tpu_torch import backend as pbackend
from dynamo_tpu_torch import preprocessor as ppre
from dynamo_tpu_torch import tokenizer as ptok
from dynamo_tpu_torch.chat_template import ChatTemplate, UndefinedError
from dynamo_tpu_torch.protocols import common as pcommon
from dynamo_tpu_torch.protocols import openai as popenai

WORDS = [f"w{i}" for i in range(50)] + ["hello", "world", "STOP", "<END>"]


def _jinja(template: str):
    """The reference's environment (dynamo_tpu/preprocessor.py)."""
    env = jinja2.Environment(loader=jinja2.BaseLoader(), trim_blocks=True,
                             lstrip_blocks=True)
    env.globals["raise_exception"] = rpre._raise_exception
    env.filters["tojson"] = lambda v, **kw: json.dumps(v, **kw)
    return env.from_string(template)


LLAMA3_LIKE = (
    "{{ bos_token }}{% for message in messages %}\n"
    "    {% if loop.first and message['role'] != 'system' %}\n"
    "<|start_header_id|>system<|end_header_id|>\n\n{{ default_system }}"
    "<|eot_id|>\n"
    "    {% endif %}\n"
    "<|start_header_id|>{{ message['role'] }}<|end_header_id|>\n\n"
    "{{- message['content'] | trim }}<|eot_id|>\n"
    "{%- endfor %}\n"
    "{% if add_generation_prompt %}"
    "<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}\n")
ALTERNATING = (
    "{# roles must alternate #}\n"
    "{% set last = none %}\n"
    "{% for m in messages %}\n"
    "  {%- if m.role == last -%}\n"
    "    {{ raise_exception('roles must alternate') }}\n"
    "  {%- endif -%}\n"
    "  {% set last = m.role %}\n"
    "[{{ loop.index }}/{{ loop.index0 }}{% if loop.last %} last{% endif %}]"
    " {{ m.role + ': ' + m.content }}\n"
    "{% endfor %}\n"
    "{%+ if tools %}tools: {{ tools | tojson }}{% else %}no tools{% endif %}"
    "\n{% if 'x' in eos_token or not add_generation_prompt %}X{% elif "
    "eos_token != '' and true %}{{ eos_token }}{% endif %}")
TEMPLATES = {
    "default": rpre.DEFAULT_CHAT_TEMPLATE,
    "tests": "{% for m in messages %}{{ m.content }} {% endfor %}",
    "tests_nospace": "{% for m in messages %}{{ m.content }}{% endfor %}",
    "llama3_like": LLAMA3_LIKE,
    "alternating": ALTERNATING,
}
MESSAGES = [
    {"role": "system", "content": "  be brief  "},
    {"role": "user", "content": "hello\n world"},
    {"role": "assistant", "content": "w1 {{ w2 }} {% if %}"},
    {"role": "user", "content": ""},
]


def _outcome(render):
    try:
        return render()
    except ValueError as e:  # raise_exception
        return ("ValueError", str(e))


def _both(template: str, **ctx):
    return (_outcome(lambda: ChatTemplate(template).render(**ctx)),
            _outcome(lambda: _jinja(template).render(**ctx)))


@pytest.mark.parametrize("name", sorted(TEMPLATES))
@pytest.mark.parametrize("add_generation_prompt", [True, False])
def test_chat_templates_render_as_jinja2(name, add_generation_prompt):
    ctx = dict(messages=MESSAGES, add_generation_prompt=add_generation_prompt,
               bos_token="<s>", eos_token="</s>", default_system="sys",
               tools=[{"type": "function", "name": "f"}])
    got, want = _both(TEMPLATES[name], **ctx)
    assert got == want


_TEXT = st.text(alphabet=" \n\t{}%#-+abcéw1'\"\\", max_size=12)


@settings(max_examples=150, deadline=None)
@given(name=st.sampled_from(sorted(TEMPLATES)),
       roles=st.lists(st.sampled_from(["system", "user", "assistant",
                                       "tool"]), max_size=5),
       texts=st.lists(_TEXT, min_size=5, max_size=5),
       add=st.booleans(), eos=st.sampled_from(["", "</s>", "x"]))
def test_chat_templates_match_jinja2_on_random_messages(name, roles, texts,
                                                        add, eos):
    messages = [{"role": r, "content": t} for r, t in zip(roles, texts)]
    got, want = _both(TEMPLATES[name], messages=messages,
                      add_generation_prompt=add, bos_token="<s>",
                      eos_token=eos, default_system=texts[-1], tools=None)
    assert got == want


WHITESPACE_AND_SCOPE = [
    "  {% if true %}\n  x\n  {% endif %}\n  y\n",
    "a  {% if true %}b{% endif %}",
    "{%- if true -%}  \n  a  \n {%- endif %}",
    "x\n{# c #}\ny\n  {# c2 #}\nz",
    "\r\nA\r\n{% if true %}\r\nB\r\n{% endif %}\r\n",
    "{% if true +%}\nX{% endif %}",
    "  {%+ if true %}X{% endif %}",
    "{{- ' a ' -}}  \n b",
    "{% set x = 1 %}{% for m in messages %}{{ x }}{% set x = x + 1 %}"
    "{{ x }}{% endfor %}{{ x }}",
    "{% for m in messages %}{% for n in messages %}{{ loop.index }}"
    "{% endfor %}{{ loop.index }}{% endfor %}",
    "{{ 1 == 1 == 1 }}{{ 'a' 'b' }}{{ 'x' not in 'xy' }}{{ (1) }}",
    "{{ none }}{{ true }}{{ missing }}|{{ missing | trim }}|"
    "{{ messages[9] }}|{{ messages[0].nope }}|{{ 'q' in missing }}",
    "{{ \"a\\tb\" }}|{{ 'it\\'s' }}|{{ 0 or '' }}{{ 1 == 1 and 2 }}",
    "{{ messages | tojson(indent=2) }}{{ messages[0]['content'] | trim }}",
]


@pytest.mark.parametrize("template", WHITESPACE_AND_SCOPE)
def test_whitespace_and_scoping_match_jinja2(template):
    got, want = _both(template, messages=MESSAGES[:3])
    assert got == want


@pytest.mark.parametrize("template,err", [
    ("{{ missing.attr }}", UndefinedError),
    ("{{ missing + 'a' }}", UndefinedError),
    ("{{ 1 + 'a' }}", TypeError),
    ("{% for m in none %}{% endfor %}", TypeError),
])
def test_render_errors_match_jinja2(template, err):
    with pytest.raises(err):
        ChatTemplate(template).render()
    with pytest.raises(Exception):
        _jinja(template).render()


@pytest.mark.parametrize("template,what", [
    ("{{ 'a' if true else 'b' }}", "'if'"),
    ("{{ messages | length }}", "filter 'length'"),
    ("{% macro f() %}{% endmacro %}", "statement"),
    ("{{ x is defined }}", "test 'is'"),
    ("{% for a, b in x %}{% endfor %}", "several targets"),
    ("{{ [1, 2] }}", "list literal"),
    ("{{ x ~ y }}", "operator '~'"),
    ("{{ m.get('a') }}", "call"),
    ("{{ loop.length }}", "loop.length"),
    ("{% set ns = namespace(a=1) %}", "call"),
    ("{% raw %}{% endraw %}", "statement"),
    ("{{ x[1:] }}", "operator ':'"),
    ("{{ 1.5 }}", "character"),
    ("{{ 1 - 1 }}", "operator '-'"),
    ("{% for m in messages if m %}{% endfor %}", "'if'"),
    ("{% for m in messages %}{% else %}{% endfor %}", "else"),
    ("{% set x %}a{% endset %}", "block"),
    ("{% if x %}", "not closed"),
    ("{% endif %}", "unexpected"),
    ("{{ x", "not closed"),
])
def test_unsupported_constructs_raise_when_compiled(template, what):
    with pytest.raises(ValueError, match="chat template") as e:
        ppre.PromptFormatter(template=template)
    assert what in str(e.value)


@settings(max_examples=200, deadline=None)
@given(text=st.lists(st.sampled_from(
    ["w1", "w2", "hello", "zz", " ", "\t", "\n", "\x0b", "\x1c", "\x85",
     "\xa0", "\u2003", "\u200b", "\u3000", "\ufeff"]), max_size=20).map(
        "".join),
    ids=st.lists(st.integers(0, 120), max_size=12), skip=st.booleans())
def test_test_tokenizer_matches_reference(text, ids, skip):
    p, r = ptok.make_test_tokenizer(WORDS), rtok.make_test_tokenizer(WORDS)
    assert p.encode(text) == r.encode(text)
    assert p.decode(ids, skip) == r.decode(ids, skip)
    assert (p.vocab_size, p.eos_token_ids, p.bos_token_id) == \
        (r.vocab_size, r.eos_token_ids, r.bos_token_id)
    d = ptok.make_test_tokenizer()
    assert d.encode("w0 w99 w100") == rtok.make_test_tokenizer().encode(
        "w0 w99 w100") == [3, 102, 0]


@settings(max_examples=100, deadline=None)
@given(prompt=st.lists(st.integers(0, 60), max_size=8),
       stream=st.lists(st.integers(0, 60), max_size=80))
def test_decode_stream_matches_reference(prompt, stream):
    p, r = ptok.make_test_tokenizer(WORDS), rtok.make_test_tokenizer(WORDS)
    dp, dr = ptok.DecodeStream(p, prompt), rtok.DecodeStream(r, prompt)
    assert [dp.step(t) for t in stream] == [dr.step(t) for t in stream]


@settings(max_examples=200, deadline=None)
@given(stops=st.lists(st.sampled_from(["<END>", "ab", "b", "STOP", ""]),
                      max_size=3),
       pieces=st.lists(st.sampled_from(["a", "b", "<", "<E", "ND>", "x ",
                                        "STO", "P", "<END>"]), max_size=10))
def test_stop_jail_matches_reference(stops, pieces):
    jp, jr = pbackend.StopJail(stops), rbackend.StopJail(stops)
    for piece in pieces:
        assert jp.push(piece) == jr.push(piece)
    assert jp.flush() == jr.flush()


def _engine_stream(common, steps, finish):
    """Engine outputs: each step a list of token ids, with log probs and
    top-2 alternatives per token."""
    async def gen():
        for i, toks in enumerate(steps):
            last = i == len(steps) - 1
            yield common.LLMEngineOutput(
                token_ids=list(toks),
                log_probs=[-0.1 * (t % 7) for t in toks],
                top_logprobs=[[[t, -0.1 * (t % 7)], [t + 1, -2.0]]
                              for t in toks],
                finish_reason=(getattr(common.FinishReason, finish)
                               if last and finish else None))
    return gen()


async def _transform(mod, common, tok, steps, finish, **stop):
    outs = []
    async for o in mod.Backend(tok).transform(
            _engine_stream(common, steps, finish), prompt_ids=[3, 4],
            stop=common.StopConditions(**stop)):
        outs.append((o.token_ids, o.text,
                     o.finish_reason.value if o.finish_reason else None,
                     o.log_probs, o.logprob_entries))
    return outs


BACKEND_CASES = {
    # each word is one token: a stop string of two words spans two tokens,
    # and the jail holds the first until the second completes or breaks it
    "stop string": (["hello world STOP w1 w2"], None,
                    dict(stop=["STOP"], max_tokens=20)),
    "stop string split over words": (["w1 w2 w3 w4"], None,
                                     dict(stop=["w2 w3"], max_tokens=20)),
    "stop string never completed": (["w1 w2 w4 w5"], "LENGTH",
                                    dict(stop=["w2 w3"], max_tokens=20)),
    "eos id": (["w1 w2", "</s>", "w3"], None,
               dict(stop_token_ids=[2], max_tokens=20)),
    "ignore_eos": (["w1 </s> w2"], "LENGTH",
                   dict(stop_token_ids=[2], ignore_eos=True,
                        max_tokens=20)),
    "max_tokens": (["w1 w2 w3", "w4 w5"], None, dict(max_tokens=4)),
    "min_tokens holds eos": (["</s> w1 </s>"], None,
                             dict(stop_token_ids=[2], min_tokens=2)),
    "no finish": (["w1 w2"], None, dict()),
}


@pytest.mark.parametrize("case", sorted(BACKEND_CASES))
def test_backend_transform_matches_reference(case):
    texts, finish, stop = BACKEND_CASES[case]
    p, r = ptok.make_test_tokenizer(WORDS), rtok.make_test_tokenizer(WORDS)
    # one engine output a word, the first output carrying two words
    steps = []
    for t in texts:
        ids = r.encode(t)
        steps += [ids[:2]] + [[i] for i in ids[2:]]
    got = asyncio.run(_transform(pbackend, pcommon, p, steps, finish,
                                 **stop))
    want = asyncio.run(_transform(rbackend, rcommon, r, steps, finish,
                                  **stop))
    assert got == want
    assert got[-1][2] is not None


def test_backend_closes_the_engine_stream_when_closed():
    closed = []

    async def engine():
        try:
            for i in range(100):
                yield pcommon.LLMEngineOutput(token_ids=[3 + i % 5])
        finally:
            closed.append(True)

    async def run():
        tok = ptok.make_test_tokenizer(WORDS)
        gen = pbackend.Backend(tok).transform(
            engine(), prompt_ids=[], stop=pcommon.StopConditions())
        await gen.__anext__()
        await gen.aclose()

    asyncio.run(run())
    assert closed == [True]


def _preprocess(mod, omod, tok, chat, body, template=None):
    fmt = mod.PromptFormatter(template=template) if template else \
        mod.PromptFormatter()
    pre = mod.OpenAIPreprocessor(tokenizer=tok, formatter=fmt,
                                 model_name="m", default_max_tokens=12)
    cls = omod.ChatCompletionRequest if chat else omod.CompletionRequest
    req = cls.from_dict(body) if mod is ppre else cls(**body)
    out = (pre.preprocess_chat if chat else pre.preprocess_completion)(req)
    d = out.to_dict()
    d.pop("request_id")
    if d["deadline"] is not None:
        d["deadline"] = round(d["deadline"] - __import__("time").time())
    return d


@pytest.mark.parametrize("chat,body", [
    (True, {"model": "m", "messages": [
        {"role": "system", "content": "w1 w2"},
        {"role": "user", "content": [{"type": "text", "text": "hello "},
                                     {"type": "text", "text": "world"}]}],
        "stop": "STOP", "temperature": 0.5, "seed": 3,
        "nvext": {"ignore_eos": True, "priority": "high",
                  "timeout_ms": 60000, "tenant": "t1",
                  "annotations": ["a"]}}),
    (True, {"model": "", "messages": [{"role": "user", "content": "w1"}],
            "max_completion_tokens": 5, "logprobs": True,
            "top_logprobs": 2, "chat_template_args": {"eos_token": "w9"}}),
    (False, {"model": "m", "prompt": [5, 6, 7], "logprobs": 2, "n": 2}),
    (False, {"model": "m", "prompt": ["hello w1"], "stop": ["a", "b"]}),
    (False, {"model": "m", "prompt": [[9, 10]], "top_k": 5, "top_p": 0.5}),
])
def test_preprocessor_matches_reference(chat, body):
    p, r = ptok.make_test_tokenizer(WORDS), rtok.make_test_tokenizer(WORDS)
    assert _preprocess(ppre, popenai, p, chat, body) == \
        _preprocess(rpre, ropenai, r, chat, body)
    if chat:
        tpl = TEMPLATES["llama3_like"]
        assert _preprocess(ppre, popenai, p, chat, body, tpl) == \
            _preprocess(rpre, ropenai, r, chat, body, tpl)


def test_preprocessor_refuses_image_parts_and_batches():
    pre = ppre.OpenAIPreprocessor(tokenizer=ptok.make_test_tokenizer())
    req = popenai.ChatCompletionRequest.from_dict({"model": "m", "messages": [
        {"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "data:,"}}]}]})
    with pytest.raises(ValueError, match="image"):
        pre.preprocess_chat(req)
    with pytest.raises(ValueError, match="batch"):
        pre.preprocess_completion(popenai.CompletionRequest.from_dict(
            {"model": "m", "prompt": ["a", "b"]}))
    with pytest.raises(ValueError, match="context length"):
        ppre.OpenAIPreprocessor(
            tokenizer=ptok.make_test_tokenizer(), context_length=2,
        ).preprocess_completion(popenai.CompletionRequest.from_dict(
            {"model": "m", "prompt": [1, 2, 3]}))
