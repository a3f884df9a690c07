"""The port's chat templates (chat_template.py) against jinja2 with the
JAX package's environment, for the constructs that published instruct
templates use, and for four templates written here in the shapes of the
Llama-3.1-Instruct, Qwen2.5-Instruct, Mistral-7B-Instruct-v0.3 and
DeepSeek-R1-Distill-Llama-8B ones over random conversations, with and
without tools; PromptFormatter.from_dir against the JAX package's."""
import json

import jinja2
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu import preprocessor as rpre
from dynamo_tpu_torch import preprocessor as ppre
from dynamo_tpu_torch.chat_template import ChatTemplate


def _jinja(template: str):
    """The reference's environment (dynamo_tpu/preprocessor.py)."""
    env = jinja2.Environment(loader=jinja2.BaseLoader(), trim_blocks=True,
                             lstrip_blocks=True)
    env.globals["raise_exception"] = rpre._raise_exception
    env.filters["tojson"] = lambda v, **kw: json.dumps(v, **kw)
    return env.from_string(template)


def _outcome(render):
    """The text, the message of a raise_exception, or ("error",) for any
    other failure (the two packages name their exceptions differently)."""
    try:
        return render()
    except ValueError as e:
        return ("ValueError", str(e))
    except Exception:  # noqa: BLE001 - both must fail, either way
        return ("error",)


def _both(template: str, **ctx):
    return (_outcome(lambda: ChatTemplate(template).render(**ctx)),
            _outcome(lambda: _jinja(template).render(**ctx)))


MESSAGES = [
    {"role": "system", "content": "  be brief  "},
    {"role": "user", "content": "Hello, World"},
    {"role": "assistant", "content": "<think>hm</think> hi there",
     "tool_calls": [{"id": "abcdefghi", "type": "function",
                     "function": {"name": "f", "arguments": {"x": 1}}}]},
    {"role": "tool", "content": "42", "tool_call_id": "abcdefghi"},
]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string"}}}}}]

CONSTRUCTS = [
    # inline if
    "{{ 'a' if messages else 'b' }}{{ 'c' if none }}|{{ 1 if 0 else 2 if 1 "
    "else 3 }}",
    # tests
    "{{ x is defined }}{{ messages is not defined }}{{ tools is not none }}"
    "{{ none is none }}{{ 'a' is string }}{{ messages[0] is mapping }}"
    "{{ messages is iterable }}{{ 3 is string }}{{ 3 is iterable }}"
    "{{ x is undefined }}{{ 'a' is equalto 'a' }}{{ 1 is eq(2) }}",
    "{% if not x is defined %}undef{% endif %}{% if messages[0].content "
    "is string and tools %}both{% endif %}",
    # operators, negative indices, slices, list literals
    "{{ 'a' ~ 1 ~ none ~ x }}{{ 7 - 2 }}{{ 7 % 3 }}{{ 'v=%s' % 5 }}"
    "{{ -1 }}{{ 1 + 2 % 3 - 4 }}{{ 'a' ~ 1 + 2 }}",
    "{{ messages[-1].role }}{{ messages[1:] | length }}"
    "{{ messages[:-1] | map(attribute='role') | join(',') }}"
    "{{ 'abcdef'[1:4] }}{{ 'abcdef'[::-2] }}{{ messages[-9] }}",
    "{{ [1, 'a', none, [2]] }}{{ [] | length }}{{ ['x', 'y'][1] }}",
    # methods
    "{{ messages[0].get('role') }}{{ messages[0].get('nope') }}"
    "{{ messages[0].get('nope', 'dflt') }}"
    "{{ messages[0].content.strip() }}|{{ ' x '.strip(' x') }}|"
    "{{ messages[2].content.split('</think>')[-1] }}"
    "{{ 'a,b'.split(',') }}{{ 'abc'.startswith('ab') }}"
    "{{ 'abc'.endswith('x') }}",
    "{% for k, v in messages[0].items() %}{{ k }}={{ v }};{% endfor %}"
    "{% for k, v in tools[0] | items %}{{ k }}{% endfor %}",
    # namespace
    "{% set ns = namespace(a=1, found=false) %}{% for m in messages %}"
    "{% if m.role == 'user' %}{% set ns.found = true %}{% endif %}"
    "{% set ns.a = ns.a + 2 %}{% endfor %}{{ ns.a }}{{ ns.found }}"
    "{{ ns.missing }}{{ ns }}",
    # filters
    "{{ messages | length }}"
    "{{ messages | map(attribute='role') | join(', ') }}"
    "{{ messages | join('|', attribute='role') }}"
    "{{ x | default('dflt') }}{{ '' | default('e', true) }}"
    "{{ messages | first }}{{ (messages | last).role }}"
    "{{ 'AbC' | lower }}{{ 'AbC' | upper }}{{ 'aaa' | replace('a', 'b', 2) }}"
    "{{ 5 | string }}{{ messages | list | length }}{{ [] | first }}",
    "{{ messages | selectattr('role', 'equalto', 'user') | list | length }}"
    "{{ messages | reject('equalto', messages[0]) | map("
    "attribute='role') | join }}"
    "{{ messages | selectattr('tool_calls') | list | length }}"
    "{{ [1, none, 2, ''] | select | list }}{{ [1, none, 'a'] | reject("
    "'none') | list }}{{ ['a', 1] | select('string') | list }}"
    "{{ messages | map(attribute='function.name', default='-') | list }}"
    "{{ ['A', 'B'] | map('lower') | join }}",
    "{{ tools | tojson }}{{ tools[0] | tojson(indent=2) }}"
    "{{ messages[0].content | trim }}",
    # loop attributes, unpacking, filtered loops
    "{% for m in messages %}{{ loop.index }}/{{ loop.length }}/"
    "{{ loop.index0 }}{% if not loop.first %}"
    "<{{ loop.previtem.role }}{% endif %}{% if not loop.last %}"
    ">{{ loop.nextitem.role }}{% endif %};{% endfor %}",
    "{% for m in messages if m.role != 'system' %}{{ loop.index0 }}"
    "{{ m.role }}{{ loop.length }}{% endfor %}",
    "{% for a, b in [[1, 2], [3, 4]] %}{{ a + b }}{% endfor %}",
    # macros
    "{% macro show(m, sep=': ') %}{{ m.role }}{{ sep }}{{ m.content | trim "
    "}}{% endmacro %}{% for m in messages %}{{ show(m) }};"
    "{{ show(m, sep='=') }}|{% endfor %}",
    "{%- macro tool_line(t) -%}\n  [{{ t.function.name }}]\n"
    "{%- endmacro -%}\n{{ tool_line(tools[0]) }}",
    # strftime_now, when the caller passes it
    "{% if strftime_now is defined %}{{ strftime_now('%d %b %Y') }}"
    "{% else %}no clock{% endif %}",
    # scoping of loop variables and sets
    "{% set x = 1 %}{% for m in messages %}{% set x = x + 1 %}"
    "{% set m = m.role %}{{ m }}{{ x }}{% endfor %}{{ x }}",
    # errors on both sides
    "{{ raise_exception('nope: ' ~ messages | length) }}",
    "{{ 'x' if false }}{{ loop.length }}",
    "{{ missing.attr }}",
]


@pytest.mark.parametrize("clock", [False, True])
@pytest.mark.parametrize("template", CONSTRUCTS)
def test_constructs_render_as_jinja2(template, clock):
    ctx = dict(messages=MESSAGES, tools=TOOLS, bos_token="<s>")
    if clock:
        ctx["strftime_now"] = lambda fmt: "18 Oct 2026 " + fmt
    got, want = _both(template, **ctx)
    assert got == want


@pytest.mark.parametrize("template,what", [
    ("{{ x.foo() }}", "call of 'foo'"),
    ("{{ open('f') }}", "call of 'open'"),
    ("{{ x | wordcount }}", "filter 'wordcount'"),
    ("{{ x is callable }}", "test 'callable'"),
    ("{{ {'a': 1} }}", "operator '{'"),
    ("{{ (1, 2) }}", "tuple"),
    ("{% include 'x' %}", "statement"),
    ("{% call f() %}{% endcall %}", "statement"),
    ("{% for m in x recursive %}{% endfor %}", "recursive"),
    ("{{ loop.cycle('a', 'b') }}", "loop.cycle"),
    ("{{ loop.revindex }}", "loop.revindex"),
    ("{{ 1 < 2 }}", "operator '<'"),
    ("{{ 2 * 3 }}", "operator '*'"),
    ("{{ x is odd }}", "test 'odd'"),
    ("{{ x | count }}", "filter 'count'"),
    ("{% for i in range(3) %}{% endfor %}", "call of 'range'"),
    ("{{ 'a'.lower() }}", "call of 'lower'"),
])
def test_constructs_outside_the_subset_raise_when_compiled(template, what):
    with pytest.raises(ValueError, match="chat template") as e:
        ChatTemplate(template)
    assert what in str(e.value)


LLAMA31 = r"""{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- if strftime_now is defined %}
        {%- set date_string = strftime_now("%d %b %Y") %}
    {%- else %}
        {%- set date_string = "26 Jul 2024" %}
    {%- endif %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- This block extracts the system message, so we can slot it into the right place. #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}

{#- System message + builtin tools #}
{{- "<|start_header_id|>system<|end_header_id|>\n\n" }}
{%- if builtin_tools is defined or tools is not none %}
    {{- "Environment: ipython\n" }}
{%- endif %}
{%- if builtin_tools is defined %}
    {{- "Tools: " + builtin_tools | reject('equalto', 'code_interpreter') | join(", ") + "\n\n"}}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\n" }}
{{- "Today Date: " + date_string + "\n\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions. To call a function, please respond with JSON for a function call." }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\n\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\n\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}

{#- Custom tools are passed in a user message with some extra guidance #}
{%- if tools_in_user_message and not tools is none %}
    {#- Extract the first user message so we can plug it in here #}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
{%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\n\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call " }}
    {{- "with its proper arguments that best answers the given prompt.\n\n" }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\n\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\n\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {%- if builtin_tools is defined and tool_call.name in builtin_tools %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' -}}
            {{- "<|python_tag|>" + tool_call.name + ".call(" }}
            {%- for arg_name, arg_val in tool_call.arguments | items %}
                {{- arg_name + '="' + arg_val + '"' }}
                {%- if not loop.last %}
                    {{- ", " }}
                {%- endif %}
            {%- endfor %}
            {{- ")" }}
        {%- else  %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' -}}
            {{- '{"name": "' + tool_call.name + '", ' }}
            {{- '"parameters": ' }}
            {{- tool_call.arguments | tojson }}
            {{- "}" }}
        {%- endif %}
        {%- if builtin_tools is defined %}
            {{- "<|eom_id|>" }}
        {%- else %}
            {{- "<|eot_id|>" }}
        {%- endif %}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\n\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' }}
{%- endif %}
"""

QWEN25 = r"""{%- if tools %}
    {{- '<|im_start|>system\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are Qwen, created by Alibaba Cloud. You are a helpful assistant.' }}
    {%- endif %}
    {{- "\n\n# Tools\n\nYou may call one or more functions to assist with the user query.\n\nYou are provided with function signatures within <tools></tools> XML tags:\n<tools>" }}
    {%- for tool in tools %}
        {{- "\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\n</tools>\n\nFor each function call, return a json object with function name and arguments within <tool_call></tool_call> XML tags:\n<tool_call>\n{\"name\": <function-name>, \"arguments\": <args-json-object>}\n</tool_call><|im_end|>\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\n' + messages[0]['content'] + '<|im_end|>\n' }}
    {%- else %}
        {{- '<|im_start|>system\nYou are Qwen, created by Alibaba Cloud. You are a helpful assistant.<|im_end|>\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\n' + message.content + '<|im_end|>' + '\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\n<tool_call>\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\n' }}
    {%- elif message.role == "tool" %}
        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\n<tool_response>\n' }}
        {{- message.content }}
        {{- '\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\n' }}
{%- endif %}
"""

MISTRAL_V03 = r"""{%- if messages[0]["role"] == "system" %}
    {%- set system_message = messages[0]["content"] %}
    {%- set loop_messages = messages[1:] %}
{%- else %}
    {%- set loop_messages = messages %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}
{%- set user_messages = loop_messages | selectattr("role", "equalto", "user") | list %}

{#- This block checks for alternating user/assistant messages, skipping tool calling messages #}
{%- set ns = namespace() %}
{%- set ns.index = 0 %}
{%- for message in loop_messages %}
    {%- if not (message.role == "tool" or message.role == "tool_results" or (message.tool_calls is defined and message.tool_calls is not none)) %}
        {%- if (message["role"] == "user") != (ns.index % 2 == 0) %}
            {{- raise_exception("After the optional system message, conversation roles must alternate user/assistant/user/assistant/...") }}
        {%- endif %}
        {%- set ns.index = ns.index + 1 %}
    {%- endif %}
{%- endfor %}

{{- bos_token }}
{%- for message in loop_messages %}
    {%- if message["role"] == "user" %}
        {%- if tools is not none and (message == user_messages[-1]) %}
            {{- "[AVAILABLE_TOOLS] [" }}
            {%- for tool in tools %}
                {%- set tool = tool.function %}
                {{- '{"type": "function", "function": {' }}
                {%- for key, val in tool.items() if key != "return" %}
                    {%- if val is string %}
                        {{- '"' + key + '": "' + val + '"' }}
                    {%- else %}
                        {{- '"' + key + '": ' + val|tojson }}
                    {%- endif %}
                    {%- if not loop.last %}
                        {{- ", " }}
                    {%- endif %}
                {%- endfor %}
                {{- "}}" }}
                {%- if not loop.last %}
                    {{- ", " }}
                {%- else %}
                    {{- "]" }}
                {%- endif %}
            {%- endfor %}
            {{- "[/AVAILABLE_TOOLS]" }}
            {%- endif %}
        {%- if loop.last and system_message is defined %}
            {{- "[INST] " + system_message + "\n\n" + message["content"] + "[/INST]" }}
        {%- else %}
            {{- "[INST] " + message["content"] + "[/INST]" }}
        {%- endif %}
    {%- elif message.tool_calls is defined and message.tool_calls is not none %}
        {{- "[TOOL_CALLS] [" }}
        {%- for tool_call in message.tool_calls %}
            {%- set out = tool_call.function|tojson %}
            {{- out[:-1] }}
            {%- if not tool_call.id is defined or tool_call.id|length != 9 %}
                {{- raise_exception("Tool call IDs should be alphanumeric strings with length 9!") }}
            {%- endif %}
            {{- ', "id": "' + tool_call.id + '"}' }}
            {%- if not loop.last %}
                {{- ", " }}
            {%- else %}
                {{- "]" + eos_token }}
            {%- endif %}
        {%- endfor %}
    {%- elif message["role"] == "assistant" %}
        {{- " " + message["content"]|trim + eos_token}}
    {%- elif message["role"] == "tool_results" or message["role"] == "tool" %}
        {%- if message.content is defined and message.content.content is defined %}
            {%- set content = message.content.content %}
        {%- else %}
            {%- set content = message.content %}
        {%- endif %}
        {{- '[TOOL_RESULTS] {"content": ' + content|string + ", " }}
        {%- if not message.tool_call_id is defined or message.tool_call_id|length != 9 %}
            {{- raise_exception("Tool call IDs should be alphanumeric strings with length 9!") }}
        {%- endif %}
        {{- '"call_id": "' + message.tool_call_id + '"}[/TOOL_RESULTS]' }}
    {%- else %}
        {{- raise_exception("Only user and assistant roles are supported, with the exception of an initial optional system message!") }}
    {%- endif %}
{%- endfor %}
"""

DEEPSEEK_R1_DISTILL = (
    "{% if not add_generation_prompt is defined %}{% set add_generation_"
    "prompt = false %}{% endif %}{% set ns = namespace(is_first=false, "
    "is_tool=false, is_output_first=true, system_prompt='') %}{%- for "
    "message in messages %}{%- if message['role'] == 'system' %}{% set "
    "ns.system_prompt = message['content'] %}{%- endif %}{%- endfor %}"
    "{{bos_token}}{{ns.system_prompt}}{%- for message in messages %}{%- if "
    "message['role'] == 'user' %}{%- set ns.is_tool = false -%}{{'<｜User"
    "｜>' + message['content']}}{%- endif %}{%- if message['role'] == "
    "'assistant' and message['content'] is none %}{%- set ns.is_tool = "
    "false -%}{%- for tool in message['tool_calls']%}{%- if not "
    "ns.is_first %}{{'<｜Assistant｜><｜tool▁calls▁begin｜><｜tool▁call▁"
    "begin｜>' + tool['type'] + '<｜tool▁sep｜>' + tool['function']['name']"
    " + '\\n' + '```json' + '\\n' + tool['function']['arguments'] + '\\n' "
    "+ '```' + '<｜tool▁call▁end｜>'}}{%- set ns.is_first = true -%}{%- "
    "else %}{{'\\n' + '<｜tool▁call▁begin｜>' + tool['type'] + '<｜tool▁"
    "sep｜>' + tool['function']['name'] + '\\n' + '```json' + '\\n' + "
    "tool['function']['arguments'] + '\\n' + '```' + '<｜tool▁call▁end｜>'"
    "}}{{'<｜tool▁calls▁end｜><｜end▁of▁sentence｜>'}}{%- endif %}{%- "
    "endfor %}{%- endif %}{%- if message['role'] == 'assistant' and "
    "message['content'] is not none %}{%- if ns.is_tool %}{{'<｜tool▁"
    "outputs▁end｜>' + message['content'] + '<｜end▁of▁sentence｜>'}}{%- "
    "set ns.is_tool = false -%}{%- else %}{% set content = message["
    "'content'] %}{% if '</think>' in content %}{% set content = "
    "content.split('</think>')[-1] %}{% endif %}{{'<｜Assistant｜>' + "
    "content + '<｜end▁of▁sentence｜>'}}{%- endif %}{%- endif %}{%- if "
    "message['role'] == 'tool' %}{%- set ns.is_tool = true -%}{%- if "
    "ns.is_output_first %}{{'<｜tool▁outputs▁begin｜><｜tool▁output▁begin"
    "｜>' + message['content'] + '<｜tool▁output▁end｜>'}}{%- set "
    "ns.is_output_first = false %}{%- else %}{{'\\n<｜tool▁output▁begin｜>'"
    " + message['content'] + '<｜tool▁output▁end｜>'}}{%- endif %}{%- "
    "endif %}{%- endfor -%}{% if ns.is_tool %}{{'<｜tool▁outputs▁end｜>'}}"
    "{% endif %}{% if add_generation_prompt and not ns.is_tool %}{{'<｜"
    "Assistant｜><think>\\n'}}{% endif %}")

FAMILIES = {"llama3.1": LLAMA31, "qwen2.5": QWEN25,
            "mistral_v0.3": MISTRAL_V03,
            "deepseek_r1_distill": DEEPSEEK_R1_DISTILL}

_TEXT = st.text(alphabet=" \n\t{}%#-+abcé1'\"\\<>/|", max_size=10).map(
    lambda s: s.replace("</", "</think>"))
_CALL = st.fixed_dictionaries({
    "id": st.sampled_from(["abcdefghi", "short", "123456789"]),
    "type": st.just("function"),
    "function": st.fixed_dictionaries({
        "name": st.sampled_from(["get_weather", "f"]),
        "arguments": st.one_of(st.just('{"city": "Paris"}'),
                               st.fixed_dictionaries({"city": _TEXT}))}),
})


@st.composite
def _message(draw):
    role = draw(st.sampled_from(["system", "user", "assistant", "tool"]))
    m = {"role": role, "content": draw(_TEXT)}
    if role == "assistant" and draw(st.booleans()):
        m["tool_calls"] = draw(st.lists(_CALL, min_size=1, max_size=2))
        if draw(st.booleans()):
            m["content"] = None
    if role == "tool":
        m["tool_call_id"] = draw(st.sampled_from(["abcdefghi", "x"]))
    return m


@st.composite
def _conversation(draw):
    msgs = draw(st.lists(_message(), min_size=1, max_size=6))
    if draw(st.booleans()):
        # a well-formed exchange, so the templates' happy paths run too
        msgs = [{"role": "system", "content": draw(_TEXT)}] if draw(
            st.booleans()) else []
        for i in range(draw(st.integers(1, 3))):
            msgs.append({"role": "user", "content": draw(_TEXT)})
            msgs.append({"role": "assistant", "content": draw(_TEXT)})
        msgs.pop()
    return msgs


@pytest.mark.parametrize("family", sorted(FAMILIES))
@settings(max_examples=80, deadline=None)
@given(messages=_conversation(),
       tools=st.one_of(st.none(), st.just(TOOLS)),
       add=st.booleans(), clock=st.booleans(),
       extra=st.sampled_from([{}, {"date_string": "1 Jan 2025"},
                              {"tools_in_user_message": False}]))
def test_family_templates_render_as_jinja2(family, messages, tools, add,
                                           clock, extra):
    ctx = dict(messages=messages, tools=tools, add_generation_prompt=add,
               bos_token="<s>", eos_token="</s>", **extra)
    if clock:
        ctx["strftime_now"] = lambda fmt: "18 Oct 2026"
    got, want = _both(FAMILIES[family], **ctx)
    assert got == want


def _tokenizer_config(d, **cfg):
    d.mkdir(parents=True, exist_ok=True)
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    return str(d)


@pytest.mark.parametrize("cfg", [
    dict(chat_template=LLAMA31, bos_token="<|begin_of_text|>",
         eos_token="<|eot_id|>"),
    dict(chat_template=[{"name": "tool_use", "template": QWEN25},
                        {"name": "default", "template": MISTRAL_V03}],
         bos_token={"content": "<s>", "lstrip": False},
         eos_token={"content": "</s>"}),
    dict(chat_template=[{"name": "rag", "template": QWEN25}]),
    dict(bos_token=None, eos_token="<|im_end|>"),
    None,
], ids=["string", "named_list", "list_without_default", "no_template",
        "no_file"])
def test_prompt_formatter_from_dir_matches_the_reference(tmp_path, cfg):
    d = tmp_path / "m"
    d.mkdir()
    if cfg is not None:
        _tokenizer_config(d, **cfg)
    p = ppre.PromptFormatter.from_dir(str(d))
    r = rpre.PromptFormatter.from_dir(str(d))
    assert (p.template, p.bos_token, p.eos_token) == \
        (r.template, r.bos_token, r.eos_token)
    msgs = [{"role": "system", "content": "sys"},
            {"role": "user", "content": "hi"}]
    assert _outcome(lambda: p.render(msgs)) == _outcome(
        lambda: r.render(msgs))
