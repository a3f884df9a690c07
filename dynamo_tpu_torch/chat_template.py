"""The part of Jinja that chat templates use, on the standard library.

Stands in for ``jinja2`` in the preprocessor's ``PromptFormatter`` (the
JAX package renders with ``jinja2.Environment(trim_blocks=True,
lstrip_blocks=True)``, a ``tojson`` filter that is ``json.dumps`` and a
``raise_exception`` global). The subset:

- statements: ``{% for NAME in EXPR %}`` (``loop.first``, ``loop.last``,
  ``loop.index``, ``loop.index0``), ``{% if %}``/``{% elif %}``/
  ``{% else %}``, ``{% set NAME = EXPR %}``; comments ``{# #}``;
- expressions: names, attribute and item access, string and integer
  literals, ``true``/``false``/``none``, parentheses, ``+``, ``==``,
  ``!=``, ``in``, ``not in``, ``and``, ``or``, ``not``;
- filters ``trim`` and ``tojson``; the call ``raise_exception(msg)``;
- whitespace as Jinja's lexer treats it: ``trim_blocks``,
  ``lstrip_blocks``, the ``-``/``+`` markers, newlines normalised to
  ``\\n`` and one trailing newline dropped.

Rendering follows Jinja's semantics: attribute access tries the
attribute, then the item; a missing name or key is undefined (prints
nothing, iterates empty, is false) and any other use of it raises
``UndefinedError``; a ``set`` inside a loop body lasts for that
iteration. A template that uses anything outside the subset raises
``ValueError`` naming the construct when it is compiled, so it never
renders wrongly.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Any, Optional

_NEWLINE = re.compile(r"\r\n|\r|\n")
# text up to the next tag opening, and the opening's whitespace marker
_OPEN = re.compile(r"(.*?)(\{\{|\{%|\{#)([-+]?)", re.S)
_WS = re.compile(r"\s+")
_ENDS = {
    "{%": re.compile(r"\+%\}|-%\}\s*|%\}\n?"),   # trim_blocks: one \n
    "{{": re.compile(r"-\}\}\s*|\}\}"),
}
_COMMENT = re.compile(r"(.*?)(\+#\}|-#\}\s*|#\}\n?)", re.S)
_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<int>(?:[1-9](?:_?\d)*|0(?:_?0)*)(?![\w.]))
  | (?P<name>[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<op>==|!=|[-+*/%~<>=!.,:;|()\[\]{}]|\*\*|//|<=|>=)
""", re.S | re.X)
_OPS = {"==", "!=", "+", ".", ",", "|", "(", ")", "[", "]", "="}
_STATEMENTS = {"for", "endfor", "if", "elif", "else", "endif", "set"}
_LOOP_ATTRS = {"first", "last", "index", "index0"}
_FILTERS = {"trim", "tojson"}
_LITERALS = {"true": True, "True": True, "false": False, "False": False,
             "none": None, "None": None}


class UndefinedError(Exception):
    """An undefined value was used other than printed, iterated, tested
    for truth or compared (Jinja's ``UndefinedError``)."""


class Undefined:
    """A missing name, attribute or item (Jinja's default ``Undefined``)."""

    __slots__ = ("_name",)

    def __init__(self, name: str = ""):
        self._name = name

    def _fail(self, *_a, **_k):
        raise UndefinedError(f"{self._name!r} is undefined")

    __add__ = __radd__ = __lt__ = __le__ = __gt__ = __ge__ = _fail
    __getitem__ = __call__ = __int__ = __float__ = _fail

    def __getattr__(self, name):
        if name[:2] == "__":
            raise AttributeError(name)
        self._fail()

    def __str__(self) -> str:
        return ""

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 0

    def __bool__(self) -> bool:
        return False

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return id(type(self))

    def __repr__(self) -> str:
        return "Undefined"


def _getattr(obj, name):
    try:
        return getattr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return Undefined(name)


def _getitem(obj, key):
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            try:
                return getattr(obj, key)
            except AttributeError:
                pass
        return Undefined(str(key))


def _raise_exception(msg):
    raise ValueError(msg)


def _tojson(value, **kw):
    return json.dumps(value, **kw)


def _trim(value, chars=None):
    return str(value).strip(chars)


_FILTER_FNS = {"trim": _trim, "tojson": _tojson}


# ---------------------------------------------------------------------------
# lexing


@dataclass
class _Tok:
    kind: str   # "name" | "int" | "str" | "op"
    value: Any


def _unsupported(what: str) -> ValueError:
    return ValueError(f"chat template: unsupported {what}")


def _lex_expr(src: str, pos: int, end_re) -> tuple[list[_Tok], int, str]:
    """Tokens of one tag from ``pos`` up to its end marker; returns the
    tokens, the position after the marker and the marker's text."""
    toks: list[_Tok] = []
    depth = 0
    while True:
        if pos >= len(src):
            raise ValueError("chat template: tag not closed")
        if depth == 0:
            m = end_re.match(src, pos)
            if m:
                return toks, m.end(), m.group()
        m = _TOKEN.match(src, pos)
        if m is None:
            raise _unsupported(f"character {src[pos]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind == "ws":
            continue
        if kind == "int":
            toks.append(_Tok("int", int(text.replace("_", ""))))
        elif kind == "str":
            body = _NEWLINE.sub("\n", text[1:-1])
            toks.append(_Tok("str", body.encode(
                "ascii", "backslashreplace").decode("unicode-escape")))
        elif kind == "name":
            toks.append(_Tok("name", text))
        else:
            if text not in _OPS:
                raise _unsupported(f"operator {text!r}")
            if text in ("(", "["):
                depth += 1
            elif text in (")", "]"):
                depth -= 1
            if depth < 0:
                raise ValueError(f"chat template: unexpected {text!r}")
            toks.append(_Tok("op", text))


def _lex(source: str) -> list[tuple[str, Any]]:
    """("data", text) | ("block", tokens) | ("var", tokens), with Jinja's
    whitespace rules under trim_blocks and lstrip_blocks applied."""
    src = _NEWLINE.sub("\n", source)
    if src.endswith("\n"):
        src = src[:-1]
    out: list[tuple[str, Any]] = []
    pos = 0
    line_starting = True
    while pos < len(src):
        m = _OPEN.match(src, pos)
        if m is None:
            out.append(("data", src[pos:]))
            break
        text, opener, sign = m.groups()
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and opener != "{{":
            # lstrip_blocks: a block or comment tag preceded on its line by
            # whitespace only takes that whitespace away
            l_pos = text.rfind("\n") + 1
            if (l_pos > 0 or line_starting) and _WS.fullmatch(text, l_pos):
                text = text[:l_pos]
        if text:
            out.append(("data", text))
        if opener == "{#":
            c = _COMMENT.match(src, m.end())
            if c is None:
                raise ValueError("chat template: comment not closed")
            pos, end = c.end(), c.group(2)
        else:
            toks, pos, end = _lex_expr(src, m.end(), _ENDS[opener])
            out.append(("block" if opener == "{%" else "var", toks))
        line_starting = end.endswith("\n")
    return out


# ---------------------------------------------------------------------------
# parsing: statements become nested lists of nodes, expressions tuples


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, kind=None, value=None) -> Optional[_Tok]:
        if self.i >= len(self.toks):
            return None
        t = self.toks[self.i]
        if (kind is None or t.kind == kind) and (value is None
                                                 or t.value == value):
            return t
        return None

    def take(self, kind=None, value=None) -> _Tok:
        t = self.peek(kind, value)
        if t is None:
            got = self.toks[self.i].value if self.i < len(self.toks) else \
                "end of tag"
            raise ValueError(f"chat template: expected {value or kind}, got "
                             f"{got!r}")
        self.i += 1
        return t

    def done(self) -> None:
        if self.i != len(self.toks):
            raise _unsupported(f"syntax near {self.toks[self.i].value!r}")

    def expr(self):
        node = self.and_()
        while self.peek("name", "or"):
            self.i += 1
            node = ("or", node, self.and_())
        return node

    def and_(self):
        node = self.not_()
        while self.peek("name", "and"):
            self.i += 1
            node = ("and", node, self.not_())
        return node

    def not_(self):
        if self.peek("name", "not"):
            self.i += 1
            return ("not", self.not_())
        return self.compare()

    def compare(self):
        first = self.add()
        ops = []
        while True:
            if self.peek("op", "==") or self.peek("op", "!="):
                op = self.take().value
            elif self.peek("name", "in"):
                self.i += 1
                op = "in"
            elif (self.peek("name", "not") and self.i + 1 < len(self.toks)
                  and self.toks[self.i + 1].kind == "name"
                  and self.toks[self.i + 1].value == "in"):
                self.i += 2
                op = "not in"
            elif self.peek("name", "is"):
                raise _unsupported("test 'is'")
            else:
                break
            ops.append((op, self.add()))
        return ("cmp", first, ops) if ops else first

    def add(self):
        node = self.filtered()
        while self.peek("op", "+"):
            self.i += 1
            node = ("add", node, self.filtered())
        return node

    def filtered(self):
        node = self.postfix(self.primary())
        while self.peek("op", "|"):
            self.i += 1
            name = self.take("name").value
            if name not in _FILTERS:
                raise _unsupported(f"filter {name!r}")
            args, kwargs = self.call_args() if self.peek("op", "(") else \
                ([], {})
            node = ("filter", name, node, args, kwargs)
        return node

    def call_args(self):
        self.take("op", "(")
        args, kwargs = [], {}
        while not self.peek("op", ")"):
            if (self.peek("name") and self.i + 1 < len(self.toks)
                    and self.toks[self.i + 1].value == "="
                    and self.toks[self.i + 1].kind == "op"):
                key = self.take().value
                self.i += 1
                kwargs[key] = self.expr()
            else:
                args.append(self.expr())
            if not self.peek("op", ")"):
                self.take("op", ",")
        self.take("op", ")")
        return args, kwargs

    def primary(self):
        t = self.take()
        if t.kind == "str":
            s = t.value
            while self.peek("str"):  # adjacent literals concatenate
                s += self.take().value
            return ("const", s)
        if t.kind == "int":
            return ("const", t.value)
        if t.kind == "name":
            if t.value in _LITERALS:
                return ("const", _LITERALS[t.value])
            if t.value in ("and", "or", "not", "in", "is", "if", "else"):
                raise _unsupported(f"syntax near {t.value!r}")
            if t.value == "raise_exception" and self.peek("op", "("):
                args, kwargs = self.call_args()
                if len(args) != 1 or kwargs:
                    raise ValueError("chat template: raise_exception takes "
                                     "one message")
                return ("raise", args[0])
            if t.value == "loop":
                self.take("op", ".")
                attr = self.take("name").value
                if attr not in _LOOP_ATTRS:
                    raise _unsupported(f"loop attribute 'loop.{attr}'")
                return ("loop", attr)
            return ("name", t.value)
        if t.value == "(":
            node = self.expr()
            if self.peek("op", ","):
                raise _unsupported("tuple")
            self.take("op", ")")
            return node
        if t.value == "[":
            raise _unsupported("list literal")
        raise _unsupported(f"syntax near {t.value!r}")

    def postfix(self, node):
        while True:
            if self.peek("op", "."):
                self.i += 1
                node = ("attr", node, self.take("name").value)
            elif self.peek("op", "["):
                self.i += 1
                key = self.expr()
                self.take("op", "]")
                node = ("item", node, key)
            elif self.peek("op", "("):
                raise _unsupported("call (only raise_exception(...) is "
                                   "supported)")
            else:
                return node


def _parse(source: str) -> list:
    """The template as a body: a list of ("data", s) | ("out", expr) |
    ["for", var, expr, body] | ["if", [(cond, body), ...], else_body] |
    ("set", name, expr)."""
    root: list = []
    # (statement, node, the body that takes the next nodes)
    stack: list[tuple[str, Any, list]] = [("root", None, root)]
    for kind, val in _lex(source):
        body = stack[-1][2]
        if kind == "data":
            body.append(("data", val))
            continue
        p = _Parser(val)
        if kind == "var":
            node = p.expr()
            p.done()
            body.append(("out", node))
            continue
        word = p.take("name").value
        if word not in _STATEMENTS:
            raise _unsupported(f"statement {{% {word} %}}")
        if word == "for":
            var = p.take("name").value
            if p.peek("op", ","):
                raise _unsupported("for-loop with several targets")
            p.take("name", "in")
            seq = p.expr()
            if p.peek("name", "if") or p.peek("name", "recursive"):
                raise _unsupported(f"for-loop {p.toks[p.i].value!r}")
            p.done()
            node = ["for", var, seq, []]
            body.append(node)
            stack.append(("for", node, node[3]))
        elif word == "if":
            cond = p.expr()
            p.done()
            node = ["if", [(cond, [])], None]
            body.append(node)
            stack.append(("if", node, node[1][0][1]))
        elif word in ("elif", "else"):
            top, node, _ = stack[-1]
            if top == "for" and word == "else":
                raise _unsupported("{% else %} in a for-loop")
            if top != "if" or node[2] is not None:
                raise ValueError(f"chat template: unexpected {{% {word} %}}")
            if word == "elif":
                branch: list = []
                node[1].append((p.expr(), branch))
            else:
                branch = node[2] = []
            p.done()
            stack[-1] = ("if", node, branch)
        elif word in ("endfor", "endif"):
            p.done()
            if stack[-1][0] != word[3:]:
                raise ValueError(f"chat template: unexpected {{% {word} %}}")
            stack.pop()
        else:  # set
            name = p.take("name").value
            if p.peek("op", ".") or p.peek("op", ","):
                raise _unsupported("set target other than a name")
            if not p.peek("op", "="):
                raise _unsupported("block {% set %}")
            p.i += 1
            value = p.expr()
            p.done()
            body.append(("set", name, value))
    if len(stack) != 1:
        raise ValueError(f"chat template: {{% {stack[-1][0]} %}} not closed")
    return root


# ---------------------------------------------------------------------------
# rendering


class _Loop:
    __slots__ = ("index0", "length")

    def __init__(self, length: int):
        self.index0 = 0
        self.length = length


def _lookup(scopes: list[dict], name: str):
    for s in reversed(scopes):
        if name in s:
            return s[name]
    return Undefined(name)


def _eval(node, scopes: list[dict], loop: Optional[_Loop]):
    op = node[0]
    if op == "const":
        return node[1]
    if op == "name":
        return _lookup(scopes, node[1])
    if op == "attr":
        return _getattr(_eval(node[1], scopes, loop), node[2])
    if op == "item":
        return _getitem(_eval(node[1], scopes, loop),
                        _eval(node[2], scopes, loop))
    if op == "loop":
        if loop is None:
            raise UndefinedError("'loop' is undefined")
        return {"first": loop.index0 == 0,
                "last": loop.index0 == loop.length - 1,
                "index": loop.index0 + 1,
                "index0": loop.index0}[node[1]]
    if op == "add":
        return _eval(node[1], scopes, loop) + _eval(node[2], scopes, loop)
    if op == "and":
        left = _eval(node[1], scopes, loop)
        return _eval(node[2], scopes, loop) if left else left
    if op == "or":
        left = _eval(node[1], scopes, loop)
        return left if left else _eval(node[2], scopes, loop)
    if op == "not":
        return not _eval(node[1], scopes, loop)
    if op == "cmp":
        left = _eval(node[1], scopes, loop)
        for cop, rnode in node[2]:
            right = _eval(rnode, scopes, loop)
            ok = (left == right if cop == "==" else
                  left != right if cop == "!=" else
                  left in right if cop == "in" else left not in right)
            if not ok:
                return False
            left = right
        return True
    if op == "filter":
        _, name, arg, args, kwargs = node
        return _FILTER_FNS[name](
            _eval(arg, scopes, loop),
            *[_eval(a, scopes, loop) for a in args],
            **{k: _eval(v, scopes, loop) for k, v in kwargs.items()})
    if op == "raise":
        _raise_exception(_eval(node[1], scopes, loop))
    raise AssertionError(f"unknown node {op}")


def _render(body: list, scopes: list[dict], loop: Optional[_Loop],
            out: list[str]) -> None:
    for node in body:
        kind = node[0]
        if kind == "data":
            out.append(node[1])
        elif kind == "out":
            out.append(str(_eval(node[1], scopes, loop)))
        elif kind == "set":
            scopes[-1][node[1]] = _eval(node[2], scopes, loop)
        elif kind == "if":
            for cond, branch in node[1]:
                if _eval(cond, scopes, loop):
                    _render(branch, scopes, loop, out)
                    break
            else:
                if node[2] is not None:
                    _render(node[2], scopes, loop, out)
        else:  # for
            _, var, seq_node, inner = node
            items = list(_eval(seq_node, scopes, loop))
            it = _Loop(len(items))
            for i, item in enumerate(items):
                it.index0 = i
                # a loop body's assignments last for one iteration
                _render(inner, scopes + [{var: item}], it, out)


class ChatTemplate:
    """A compiled template: ``ChatTemplate(src).render(**context)``.
    Raises ``ValueError`` at construction for anything outside the
    subset."""

    def __init__(self, source: str):
        self._body = _parse(source)

    def render(self, **context: Any) -> str:
        out: list[str] = []
        _render(self._body, [dict(context)], None, out)
        return "".join(out)
