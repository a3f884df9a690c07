"""The part of Jinja that chat templates use, on the standard library.

Stands in for ``jinja2`` in the preprocessor's ``PromptFormatter`` (the
JAX package renders with ``jinja2.Environment(trim_blocks=True,
lstrip_blocks=True)``, a ``tojson`` filter that is ``json.dumps`` and a
``raise_exception`` global). The subset covers the published instruct
templates of the Llama 3.1/3.2, Qwen2.5, Mistral v0.3 and
DeepSeek-R1-Distill families:

- statements: ``{% for TARGET in EXPR [if COND] %}`` (one name or
  ``k, v``; ``loop.first``, ``last``, ``index``, ``index0``,
  ``length``, ``previtem``, ``nextitem``),
  ``{% if %}``/``{% elif %}``/``{% else %}``, ``{% set NAME = EXPR %}``
  and ``{% set NAME.ATTR = EXPR %}`` on a ``namespace``, ``{% macro
  NAME(ARGS) %}`` (arguments with defaults, called as ``NAME(...)``);
  comments ``{# #}``;
- expressions: names, attribute and item access, slices, string and
  integer literals, list literals, ``true``/``false``/``none``,
  parentheses, ``x if c else y``, ``+``, ``-``, ``%``, ``~``, unary
  ``-``, ``==``, ``!=``, ``in``, ``not in``, ``and``, ``or``, ``not``,
  and the tests ``is [not] defined``, ``undefined``, ``none``,
  ``string``, ``mapping``, ``iterable`` and ``equalto`` (``eq``);
- the methods ``get``, ``items``, ``strip``, ``split``, ``startswith``
  and ``endswith`` (a call on anything else is refused);
- the filters ``trim``, ``tojson``, ``length``, ``join``, ``default``,
  ``first``, ``last``, ``lower``, ``upper``, ``replace``, ``string``,
  ``list``, ``items``, ``map``, ``select``, ``reject`` and
  ``selectattr`` (the last five lazy, as Jinja's);
- the globals ``raise_exception(msg)``, ``namespace(...)``, and
  ``strftime_now(fmt)`` when the caller passes one in the context
  (HF's ``apply_chat_template`` does; the preprocessor, like the JAX
  package's, does not, so ``strftime_now is defined`` is false there);
- whitespace as Jinja's lexer treats it: ``trim_blocks``,
  ``lstrip_blocks``, the ``-``/``+`` markers, newlines normalised to
  ``\\n`` and one trailing newline dropped.

Rendering follows Jinja's semantics: attribute access tries the
attribute, then the item; a missing name or key is undefined (prints
nothing, iterates empty, is false) and any other use of it raises
``UndefinedError``; a ``set`` inside a loop body lasts for that
iteration. A template that uses anything outside the subset (``raw``,
``set`` blocks, ``for ... else``, float literals, dict literals,
tuples, ``call`` blocks, ``include``, other filters, tests and calls)
raises ``ValueError`` naming the construct when it is compiled, so it
never renders wrongly.
"""
from __future__ import annotations

import json
import re
from collections import abc
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
  | (?P<op>==|!=|<=|>=|\*\*|//|[-+*/%~<>=!.,:;|()\[\]{}])
""", re.S | re.X)
_OPS = {"==", "!=", "+", "-", "%", "~", ".", ",", ":", "|", "(", ")", "[",
        "]", "="}
_STATEMENTS = {"for", "endfor", "if", "elif", "else", "endif", "set",
               "macro", "endmacro"}
_LOOP_ATTRS = {"first", "last", "index", "index0", "length", "previtem",
               "nextitem"}
_METHODS = {"get", "items", "strip", "split", "startswith", "endswith"}
_GLOBALS = {"raise_exception", "namespace", "strftime_now"}
_LITERALS = {"true": True, "True": True, "false": False, "False": False,
             "none": None, "None": None}
_KEYWORDS = {"and", "or", "not", "in", "is", "if", "else"}


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

    __add__ = __radd__ = __sub__ = __rsub__ = __mod__ = __rmod__ = _fail
    __neg__ = __lt__ = __le__ = __gt__ = __ge__ = _fail
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


class Namespace:
    """Jinja's ``namespace(...)``: attributes a ``set ns.attr`` may change
    from inside a loop."""

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "_attrs", dict(*args, **kwargs))

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_attrs")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self._attrs[name] = value

    def __repr__(self) -> str:
        return f"<Namespace {self._attrs!r}>"


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


def _attr_path(item, attribute, default=None):
    """Jinja's attribute getter of ``map``/``selectattr``: item first,
    then attribute, along a dotted path (integer parts index)."""
    parts = (attribute.split(".") if isinstance(attribute, str)
             else [attribute])
    for part in parts:
        if isinstance(part, str) and part.isdigit():
            part = int(part)
        item = _getitem(item, part)
        if isinstance(item, Undefined) and default is not None:
            return default
    return item


def _first(seq):
    for x in seq:
        return x
    return Undefined("first")


def _last(seq):
    for x in reversed(seq):
        return x
    return Undefined("last")


def _join(value, d="", attribute=None):
    if attribute is not None:
        value = (_attr_path(x, attribute) for x in value)
    return str(d).join(map(str, value))


def _default(value, default_value="", boolean=False):
    if isinstance(value, Undefined) or (boolean and not value):
        return default_value
    return value


def _replace(s, old, new, count=None):
    return str(s).replace(str(old), str(new), -1 if count is None else count)


def _items(value):
    if isinstance(value, Undefined):
        return iter(())
    if not isinstance(value, abc.Mapping):
        raise TypeError("Can only get item pairs from a mapping.")
    return iter(value.items())


def _map(value, *args, **kwargs):
    if "attribute" in kwargs:
        attr, default = kwargs["attribute"], kwargs.get("default")
        return (_attr_path(x, attr, default) for x in value)
    name, rest = args[0], args[1:]
    if name not in _FILTER_FNS:
        raise ValueError(f"chat template: unsupported filter {name!r} in "
                         "map")
    fn = _FILTER_FNS[name]
    return (fn(x, *rest, **kwargs) for x in value)


def _test_fn(name):
    if name not in _TEST_FNS:
        raise ValueError(f"chat template: unsupported test {name!r}")
    return _TEST_FNS[name]


def _select(value, test=None, *args, keep=True):
    fn = _test_fn(test) if test is not None else bool
    return (x for x in value if bool(fn(x, *args)) == keep)


def _selectattr(value, attr, test=None, *args, keep=True):
    fn = _test_fn(test) if test is not None else bool
    return (x for x in value if bool(fn(_attr_path(x, attr), *args)) == keep)


_FILTER_FNS = {
    "trim": _trim, "tojson": _tojson, "length": len, "join": _join,
    "default": _default, "first": _first, "last": _last,
    "lower": lambda s: str(s).lower(), "upper": lambda s: str(s).upper(),
    "replace": _replace, "string": str, "list": list, "map": _map,
    "items": _items, "select": _select,
    "reject": lambda v, *a: _select(v, *a, keep=False),
    "selectattr": _selectattr,
}


def _is_iterable(v) -> bool:
    try:
        iter(v)
    except TypeError:
        return False
    return True


_TEST_FNS = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, abc.Mapping),
    "iterable": _is_iterable,
    "eq": lambda v, o: v == o, "equalto": lambda v, o: v == o,
}

_BINOPS = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "%": lambda a, b: a % b,
}
_CMPS = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "in": lambda a, b: a in b, "not in": lambda a, b: a not in b,
}


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
# (Jinja's grammar: condexpr > or > and > not > compare > + - > ~ > % >
# unary - > postfix, filters and tests)


class _Parser:
    def __init__(self, toks: list[_Tok], macros: set[str]):
        self.toks = toks
        self.i = 0
        self.macros = macros

    def peek(self, kind=None, value=None, ahead: int = 0) -> Optional[_Tok]:
        if self.i + ahead >= len(self.toks):
            return None
        t = self.toks[self.i + ahead]
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

    def skip(self, kind, value) -> bool:
        if self.peek(kind, value):
            self.i += 1
            return True
        return False

    def done(self) -> None:
        if self.i != len(self.toks):
            raise _unsupported(f"syntax near {self.toks[self.i].value!r}")

    def expr(self, condexpr: bool = True):
        node = self.or_()
        while condexpr and self.skip("name", "if"):
            cond = self.or_()
            other = self.expr() if self.skip("name", "else") else None
            node = ("cond", cond, node, other)
        return node

    def or_(self):
        node = self.and_()
        while self.skip("name", "or"):
            node = ("or", node, self.and_())
        return node

    def and_(self):
        node = self.not_()
        while self.skip("name", "and"):
            node = ("and", node, self.not_())
        return node

    def not_(self):
        if self.skip("name", "not"):
            return ("not", self.not_())
        return self.compare()

    def compare(self):
        first = self.math1()
        ops = []
        while True:
            t = self.peek("op")
            if t is not None and t.value in ("==", "!="):
                self.i += 1
                op = t.value
            elif self.skip("name", "in"):
                op = "in"
            elif self.peek("name", "not") and self.peek("name", "in", 1):
                self.i += 2
                op = "not in"
            else:
                break
            ops.append((op, self.math1()))
        return ("cmp", first, ops) if ops else first

    def _binary(self, ops, inner):
        node = inner()
        while True:
            t = self.peek("op")
            if t is None or t.value not in ops:
                return node
            self.i += 1
            node = ("bin", t.value, node, inner())

    def math1(self):
        return self._binary(("+", "-"), self.concat)

    def concat(self):
        node = self.math2()
        while self.skip("op", "~"):
            node = ("concat", node, self.math2())
        return node

    def math2(self):
        return self._binary(("%",), self.unary)

    def unary(self, with_filter: bool = True):
        if self.skip("op", "-"):
            node = ("neg", self.unary(False))
        elif self.skip("op", "+"):
            node = self.unary(False)
        else:
            node = self.primary()
        node = self.postfix(node)
        return self.filters(node) if with_filter else node

    def filters(self, node):
        while True:
            if self.skip("op", "|"):
                name = self.take("name").value
                if name not in _FILTER_FNS:
                    raise _unsupported(f"filter {name!r}")
                args, kwargs = self.call_args() if self.peek("op", "(") \
                    else ([], {})
                node = ("filter", name, node, args, kwargs)
            elif self.skip("name", "is"):
                negated = self.skip("name", "not")
                name = self.take("name").value
                if name not in _TEST_FNS:
                    raise _unsupported(f"test {name!r}")
                if self.peek("op", "("):
                    args, kwargs = self.call_args()
                    if kwargs:
                        raise _unsupported("keyword arguments to a test")
                elif ((self.peek("name") and self.toks[self.i].value not in
                       ("else", "or", "and"))
                      or self.peek("str") or self.peek("int")
                      or self.peek("op", "[")):
                    args = [self.postfix(self.primary())]
                else:
                    args = []
                node = ("test", name, node, args)
                if negated:
                    node = ("not", node)
            else:
                return node

    def call(self, callee):
        args, kwargs = self.call_args()
        if callee[0] == "attr" and callee[2] in _METHODS:
            return ("call", callee, args, kwargs)
        if callee[0] == "name" and (callee[1] in _GLOBALS
                                    or callee[1] in self.macros):
            if callee[1] == "raise_exception" and (len(args) != 1 or kwargs):
                raise ValueError("chat template: raise_exception takes "
                                 "one message")
            return ("call", callee, args, kwargs)
        what = callee[2] if callee[0] == "attr" else callee[1] \
            if callee[0] == "name" else callee[0]
        raise _unsupported(f"call of {what!r}")

    def call_args(self):
        self.take("op", "(")
        args, kwargs = [], {}
        while not self.peek("op", ")"):
            if self.peek("name") and self.peek("op", "=", 1):
                key = self.take().value
                self.i += 1
                kwargs[key] = self.expr()
            else:
                if kwargs:
                    raise ValueError("chat template: positional argument "
                                     "after a keyword argument")
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
            if t.value in _KEYWORDS:
                raise _unsupported(f"syntax near {t.value!r}")
            if t.value == "loop" and self.peek("op", "."):
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
            items = []
            while not self.peek("op", "]"):
                items.append(self.expr())
                if not self.peek("op", "]"):
                    self.take("op", ",")
            self.take("op", "]")
            return ("list", items)
        raise _unsupported(f"syntax near {t.value!r}")

    def postfix(self, node):
        while True:
            if self.skip("op", "."):
                t = self.take()
                if t.kind == "int":   # x.0 is x[0] in Jinja
                    node = ("item", node, ("const", t.value))
                else:
                    node = ("attr", node, t.value)
            elif self.skip("op", "["):
                node = ("item", node, self.subscript())
                self.take("op", "]")
            elif self.peek("op", "("):
                node = self.call(node)
            else:
                return node

    def subscript(self):
        parts: list = [None]
        if not self.peek("op", ":"):
            parts[0] = self.expr()
            if not self.peek("op", ":"):
                return parts[0]
        while self.skip("op", ":"):
            parts.append(None if self.peek("op", ":") or self.peek("op", "]")
                         else self.expr())
        if len(parts) > 3:
            raise _unsupported("slice")
        return ("slice", parts + [None] * (3 - len(parts)))

    def target(self) -> tuple[str, ...]:
        names = [self.take("name").value]
        while self.skip("op", ","):
            names.append(self.take("name").value)
        return tuple(names)


def _macro_names(lexed) -> set[str]:
    names = set()
    for kind, val in lexed:
        if (kind == "block" and len(val) > 1 and val[0].value == "macro"
                and val[1].kind == "name"):
            names.add(val[1].value)
    return names


def _parse(source: str) -> list:
    """The template as a body: a list of ("data", s) | ("out", expr) |
    ["for", targets, expr, cond, body] | ["if", [(cond, body), ...],
    else_body] | ("set", name, attr, expr) | ["macro", name, params,
    body]."""
    lexed = _lex(source)
    macros = _macro_names(lexed)
    root: list = []
    # (statement, node, the body that takes the next nodes)
    stack: list[tuple[str, Any, list]] = [("root", None, root)]
    for kind, val in lexed:
        body = stack[-1][2]
        if kind == "data":
            body.append(("data", val))
            continue
        p = _Parser(val, macros)
        if kind == "var":
            node = p.expr()
            p.done()
            body.append(("out", node))
            continue
        word = p.take("name").value
        if word not in _STATEMENTS:
            raise _unsupported(f"statement {{% {word} %}}")
        if word == "for":
            targets = p.target()
            p.take("name", "in")
            seq = p.expr(condexpr=False)
            cond = p.expr() if p.skip("name", "if") else None
            if p.peek("name", "recursive"):
                raise _unsupported("for-loop 'recursive'")
            p.done()
            node = ["for", targets, seq, cond, []]
            body.append(node)
            stack.append(("for", node, node[4]))
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
        elif word in ("endfor", "endif", "endmacro"):
            p.done()
            if stack[-1][0] != word[3:]:
                raise ValueError(f"chat template: unexpected {{% {word} %}}")
            stack.pop()
        elif word == "macro":
            name = p.take("name").value
            p.take("op", "(")
            params: list[tuple[str, Any]] = []
            while not p.peek("op", ")"):
                pname = p.take("name").value
                default = p.expr() if p.skip("op", "=") else None
                params.append((pname, default))
                if not p.peek("op", ")"):
                    p.take("op", ",")
            p.take("op", ")")
            p.done()
            node = ["macro", name, params, []]
            body.append(node)
            stack.append(("macro", node, node[3]))
        else:  # set
            name = p.take("name").value
            attr = p.take("name").value if p.skip("op", ".") else None
            if p.peek("op", ","):
                raise _unsupported("set target other than a name")
            if not p.peek("op", "="):
                raise _unsupported("block {% set %}")
            p.i += 1
            value = p.expr()
            p.done()
            body.append(("set", name, attr, value))
    if len(stack) != 1:
        raise ValueError(f"chat template: {{% {stack[-1][0]} %}} not closed")
    return root


# ---------------------------------------------------------------------------
# rendering


class _Loop:
    __slots__ = ("index0", "items")

    def __init__(self, items: list):
        self.index0 = 0
        self.items = items

    def attr(self, name: str):
        i, n = self.index0, len(self.items)
        if name == "previtem":
            return self.items[i - 1] if i > 0 else Undefined("previtem")
        if name == "nextitem":
            return self.items[i + 1] if i + 1 < n else Undefined("nextitem")
        return {"first": i == 0, "last": i == n - 1, "index": i + 1,
                "index0": i, "length": n}[name]


class _Macro:
    def __init__(self, node, scopes: list[dict]):
        _, self.name, self.params, self.body = node
        self.root = scopes[0]

    def __call__(self, *args, **kwargs):
        if len(args) > len(self.params):
            raise TypeError(f"macro {self.name!r} takes not more than "
                            f"{len(self.params)} argument(s)")
        names = {p for p, _ in self.params}
        for k in kwargs:
            if k not in names:
                raise TypeError(f"macro {self.name!r} takes no keyword "
                                f"argument {k!r}")
        scope: dict = {}
        scopes = [self.root, scope]
        for i, (pname, default) in enumerate(self.params):
            if i < len(args):
                scope[pname] = args[i]
            elif pname in kwargs:
                scope[pname] = kwargs[pname]
            elif default is not None:
                scope[pname] = _eval(default, scopes, None)
            else:
                scope[pname] = Undefined(pname)
        out: list[str] = []
        _render(self.body, scopes, None, out)
        return "".join(out)


def _lookup(scopes: list[dict], name: str):
    for s in reversed(scopes):
        if name in s:
            return s[name]
    if name == "namespace":
        return Namespace
    if name == "raise_exception":
        return _raise_exception
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
        key = node[2]
        if key[0] == "slice":
            key = slice(*[None if k is None else _eval(k, scopes, loop)
                          for k in key[1]])
        else:
            key = _eval(key, scopes, loop)
        return _getitem(_eval(node[1], scopes, loop), key)
    if op == "loop":
        if loop is None:
            raise UndefinedError("'loop' is undefined")
        return loop.attr(node[1])
    if op == "bin":
        return _BINOPS[node[1]](_eval(node[2], scopes, loop),
                                _eval(node[3], scopes, loop))
    if op == "concat":
        return (str(_eval(node[1], scopes, loop))
                + str(_eval(node[2], scopes, loop)))
    if op == "neg":
        return -_eval(node[1], scopes, loop)
    if op == "and":
        left = _eval(node[1], scopes, loop)
        return _eval(node[2], scopes, loop) if left else left
    if op == "or":
        left = _eval(node[1], scopes, loop)
        return left if left else _eval(node[2], scopes, loop)
    if op == "not":
        return not _eval(node[1], scopes, loop)
    if op == "cond":
        if _eval(node[1], scopes, loop):
            return _eval(node[2], scopes, loop)
        return (Undefined("cond") if node[3] is None
                else _eval(node[3], scopes, loop))
    if op == "cmp":
        left = _eval(node[1], scopes, loop)
        for cop, rnode in node[2]:
            right = _eval(rnode, scopes, loop)
            if not _CMPS[cop](left, right):
                return False
            left = right
        return True
    if op == "list":
        return [_eval(x, scopes, loop) for x in node[1]]
    if op == "filter":
        _, name, arg, args, kwargs = node
        return _FILTER_FNS[name](
            _eval(arg, scopes, loop),
            *[_eval(a, scopes, loop) for a in args],
            **{k: _eval(v, scopes, loop) for k, v in kwargs.items()})
    if op == "test":
        _, name, arg, args = node
        return _TEST_FNS[name](_eval(arg, scopes, loop),
                               *[_eval(a, scopes, loop) for a in args])
    if op == "call":
        _, callee, args, kwargs = node
        fn = _eval(callee, scopes, loop)
        return fn(*[_eval(a, scopes, loop) for a in args],
                  **{k: _eval(v, scopes, loop) for k, v in kwargs.items()})
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
            _, name, attr, value = node
            value = _eval(value, scopes, loop)
            if attr is None:
                scopes[-1][name] = value
            else:
                ns = _lookup(scopes, name)
                if not isinstance(ns, Namespace):
                    raise TypeError("cannot assign attribute on "
                                    "non-namespace object")
                setattr(ns, attr, value)
        elif kind == "if":
            for cond, branch in node[1]:
                if _eval(cond, scopes, loop):
                    _render(branch, scopes, loop, out)
                    break
            else:
                if node[2] is not None:
                    _render(node[2], scopes, loop, out)
        elif kind == "macro":
            scopes[-1][node[1]] = _Macro(node, scopes)
        else:  # for
            _, targets, seq_node, cond, inner = node
            items = []
            for item in _eval(seq_node, scopes, loop):
                if cond is not None and not _eval(
                        cond, scopes + [_bind(targets, item)], loop):
                    continue
                items.append(item)
            it = _Loop(items)
            for i, item in enumerate(items):
                it.index0 = i
                # a loop body's assignments last for one iteration
                _render(inner, scopes + [_bind(targets, item)], it, out)


def _bind(targets: tuple[str, ...], item) -> dict:
    if len(targets) == 1:
        return {targets[0]: item}
    values = tuple(item)
    if len(values) != len(targets):
        raise ValueError(f"cannot unpack {len(values)} values into "
                         f"{len(targets)} loop targets")
    return dict(zip(targets, values))


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
