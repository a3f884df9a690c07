"""HF ``tokenizer.json`` on the standard library: the pipeline of the
``tokenizers`` library (the JAX package's ``HfTokenizer`` wraps it),
for the components that Llama-family checkpoints ship.

``TokenizerJson.from_file(path)`` reads the file and refuses, with a
``ValueError`` naming it, every component outside the subset below, so a
text is never tokenized differently in silence. ``encode`` runs the
library's steps in its order:

1. added tokens are split off the raw text (those with ``normalized:
   false``), the rest is normalized and the ``normalized: true`` ones are
   split off it; matching is leftmost-longest, with the ``lstrip``,
   ``rstrip`` and ``single_word`` flags;
2. normalizers: ``NFC``/``NFD``/``NFKC``/``NFKD``, ``Prepend``,
   ``Replace`` (a string pattern), ``Sequence`` (each piece left between
   added tokens is normalized on its own, as the library does);
3. pre-tokenizers: ``Split`` (a regex or a string; ``Isolated``,
   ``Removed``, ``MergedWithNext``),
   ``ByteLevel``, ``Metaspace`` (``prepend_scheme`` always, first or
   never), ``WhitespaceSplit``, ``Sequence``;
4. models: ``BPE`` (merges as ``"a b"`` strings or ``["a", "b"]``
   pairs, ``ignore_merges``, ``byte_fallback``, ``fuse_unk``, the
   library's merge queue) and ``WordLevel``;
5. post-processors (with ``add_special_tokens``): ``TemplateProcessing``
   (its single template), ``ByteLevel``, ``Sequence``.

``decode`` maps ids to tokens (an added token's content first; special
ones dropped with ``skip_special_tokens``; unknown ids dropped) and runs
the decoders ``ByteLevel``, ``Metaspace``, ``Replace``, ``ByteFallback``,
``Fuse``, ``Strip`` and ``Sequence`` (without a decoder, tokens join
with spaces).

Regexes: the library matches with Oniguruma. A ``Split`` pattern is
translated to Python's ``re``: ``\\p{..}`` general categories become
classes built once from ``unicodedata``, ``\\s``/``\\S`` the Unicode
White_Space set (Oniguruma's ``\\s``; Python's own also takes
``\\x1c``-``\\x1f``), and any escape, group or anchor outside the
translated set raises. ``unicodedata`` is Python's Unicode version: a
code point that a later Unicode version assigned (unassigned, ``Cn``,
here) is in no ``\\p`` class here and may be in the library's.
"""
from __future__ import annotations

import functools
import heapq
import json
import re
import sys
import unicodedata
from dataclasses import dataclass
from typing import Any, Callable, Optional

# Unicode White_Space: Oniguruma's \s and the library's whitespace tests
WS_CHARS = frozenset(
    "\t\n\v\f\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200b)))
WHITESPACE = "".join(f"\\U{ord(c):08x}" for c in sorted(WS_CHARS))
_WS_RUN = re.compile(f"[{WHITESPACE}]+")


@functools.lru_cache(maxsize=None)
def _category_ranges() -> dict[str, list[tuple[int, int]]]:
    """Each two-letter general category's code point ranges (one pass
    over the code points, made once)."""
    out: dict[str, list[tuple[int, int]]] = {}
    cat = unicodedata.category
    start, prev = 0, cat("\x00")
    for cp in range(1, sys.maxunicode + 2):
        c = cat(chr(cp)) if cp <= sys.maxunicode else None
        if c != prev:
            out.setdefault(prev, []).append((start, cp - 1))
            start, prev = cp, c
    return out


@functools.lru_cache(maxsize=None)
def _class_body(name: str) -> str:
    """``re`` class text (no brackets) of a general category: one letter
    (L, M, N, P, S, Z: all its subcategories) or two (Lu, Nd, ...)."""
    cats = _category_ranges()
    if len(name) == 1 and name in "LMNPSZ":
        ranges = sorted(r for c, rs in cats.items() if c[0] == name
                        for r in rs)
    elif len(name) == 2 and name[0] in "LMNPSZ" and name in cats:
        ranges = cats[name]
    else:
        raise ValueError(f"tokenizer.json: unsupported regex class "
                         f"\\p{{{name}}}")
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                   for a, b in ranges)


_SIMPLE_ESCAPES = {"r": "\\r", "n": "\\n", "t": "\\t", "f": "\\f",
                   "v": "\\v"}
_GROUP = re.compile(r"\(\?(?::|i:|=|!|<=|<!)")
_PROP = re.compile(r"\{(\^?)([A-Za-z]+)\}")


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern as an equivalent Python ``re`` pattern, or
    ``ValueError`` naming the first construct that is not translated."""
    out: list[str] = []
    i, n = 0, len(pattern)
    in_class = False

    def bad(what: str) -> ValueError:
        return ValueError(f"tokenizer.json: unsupported regex {what} in "
                          f"{pattern!r}")

    while i < n:
        c = pattern[i]
        if c == "\\":
            if i + 1 >= n:
                raise bad("trailing backslash")
            e = pattern[i + 1]
            if e in "pP":
                m = _PROP.match(pattern, i + 2)
                if m is None:
                    raise bad(f"escape \\{e}")
                neg = (e == "P") != bool(m.group(1))
                body = _class_body(m.group(2))
                if in_class:
                    if neg:
                        raise bad("negated property inside a class")
                    out.append(body)
                else:
                    out.append(("[^" if neg else "[") + body + "]")
                i = m.end()
                continue
            if e in "sS":
                if in_class:
                    if e == "S":
                        raise bad("\\S inside a class")
                    out.append(WHITESPACE)
                else:
                    out.append(("[^" if e == "S" else "[") + WHITESPACE + "]")
            elif e in _SIMPLE_ESCAPES:
                out.append(_SIMPLE_ESCAPES[e])
            elif not e.isalnum() and e.isascii():
                out.append("\\" + e)
            else:
                raise bad(f"escape \\{e}")
            i += 2
            continue
        if in_class:
            if c == "[" or pattern.startswith("&&", i):
                raise bad("nested class or class operator")
            if c == "]":
                in_class = False
            out.append(c)
            i += 1
            continue
        if c == "[":
            in_class = True
            out.append(c)
            i += 1
            if pattern.startswith("^", i):
                out.append("^")
                i += 1
            if pattern.startswith("]", i):
                out.append("\\]")
                i += 1
            continue
        if c == "(":
            m = _GROUP.match(pattern, i)
            if m is not None:
                out.append(m.group())
                i = m.end()
                continue
            if pattern.startswith("(?", i):
                raise bad(f"group {pattern[i:i + 4]!r}")
        elif c in "^$":
            raise bad(f"anchor {c!r}")
        elif c in "*+?}" and pattern.startswith("+", i + 1):
            raise bad("possessive quantifier")
        out.append(c)
        i += 1
    if in_class:
        raise bad("unterminated class")
    return "".join(out)


@functools.lru_cache(maxsize=None)
def compile_regex(pattern: str) -> "re.Pattern[str]":
    return re.compile(translate_regex(pattern))


def _split(text: str, rx: "re.Pattern[str]", behavior: str) -> list[str]:
    """The library's ``split`` of one piece by a pattern's matches."""
    out: list[str] = []
    pos = 0
    pending = ""  # MergedWithNext: a match waiting for the text after it
    for m in rx.finditer(text):
        a, b = m.span()
        if a == b:
            continue
        gap, mat = text[pos:a], text[a:b]
        if behavior == "Isolated":
            out += [gap, mat]
        elif behavior == "Removed":
            out.append(gap)
        else:  # MergedWithNext
            out.append(pending + gap)
            pending = mat
        pos = b
    out.append(pending + text[pos:])
    return [s for s in out if s]


GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")


def gpt2_pretokenize(text: str) -> list[str]:
    """GPT-2's split regex (the ByteLevel pre-tokenizer's), as the
    library applies it."""
    return _split(text, compile_regex(GPT2_PATTERN), "Isolated")


def llama3_pretokenize(text: str) -> list[str]:
    """Llama 3's split regex ("llama-bpe"): case-insensitive
    contractions, digits in threes, punctuation that takes the newlines
    after it, newline runs grouped."""
    return _split(text, compile_regex(LLAMA3_PATTERN), "Isolated")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's printable-byte table: every byte maps to a unicode char
    (printable ASCII/latin-1 map to themselves; the rest to U+0100+i)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


BYTE_ENC = bytes_to_unicode()
BYTE_DEC = {v: k for k, v in BYTE_ENC.items()}
_BYTE_TABLE = [BYTE_ENC[b] for b in range(256)]


def byte_level(text: str) -> str:
    return "".join(_BYTE_TABLE[b] for b in text.encode("utf-8"))


def _unsupported(kind: str, spec: Any) -> ValueError:
    name = spec.get("type") if isinstance(spec, dict) else spec
    return ValueError(f"tokenizer.json: {kind} {name!r} is not supported")


def _pattern(spec: dict, kind: str) -> tuple[str, str]:
    pat = spec.get("pattern") or {}
    if "String" in pat:
        return "String", pat["String"]
    if "Regex" in pat:
        return "Regex", pat["Regex"]
    raise _unsupported(f"{kind} pattern", pat)


# ---------------------------------------------------------------------------
# normalizers: str -> str


def _normalizer(spec: Optional[dict]) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    t = spec.get("type")
    if t in ("NFC", "NFD", "NFKC", "NFKD"):
        return functools.partial(unicodedata.normalize, t)
    if t == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def seq(s: str) -> str:
            for f in steps:
                s = f(s)
            return s
        return seq
    if t == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if t == "Replace":
        kind, pat = _pattern(spec, "Replace normalizer")
        if kind != "String" or not pat:
            raise _unsupported("Replace normalizer pattern", kind)
        content = spec["content"]
        return lambda s: s.replace(pat, content)
    raise _unsupported("normalizer", spec)


# ---------------------------------------------------------------------------
# pre-tokenizers: [(piece, starts at offset 0)] -> the same, split


@dataclass
class _Piece:
    text: str
    at_start: bool   # begins at the original text's first character


def _each(fn: Callable[[str], list[str]]):
    """A step that splits each piece into sub-pieces; the first keeps
    at_start only when it begins where its piece began."""
    def step(pieces: list[_Piece]) -> list[_Piece]:
        out = []
        for p in pieces:
            subs = fn(p.text)
            first = bool(subs) and p.text.startswith(subs[0])
            out += [_Piece(s, p.at_start and first and i == 0)
                    for i, s in enumerate(subs) if s]
        return out
    return step


def _pretokenizer(spec: Optional[dict]):
    if spec is None:
        return None
    t = spec.get("type")
    if t == "Sequence":
        steps = [_pretokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces):
            for f in steps:
                pieces = f(pieces)
            return pieces
        return seq
    if t == "Split":
        if spec.get("invert"):
            raise _unsupported("pre-tokenizer", "Split(invert=true)")
        behavior = spec.get("behavior")
        if behavior not in ("Isolated", "Removed", "MergedWithNext"):
            raise _unsupported("Split behavior", behavior)
        kind, pat = _pattern(spec, "Split")
        rx = compile_regex(pat) if kind == "Regex" else re.compile(
            re.escape(pat))
        return _each(lambda s: _split(s, rx, behavior))
    if t == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space", False))
        use_regex = bool(spec.get("use_regex", True))

        def bl(s: str) -> list[str]:
            if prefix and not s.startswith(" "):
                s = " " + s
            subs = gpt2_pretokenize(s) if use_regex else [s]
            return [byte_level(x) for x in subs]

        def step(pieces):
            # a prepended space keeps the piece's start
            out = []
            for p in pieces:
                out += [_Piece(x, p.at_start and i == 0)
                        for i, x in enumerate(bl(p.text)) if x]
            return out
        return step
    if t == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        if scheme not in ("always", "first", "never"):
            raise _unsupported("Metaspace prepend_scheme", scheme)
        split = bool(spec.get("split", True))
        rx = re.compile(re.escape(rep))

        def step(pieces):
            out = []
            for p in pieces:
                s = p.text.replace(" ", rep)
                if ((scheme == "always" or (scheme == "first"
                                            and p.at_start))
                        and not s.startswith(rep)):
                    s = rep + s
                subs = _split(s, rx, "MergedWithNext") if split else [s]
                out += [_Piece(x, p.at_start and i == 0)
                        for i, x in enumerate(subs) if x]
            return out
        return step
    if t == "WhitespaceSplit":
        return _each(lambda s: _split(s, _WS_RUN, "Removed"))
    raise _unsupported("pre-tokenizer", spec)


# ---------------------------------------------------------------------------
# models: piece -> ids


class _BPE:
    def __init__(self, spec: dict):
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise _unsupported(f"BPE {key}", spec[key])
        if spec.get("dropout"):
            raise _unsupported("BPE dropout", spec["dropout"])
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"tokenizer.json: merge {m!r} is not "
                                     "two tokens")
                a, b = parts
            else:
                a, b = m
            try:
                pair = (self.vocab[a], self.vocab[b])
                new = self.vocab[a + b]
            except KeyError as e:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names "
                                 f"{e.args[0]!r}, not in the vocab") from None
            self.merges[pair] = (rank, new)
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, piece: str) -> list[int]:
        if not piece:
            return []
        if self.ignore_merges and piece in self.vocab:
            return [self.vocab[piece]]
        hit = self._cache.get(piece)
        if hit is None:
            hit = self._merge_all(self._symbols(piece))
            if len(self._cache) < 10000:
                self._cache[piece] = hit
        return list(hit)

    def _symbols(self, piece: str) -> list[int]:
        ids: list[int] = []
        unk: Optional[int] = None  # a pending (possibly fused) unk
        for ch in piece:
            i = self.vocab.get(ch)
            if i is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(i)
                continue
            if self.byte_fallback:
                bids = [self.vocab.get(f"<0x{b:02X}>")
                        for b in ch.encode("utf-8")]
                if all(b is not None for b in bids):
                    ids += bids
                    continue
            if self.unk is not None:
                if self.unk not in self.vocab:
                    raise ValueError(f"tokenizer.json: unk_token "
                                     f"{self.unk!r} is not in the vocab")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            ids.append(unk)
        return ids

    def _merge_all(self, c: list[int]) -> list[int]:
        """The library's merge queue: the lowest-ranked pair first (the
        leftmost on a tie), stale entries skipped."""
        n = len(c)
        merges = self.merges
        nxt = list(range(1, n)) + [-1]
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for pos in range(n - 1):
            m = merges.get((c[pos], c[pos + 1]))
            if m is not None:
                heap.append((m[0], pos, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((c[pos], c[right]))
            if m is None or m[1] != new:
                continue
            c[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prev[nxt[right]] = pos
            if prev[pos] >= 0:
                m = merges.get((c[prev[pos]], c[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((c[pos], c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [c[i] for i in range(n) if alive[i]]


class _WordLevel:
    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = spec["vocab"]
        unk = spec.get("unk_token")
        if unk not in self.vocab:
            raise ValueError(f"tokenizer.json: WordLevel unk_token {unk!r} "
                             "is not in the vocab")
        self.unk_id = self.vocab[unk]

    def tokenize(self, piece: str) -> list[int]:
        return [self.vocab.get(piece, self.unk_id)]


def _model(spec: dict):
    t = spec.get("type")
    if t == "BPE":
        return _BPE(spec)
    if t == "WordLevel":
        return _WordLevel(spec)
    raise _unsupported("model", spec)


# ---------------------------------------------------------------------------
# post-processors: the ids that add_special_tokens puts around a text


def _post(spec: Optional[dict]) -> Optional[Callable[[list[int]], list[int]]]:
    if spec is None:
        return None
    t = spec.get("type")
    if t == "ByteLevel":
        return lambda ids: ids   # offsets only
    if t == "Sequence":
        steps = [_post(s) for s in spec["processors"]]

        def seq(ids):
            for f in steps:
                ids = f(ids)
            return ids
        return seq
    if t == "TemplateProcessing":
        parts: list[Optional[list[int]]] = []
        for item in spec["single"]:
            if "SpecialToken" in item:
                name = item["SpecialToken"]["id"]
                parts.append(list(spec["special_tokens"][name]["ids"]))
            elif item.get("Sequence", {}).get("id") == "A":
                parts.append(None)
            else:
                raise _unsupported("TemplateProcessing piece", str(item))

        def template(ids):
            out: list[int] = []
            for p in parts:
                out += ids if p is None else p
            return out
        return template
    raise _unsupported("post-processor", spec)


# ---------------------------------------------------------------------------
# decoders: [token] -> [text]


def _decoder(spec: Optional[dict]):
    if spec is None:
        return None
    t = spec.get("type")
    if t == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]

        def seq(toks):
            for f in steps:
                toks = f(toks)
            return toks
        return seq
    if t == "ByteLevel":
        def bl(toks):
            buf = bytearray()
            for tok in toks:
                bs = [BYTE_DEC.get(ch) for ch in tok]
                buf += (bytes(bs) if None not in bs else tok.encode("utf-8"))
            return [buf.decode("utf-8", errors="replace")]
        return bl
    if t == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        # the first token loses every replacement (its leading space)
        # unless the scheme never prepends one
        return lambda toks: [
            tok.replace(rep, "" if i == 0 and scheme != "never" else " ")
            for i, tok in enumerate(toks)]
    if t == "Replace":
        kind, pat = _pattern(spec, "Replace decoder")
        if kind != "String" or not pat:
            raise _unsupported("Replace decoder pattern", kind)
        content = spec["content"]
        return lambda toks: [tok.replace(pat, content) for tok in toks]
    if t == "ByteFallback":
        def bf(toks):
            out: list[str] = []
            pending = bytearray()

            def flush():
                if pending:
                    try:
                        out.append(pending.decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend(["�"] * len(pending))
                    pending.clear()
            for tok in toks:
                if (len(tok) == 6 and tok.startswith("<0x")
                        and tok.endswith(">")):
                    try:
                        pending.append(int(tok[3:5], 16))
                        continue
                    except ValueError:
                        pass
                flush()
                out.append(tok)
            flush()
            return out
        return bf
    if t == "Fuse":
        return lambda toks: ["".join(toks)]
    if t == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(toks):
            out = []
            for tok in toks:
                a = 0
                while a < min(start, len(tok)) and tok[a] == content:
                    a += 1
                b = len(tok)
                for _ in range(stop):
                    if b > a and tok[b - 1] == content:
                        b -= 1
                    else:
                        break
                out.append(tok[a:b])
            return out
        return strip
    raise _unsupported("decoder", spec)


# ---------------------------------------------------------------------------
# added tokens


@dataclass
class AddedToken:
    id: int
    content: str
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = True
    special: bool = False


def _is_word_char(ch: str) -> bool:
    """A regex ``\\w`` character (Unicode word: letters, marks, decimal
    digits, connector punctuation, the joiners)."""
    cat = unicodedata.category(ch)
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc")
            or ch in "\u200c\u200d")


def _ws_end(s: str) -> int:
    i = len(s)
    while i > 0 and s[i - 1] in WS_CHARS:
        i -= 1
    return i


def _ws_start(s: str) -> int:
    i = 0
    while i < len(s) and s[i] in WS_CHARS:
        i += 1
    return i


class _AddedSplitter:
    """Leftmost-longest matching of a set of added tokens in a string,
    with their strip and single-word rules (the library's
    ``AddedVocabulary::find_matches``)."""

    def __init__(self, tokens: dict[str, AddedToken]):
        self.tokens = tokens
        self.rx = (re.compile("|".join(
            re.escape(s) for s in sorted(tokens, key=len, reverse=True)))
            if tokens else None)

    def split(self, s: str) -> list[tuple[int, int, Optional[int]]]:
        """(start, stop, token id or None) spans covering ``s``."""
        if self.rx is None:
            return [(0, len(s), None)]
        out: list[tuple[int, int, Optional[int]]] = []
        offset = 0
        for m in self.rx.finditer(s):
            start, stop = m.span()
            tok = self.tokens[m.group()]
            if tok.single_word:
                if ((start > 0 and _is_word_char(s[start - 1]))
                        or (stop < len(s) and _is_word_char(s[stop]))):
                    continue
            if tok.lstrip:
                start = max(_ws_end(s[:start]), offset)
            if tok.rstrip:
                stop += _ws_start(s[stop:])
            if offset < start:
                out.append((offset, start, None))
            out.append((start, stop, tok.id))
            offset = stop
        if offset != len(s):
            out.append((offset, len(s), None))
        return out


class TokenizerJson:
    """A ``tokenizer.json`` pipeline: ``encode``, ``decode``,
    ``token_to_id``, ``get_vocab_size`` (the ``tokenizers.Tokenizer``
    calls the JAX package's ``HfTokenizer`` makes)."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, key)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pretokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        self.post = _post(spec.get("post_processor"))
        self.decoder = _decoder(spec.get("decoder"))
        self.added: dict[int, AddedToken] = {}
        for a in spec.get("added_tokens") or []:
            tok = AddedToken(**{k: a[k] for k in (
                "id", "content", "single_word", "lstrip", "rstrip",
                "normalized", "special") if k in a})
            self.added[tok.id] = tok
        self.added_by_content = {t.content: t for t in self.added.values()}
        self.special = {t.content for t in self.added.values() if t.special}
        raw = {t.content: t for t in self.added.values()
               if not t.normalized and t.content}
        norm = {}
        for t in self.added.values():
            if t.normalized and t.content:
                key = self.normalize(t.content) if self.normalize else \
                    t.content
                if key:
                    norm[key] = t
        self._raw_split = _AddedSplitter(raw)
        self._norm_split = _AddedSplitter(norm)
        self.vocab = self.model.vocab
        self._inv = {v: k for k, v in self.vocab.items()}

    @classmethod
    def from_file(cls, path: str) -> "TokenizerJson":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def _pieces(self, text: str) -> list[tuple[Optional[int], _Piece]]:
        out: list[tuple[Optional[int], _Piece]] = []
        for a, b, tid in self._raw_split.split(text):
            if tid is not None:
                out.append((tid, _Piece(text[a:b], a == 0)))
                continue
            s = text[a:b]
            if self.normalize is not None:
                s = self.normalize(s)
            for c, d, tid2 in self._norm_split.split(s):
                if c < d:
                    out.append((tid2, _Piece(s[c:d], a == 0 and c == 0)))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        for tid, piece in self._pieces(text):
            if tid is not None:
                ids.append(tid)
                continue
            subs = (self.pre_tokenize([piece]) if self.pre_tokenize
                    else [piece])
            for p in subs:
                ids += self.model.tokenize(p.text)
        if add_special_tokens and self.post is not None:
            ids = self.post(ids)
        return ids

    def id_to_token(self, i: int) -> Optional[str]:
        t = self.added.get(i)
        return t.content if t is not None else self._inv.get(i)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            t = self.id_to_token(int(i))
            if t is None or (skip_special_tokens and t in self.special):
                continue
            toks.append(t)
        if self.decoder is None:
            return " ".join(toks)
        return "".join(self.decoder(toks))

    def token_to_id(self, token: str) -> Optional[int]:
        t = self.added_by_content.get(token)
        return t.id if t is not None else self.vocab.get(token)

    def get_vocab_size(self) -> int:
        return len(self.vocab.keys() | self.added_by_content.keys())
