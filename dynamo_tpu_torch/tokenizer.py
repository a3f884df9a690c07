"""Tokenizer protocol, incremental detokenization and the offline test
tokenizer (a copy of the JAX package's tokenizer.py on the standard
library).

``DecodeStream`` emits only text that is new and does not end in an
incomplete UTF-8 replacement character, decoding a sliding window of ids
(reference lib/llm/src/tokenizers.rs:159). ``make_test_tokenizer`` is the
word-level tokenizer the tests and the random-weight launcher use; the
reference builds it on ``tokenizers`` (WordLevel + WhitespaceSplit), this
copy splits on the same whitespace itself. The HF tokenizer of a model
directory (``HfTokenizer``) is not ported yet.
"""
from __future__ import annotations

import re
from typing import Optional, Protocol, Sequence


class Tokenizer(Protocol):
    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]: ...
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...
    @property
    def eos_token_ids(self) -> list[int]: ...
    @property
    def vocab_size(self) -> int: ...


class DecodeStream:
    """Incremental detokenizer.

    decode() returns only text that is (a) new relative to what was already
    emitted and (b) not ending in an incomplete UTF-8 replacement char, so
    multi-token unicode sequences emit once complete.
    """

    REPLACEMENT = "�"

    def __init__(self, tokenizer: Tokenizer, prompt_ids: Sequence[int] = (), skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip = skip_special_tokens
        # keep a short tail of prompt tokens so the first generated token
        # detokenizes with correct leading-space context
        self._ids: list[int] = list(prompt_ids)[-6:]
        self._prefix_text = tokenizer.decode(self._ids, self._skip) if self._ids else ""
        self._emitted_upto = len(self._prefix_text)

    def step(self, token_id: int) -> str:
        """Feed one token; return newly-complete text (possibly empty)."""
        self._ids.append(int(token_id))
        text = self._tok.decode(self._ids, self._skip)
        if text.endswith(self.REPLACEMENT):
            # mid-codepoint; wait for the rest — but still bound the window
            # against degenerate streams that never complete a codepoint
            if len(self._ids) > 256:
                self._trim(text, keep=64)
            return ""
        new = text[self._emitted_upto :]
        self._emitted_upto = len(text)
        # bound memory: everything is emitted now, safe to drop head tokens
        if len(self._ids) > 64:
            self._trim(text, keep=32)
        return new

    def _trim(self, full_text: str, keep: int) -> None:
        unemitted = len(full_text) - self._emitted_upto
        self._ids = self._ids[-keep:]
        head = self._tok.decode(self._ids, self._skip)
        self._emitted_upto = max(0, len(head) - unemitted)


# the characters with Unicode's White_Space property: what the reference's
# WhitespaceSplit pre-tokenizer splits on (char::is_whitespace)
_WHITESPACE = re.compile(
    "[\t\n\v\f\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f"
    "\u3000]+")


class _WordTokenizer:
    """Word-level vocab over whitespace-split words; unknown words map to
    ``<unk>`` (0), ``<s>`` is 1 and ``</s>`` 2 (the EOS)."""

    eos_token_ids = [2]
    bos_token_id = 1

    def __init__(self, vocab: dict[str, int]):
        self._vocab = vocab
        self._inv = {v: k for k, v in vocab.items()}

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return [self._vocab.get(w, 0) for w in _WHITESPACE.split(text) if w]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        specials = {0, 1, 2} if skip_special_tokens else set()
        # ids beyond the vocab (e.g. sampled from a larger model head)
        # decode to <unk> rather than raising
        return " ".join(
            self._inv.get(i, "<unk>") for i in ids if i not in specials
        )

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)


def make_test_tokenizer(vocab_words: Optional[list[str]] = None) -> _WordTokenizer:
    """Tiny offline tokenizer for tests/CI (no model downloads): ids 3..
    are ``vocab_words`` in order (default ``w0``..``w99``)."""
    words = vocab_words or [f"w{i}" for i in range(100)]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for w in words:
        if w not in vocab:
            vocab[w] = len(vocab)
    return _WordTokenizer(vocab)
