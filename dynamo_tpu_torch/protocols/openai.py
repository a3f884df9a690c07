"""OpenAI-compatible API types (chat completions, completions, models): a
copy of the JAX package's protocols/openai.py on the standard library.

The reference validates request bodies with pydantic models. Here each
request type is a dataclass whose ``from_dict`` validates a body as
those models do in their default (lax) mode: the same coercions (an int
or a numeric string for a float, ``"yes"``/``1`` for a bool, a float with
no fractional part or a numeric string for an int), the same ranges and
field validators, the same defaults, unknown keys ignored; a union takes
the first member that matches the value's type exactly, else the first
that accepts it after coercion. A refused body raises ``ValidationError``
carrying the first error, in field order, with pydantic's message.

Responses and embeddings requests are not ported yet.
"""
from __future__ import annotations

import math
import re
import time
import uuid
from dataclasses import MISSING, dataclass, field, fields
from typing import Any, Callable, Optional, Union

from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    OutputOptions,
    SamplingOptions,
    StopConditions,
)


class ValidationError(ValueError):
    """A request body the API refuses: the first error's location (field
    names and list indices) and message."""

    def __init__(self, loc: tuple, msg: str):
        super().__init__(msg)
        self.loc = loc
        self.msg = msg


# ---------------------------------------------------------------------------
# validators: (value, loc, strict) -> coerced value, or ValidationError

_Validator = Callable[[Any, tuple, bool], Any]
_INT_STR = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _str(v, loc, strict=False):
    if isinstance(v, str):
        return v
    raise ValidationError(loc, "Input should be a valid string")


def _int(v, loc, strict=False):
    if isinstance(v, int) and not isinstance(v, bool):
        return int(v)
    if not strict:
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, float):
            if not math.isfinite(v):
                raise ValidationError(loc, "Input should be a finite number")
            if not v.is_integer():
                raise ValidationError(
                    loc, "Input should be a valid integer, got a number "
                         "with a fractional part")
            if not -2**63 <= v < 2**63:
                raise ValidationError(
                    loc, "Unable to parse input string as an integer, "
                         "exceeded maximum size")
            return int(v)
        if isinstance(v, str):
            s = v.strip()
            if _INT_STR.fullmatch(s):
                return int(s.split(".")[0].replace("_", ""))
            raise ValidationError(
                loc, "Input should be a valid integer, unable to parse "
                     "string as an integer")
    raise ValidationError(loc, "Input should be a valid integer")


def _float(v, loc, strict=False):
    if isinstance(v, (int, float)) and not (strict and isinstance(v, bool)):
        try:
            return float(v)
        except OverflowError:
            pass
    elif not strict and isinstance(v, str):
        s = v.strip()
        if s.isascii():
            try:
                return float(s)
            except ValueError:
                pass
        raise ValidationError(
            loc, "Input should be a valid number, unable to parse string "
                 "as a number")
    raise ValidationError(loc, "Input should be a valid number")


def _bool(v, loc, strict=False):
    if isinstance(v, bool):
        return v
    if not strict:
        if isinstance(v, int) and -2**63 <= v < 2**63 or isinstance(v, str):
            key = str(v).lower()
            if key in _TRUE or key in _FALSE:
                return key in _TRUE
            raise ValidationError(
                loc, "Input should be a valid boolean, unable to interpret "
                     "input")
        if isinstance(v, float) and v.is_integer() and -2**63 <= v < 2**63:
            if v in (0.0, 1.0):
                return v == 1.0
            raise ValidationError(
                loc, "Input should be a valid boolean, unable to interpret "
                     "input")
    raise ValidationError(loc, "Input should be a valid boolean")


def _dict(v, loc, strict=False):
    if not isinstance(v, dict):
        raise ValidationError(loc, "Input should be a valid dictionary")
    for k in v:
        _str(k, loc + (k,))
    return dict(v)


def _list(item: _Validator) -> _Validator:
    def check(v, loc, strict=False):
        if not (isinstance(v, list) or not strict and isinstance(v, tuple)):
            raise ValidationError(loc, "Input should be a valid list")
        return [item(x, loc + (i,), strict) for i, x in enumerate(v)]
    return check


def _optional(inner: _Validator) -> _Validator:
    def check(v, loc, strict=False):
        return None if v is None else inner(v, loc, strict)
    return check


def _union(*members: _Validator) -> _Validator:
    """pydantic's smart union: an exact-type match first, else the first
    member that accepts the value after coercion; the error is the first
    member's."""
    def check(v, loc, strict=False):
        for m in members:
            try:
                return m(v, loc, True)
            except ValidationError:
                pass
        first = None
        for m in members:
            try:
                return m(v, loc, False)
            except ValidationError as e:
                first = first or e
        raise first
    return check


def _fmt(x: float) -> str:
    return str(int(x)) if float(x).is_integer() else str(x)


def _bounded(inner: _Validator, ge=None, gt=None, le=None) -> _Validator:
    def check(v, loc, strict=False):
        v = inner(v, loc, strict)
        if v is None:
            return v
        # pydantic's order: a NaN fails the upper bound first
        if le is not None and not v <= le:
            raise ValidationError(
                loc, f"Input should be less than or equal to {_fmt(le)}")
        if ge is not None and not v >= ge:
            raise ValidationError(
                loc, f"Input should be greater than or equal to {_fmt(ge)}")
        if gt is not None and not v > gt:
            raise ValidationError(
                loc, f"Input should be greater than {_fmt(gt)}")
        return v
    return check


def _after(inner: _Validator, fn: Callable[[Any], None]) -> _Validator:
    """A field validator run on the coerced value; a ValueError it raises
    is pydantic's "Value error, ..."."""
    def check(v, loc, strict=False):
        v = inner(v, loc, strict)
        try:
            fn(v)
        except ValueError as e:
            raise ValidationError(loc, f"Value error, {e}") from None
        return v
    return check


def _f(validator: _Validator, default: Any = MISSING):
    return field(default=default, metadata={"v": validator})


def _model(cls) -> _Validator:
    """A nested model field: a dict (or an instance) validated as ``cls``."""
    def check(v, loc, strict=False):
        if isinstance(v, cls):
            return v
        return cls.from_dict(v, loc)
    return check


class _Model:
    @classmethod
    def from_dict(cls, body: Any, loc: tuple = ()):
        """Validate ``body`` field by field in declaration order (unknown
        keys are ignored); raise the first error."""
        if not isinstance(body, dict):
            raise ValidationError(
                loc, f"Input should be a valid dictionary or instance of "
                     f"{cls.__name__}")
        values = {}
        for f_ in fields(cls):
            if f_.name in body:
                values[f_.name] = f_.metadata["v"](
                    body[f_.name], loc + (f_.name,), False)
            elif f_.default is MISSING:
                raise ValidationError(loc + (f_.name,), "Field required")
        return cls(**values)


_opt_int = _optional(_int)
_opt_float = _optional(_float)
_opt_str = _optional(_str)
_opt_dict = _optional(_dict)


# ---------------------------------------------------------------------------
# request types


@dataclass(kw_only=True)
class ChatMessage(_Model):
    role: str = _f(_str)
    content: Union[str, list[dict[str, Any]], None] = _f(
        _optional(_union(_str, _list(_dict))), None)
    name: Optional[str] = _f(_opt_str, None)
    tool_calls: Optional[list[dict[str, Any]]] = _f(
        _optional(_list(_dict)), None)
    tool_call_id: Optional[str] = _f(_opt_str, None)


@dataclass(kw_only=True)
class StreamOptions(_Model):
    include_usage: bool = _f(_bool, False)


def _cap_stops(v) -> None:
    stops = [v] if isinstance(v, str) else (v or [])
    if len(stops) > 8:
        raise ValueError("at most 8 stop sequences")
    for s in stops:
        if not s:
            raise ValueError("stop sequences must be non-empty")
        if len(s) > 256:
            raise ValueError("stop sequences are capped at 256 chars")


def _seed_range(v) -> None:
    if v is not None and not (0 <= v < 2**63):
        raise ValueError("seed must be in [0, 2^63)")


def _user_len(v) -> None:
    if v is not None and len(v) > 256:
        raise ValueError("user is capped at 256 chars")


def _max_tokens_cap(v) -> None:
    if v is not None and v > 1_000_000:
        raise ValueError("max_tokens is capped at 1e6")


def _max_tokens_field():
    return _f(_after(_bounded(_opt_int, ge=1), _max_tokens_cap), None)


@dataclass(kw_only=True)
class _CommonRequest(_Model):
    model: str = _f(_str)
    stream: bool = _f(_bool, False)
    stream_options: Optional[StreamOptions] = _f(
        _optional(_model(StreamOptions)), None)
    max_tokens: Optional[int] = _max_tokens_field()
    max_completion_tokens: Optional[int] = _max_tokens_field()
    temperature: Optional[float] = _f(_bounded(_opt_float, ge=0.0, le=2.0),
                                      None)
    top_p: Optional[float] = _f(_bounded(_opt_float, gt=0.0, le=1.0), None)
    top_k: Optional[int] = _f(_bounded(_opt_int, ge=-1), None)
    frequency_penalty: Optional[float] = _f(
        _bounded(_opt_float, ge=-2.0, le=2.0), None)
    presence_penalty: Optional[float] = _f(
        _bounded(_opt_float, ge=-2.0, le=2.0), None)
    repetition_penalty: Optional[float] = _f(
        _bounded(_opt_float, gt=0.0), None)
    stop: Union[str, list[str], None] = _f(
        _after(_optional(_union(_str, _list(_str))), _cap_stops), None)
    seed: Optional[int] = _f(_after(_opt_int, _seed_range), None)
    n: int = _f(_bounded(_int, ge=1, le=8), 1)
    logprobs: Union[bool, int, None] = _f(_optional(_union(_bool, _int)),
                                          None)
    top_logprobs: Optional[int] = _f(_bounded(_opt_int, ge=0, le=20), None)
    user: Optional[str] = _f(_after(_opt_str, _user_len), None)
    # dynamo extensions (reference nvext): per-request annotations & routing hints
    nvext: Optional[dict[str, Any]] = _f(_opt_dict, None)

    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def to_sampling(self) -> SamplingOptions:
        return SamplingOptions(
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
            repetition_penalty=self.repetition_penalty,
            seed=self.seed,
            n=self.n,
        )

    def to_stop_conditions(self, default_max_tokens: Optional[int] = None) -> StopConditions:
        return StopConditions(
            max_tokens=self.max_completion_tokens or self.max_tokens or default_max_tokens,
            stop=self.stop_list(),
            ignore_eos=bool((self.nvext or {}).get("ignore_eos", False)),
        )

    def to_output_options(self) -> OutputOptions:
        n = None
        if self.logprobs is True:
            n = self.top_logprobs or 0
        elif isinstance(self.logprobs, int) and not isinstance(self.logprobs, bool):
            n = self.logprobs
        return OutputOptions(logprobs=n)


_ROLES = {"system", "developer", "user", "assistant", "tool"}


def _messages_valid(v) -> None:
    if not v:
        raise ValueError("messages must be non-empty")
    if len(v) > 1024:
        raise ValueError("at most 1024 messages")
    for m in v:
        if m.role not in _ROLES:
            raise ValueError(
                f"unknown message role {m.role!r} "
                f"(expected one of {sorted(_ROLES)})"
            )


@dataclass(kw_only=True)
class ChatCompletionRequest(_CommonRequest):
    messages: list[ChatMessage] = _f(
        _after(_list(_model(ChatMessage)), _messages_valid))
    tools: Optional[list[dict[str, Any]]] = _f(_optional(_list(_dict)),
                                               None)
    tool_choice: Union[str, dict[str, Any], None] = _f(
        _optional(_union(_str, _dict)), None)
    response_format: Optional[dict[str, Any]] = _f(_opt_dict, None)
    chat_template_args: Optional[dict[str, Any]] = _f(_opt_dict, None)


def _prompt_valid(v) -> None:
    if v == "" or v == []:
        raise ValueError("prompt must be non-empty")
    # token-id prompts: the engine's chained block hashing is uint32
    flat = []
    if isinstance(v, list):
        flat = v if v and isinstance(v[0], int) else [
            t for sub in v if isinstance(sub, list) for t in sub
        ]
    for t in flat:
        if not (0 <= t < 2**32):
            raise ValueError("token ids must be in [0, 2^32)")


@dataclass(kw_only=True)
class CompletionRequest(_CommonRequest):
    prompt: Union[str, list[str], list[int], list[list[int]]] = _f(_after(
        _union(_str, _list(_str), _list(_int), _list(_list(_int))),
        _prompt_valid))
    echo: bool = _f(_bool, False)
    suffix: Optional[str] = _f(_opt_str, None)
    best_of: Optional[int] = _f(_bounded(_opt_int, ge=1, le=8), None)


# ---------------------------------------------------------------------------
# Response builders (dicts — serialized straight to JSON)
# ---------------------------------------------------------------------------


def _usage(prompt_tokens: int, completion_tokens: int) -> dict[str, int]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def make_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def chat_completion_response(
    *,
    rid: str,
    model: str,
    choices: list[dict[str, Any]],
    prompt_tokens: int,
    completion_tokens: int,
    created: Optional[int] = None,
) -> dict[str, Any]:
    return {
        "id": rid,
        "object": "chat.completion",
        "created": created or int(time.time()),
        "model": model,
        "choices": choices,
        "usage": _usage(prompt_tokens, completion_tokens),
    }


def completion_response(
    *,
    rid: str,
    model: str,
    choices: list[dict[str, Any]],
    prompt_tokens: int,
    completion_tokens: int,
    created: Optional[int] = None,
) -> dict[str, Any]:
    return {
        "id": rid,
        "object": "text_completion",
        "created": created or int(time.time()),
        "model": model,
        "choices": choices,
        "usage": _usage(prompt_tokens, completion_tokens),
    }


def model_list_response(models: list[str]) -> dict[str, Any]:
    now = int(time.time())
    return {
        "object": "list",
        "data": [
            {"id": m, "object": "model", "created": now, "owned_by": "dynamo-tpu"}
            for m in models
        ],
    }


def completion_logprobs(entries: list[dict]) -> dict[str, Any]:
    """Legacy /v1/completions logprobs object from per-token entries
    (chat uses the entries directly under {"content": [...]})."""
    offsets, pos = [], 0
    for e in entries:
        offsets.append(pos)
        pos += len(e["token"])
    return {
        "tokens": [e["token"] for e in entries],
        "token_logprobs": [e["logprob"] for e in entries],
        "top_logprobs": [
            {t["token"]: t["logprob"] for t in e.get("top_logprobs", [])}
            or None
            for e in entries
        ],
        "text_offset": offsets,
    }


class DeltaGenerator:
    """Builds OpenAI streaming chunks from engine output deltas.

    One per request; mirrors reference
    protocols/openai/chat_completions/delta.rs DeltaGenerator.
    """

    def __init__(self, model: str, *, chat: bool = True, rid: Optional[str] = None, n: int = 1):
        self.chat = chat
        self.model = model
        self.rid = rid or make_id("chatcmpl" if chat else "cmpl")
        self.created = int(time.time())
        self._first_sent = [False] * n

    def _chunk(self, choices: list[dict[str, Any]], usage: Optional[dict] = None) -> dict[str, Any]:
        out = {
            "id": self.rid,
            "object": "chat.completion.chunk" if self.chat else "text_completion",
            "created": self.created,
            "model": self.model,
            "choices": choices,
        }
        if usage is not None:
            out["usage"] = usage
        return out

    def text_chunk(
        self,
        text: str,
        index: int = 0,
        logprob_entries: Optional[list[dict]] = None,
    ) -> dict[str, Any]:
        if self.chat:
            delta: dict[str, Any] = {"content": text}
            if not self._first_sent[index]:
                delta["role"] = "assistant"
                self._first_sent[index] = True
            choice = {"index": index, "delta": delta, "finish_reason": None}
            if logprob_entries:
                choice["logprobs"] = {"content": logprob_entries}
        else:
            choice = {"index": index, "text": text, "finish_reason": None}
            if logprob_entries:
                choice["logprobs"] = completion_logprobs(logprob_entries)
        return self._chunk([choice])

    def finish_chunk(self, reason: FinishReason, index: int = 0,
                     finish_override: Optional[str] = None) -> dict[str, Any]:
        fr = finish_override or reason.to_openai()
        if self.chat:
            choice = {"index": index, "delta": {}, "finish_reason": fr}
        else:
            choice = {"index": index, "text": "", "finish_reason": fr}
        return self._chunk([choice])

    def tool_calls_chunk(self, tool_calls: list[dict[str, Any]],
                         index: int = 0) -> dict[str, Any]:
        """Streamed tool-call delta (arguments delivered in one chunk,
        valid per the OpenAI streaming contract)."""
        delta: dict[str, Any] = {
            "tool_calls": [
                {"index": i, **call} for i, call in enumerate(tool_calls)
            ],
        }
        if not self._first_sent[index]:
            delta["role"] = "assistant"
            self._first_sent[index] = True
        return self._chunk([
            {"index": index, "delta": delta, "finish_reason": None}
        ])

    def usage_chunk(self, prompt_tokens: int, completion_tokens: int) -> dict[str, Any]:
        return self._chunk([], usage=_usage(prompt_tokens, completion_tokens))
