"""Tool-call parsing: model output text -> OpenAI tool_calls (the port's
copy of the JAX package's tool_calls.py).

Parity: reference protocols/openai tool-call plumbing — engines emit tool
invocations as structured text; the serving layer detects and parses them
into the OpenAI response shape (finish_reason "tool_calls", streamed
tool_call deltas). Two wire formats are recognized, matching what
llama-3.x and hermes-style templates produce:

  llama3 json:   {"name": "get_weather", "parameters": {"city": "SF"}}
                 (optionally a JSON array of such objects)
  hermes tags:   <tool_call>{"name": ..., "arguments": {...}}</tool_call>
                 (prose around the tags is preserved as content)

Streaming detection holds back text that may be a tool call and releases
it the moment it provably isn't one: a leading '{'/'[' buffer is released
when it parses to a non-tool value or outgrows the size cap, a leading
'<' is released as soon as it diverges from '<tool_call>', and prose is
streamed through with only a tag-prefix-sized tail held back (stop-jail
style) so a mid-message '<tool_call>' is still caught.
"""
from __future__ import annotations

import json
import uuid
from typing import Any, Optional

HERMES_OPEN = "<tool_call>"
HERMES_CLOSE = "</tool_call>"

# a leading-JSON buffer larger than this is assumed to be content, not a
# tool call (real calls are small; this bounds held-back streaming text)
MAX_TOOL_BUFFER = 8192

_TOOL_KEYS = {"name", "parameters", "arguments", "id", "type"}


def _mk_call(name: str, arguments: Any) -> dict[str, Any]:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments or {})
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def _from_obj(
    obj: Any, allowed: Optional[set] = None
) -> Optional[list[dict[str, Any]]]:
    """One parsed JSON value -> tool_calls, or None if not tool-shaped.
    Strict: a dict must look like a call (name + only call-ish keys) and,
    when the declared tool names are known, name one of them — a content
    object that merely HAS a "name" key must not be eaten."""
    if isinstance(obj, dict):
        obj = [obj]
    if not isinstance(obj, list) or not obj:
        return None
    calls = []
    for item in obj:
        if not isinstance(item, dict) or "name" not in item:
            return None
        if not set(item) <= _TOOL_KEYS:
            return None
        name = str(item["name"])
        if allowed is not None and name not in allowed:
            return None
        args = item.get("parameters", item.get("arguments", {}))
        calls.append(_mk_call(name, args))
    return calls


def parse_tool_calls_with_content(
    text: str, allowed: Optional[set] = None
) -> tuple[Optional[list[dict[str, Any]]], Optional[str]]:
    """Parse a COMPLETE model output. Returns (tool_calls, content):
    hermes outputs keep the prose around the tags as content; llama3
    whole-output JSON has no content. (None, text) if not tool calls."""
    s = text.strip()
    if not s:
        return None, None
    if HERMES_OPEN in s:
        calls: list[dict[str, Any]] = []
        prose: list[str] = []
        rest = s
        while HERMES_OPEN in rest:
            before, _, rest = rest.partition(HERMES_OPEN)
            if before.strip():
                prose.append(before.strip())
            body, sep, rest = rest.partition(HERMES_CLOSE)
            if not sep:
                return None, text  # unterminated tag: treat as content
            try:
                got = _from_obj(json.loads(body.strip()), allowed)
            except ValueError:
                return None, text
            if not got:
                return None, text
            calls.extend(got)
        if rest.strip():
            prose.append(rest.strip())
        if not calls:
            return None, text
        return calls, ("\n".join(prose) or None)
    if s[0] in "{[":
        try:
            calls = _from_obj(json.loads(s), allowed)
        except ValueError:
            return None, text
        if calls is None:
            return None, text
        return calls, None
    return None, text


def parse_tool_calls(
    text: str, allowed: Optional[set] = None
) -> Optional[list[dict[str, Any]]]:
    return parse_tool_calls_with_content(text, allowed)[0]


def _hermes_jail_len(text: str) -> int:
    """Longest suffix of `text` that is a proper prefix of the hermes open
    tag (stop-jail style holdback)."""
    for k in range(min(len(HERMES_OPEN) - 1, len(text)), 0, -1):
        if text.endswith(HERMES_OPEN[:k]):
            return k
    return 0


class ToolCallAccumulator:
    """Streaming detector: buffers text that may be a tool call; releases
    it as content the moment it provably isn't one. In pass-through mode
    a tag-prefix tail is jailed so a mid-message '<tool_call>' still
    switches to buffering."""

    def __init__(self, allowed: Optional[set] = None) -> None:
        self.allowed = allowed
        self._buf = ""
        self._maybe: Optional[bool] = None  # None = undecided yet

    def _leading_kind(self) -> Optional[str]:
        s = self._buf.lstrip()
        if not s:
            return None
        if s[0] in "{[":
            return "json"
        if s.startswith(HERMES_OPEN) or (
            len(s) < len(HERMES_OPEN)
            and HERMES_OPEN.startswith(s)
        ):
            return "tag"
        return "no"

    def feed(self, text: str) -> str:
        """Feed a delta; returns text safe to emit as content now."""
        self._buf += text
        if self._maybe is None:
            kind = self._leading_kind()
            if kind is None:
                return ""
            if kind == "no":
                self._maybe = False
            else:
                self._maybe = True
        if self._maybe:
            return self._reconsider()
        # pass-through mode: release all but a possible tag prefix tail
        if HERMES_OPEN in self._buf:
            # a tag appeared mid-message: release the prose before it and
            # buffer from the tag on
            idx = self._buf.index(HERMES_OPEN)
            out, self._buf = self._buf[:idx], self._buf[idx:]
            self._maybe = True
            return out
        jail = _hermes_jail_len(self._buf)
        if jail:
            out, self._buf = self._buf[:-jail], self._buf[-jail:]
        else:
            out, self._buf = self._buf, ""
        return out

    def _reconsider(self) -> str:
        """In buffering mode: release the buffer if it provably is not a
        tool call."""
        s = self._buf.lstrip()
        if s and s[0] == "<":
            # diverged from the tag? (prefix check over the typed chars)
            head = s[: len(HERMES_OPEN)]
            if not HERMES_OPEN.startswith(head):
                return self._release()
        elif s and s[0] in "{[":
            if len(self._buf) > MAX_TOOL_BUFFER:
                return self._release()
            try:
                obj = json.loads(s)
            except ValueError:
                return ""  # incomplete JSON: keep buffering
            if _from_obj(obj, self.allowed) is None:
                return self._release()
        return ""

    def _release(self) -> str:
        out, self._buf = self._buf, ""
        self._maybe = False
        return out

    def finalize(self) -> tuple[Optional[list[dict[str, Any]]],
                                Optional[str]]:
        """(tool_calls, leftover_content) for the END of the stream."""
        buf, self._buf = self._buf, ""
        if self._maybe:
            calls, content = parse_tool_calls_with_content(
                buf, self.allowed
            )
            if calls is not None:
                return calls, content
        return None, (buf or None)
