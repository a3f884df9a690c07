"""Aggregate a stream of OpenAI chunks into a single response.

A copy of the JAX package's protocols/aggregator.py, used by test clients.
Mirrors reference protocols/openai/chat_completions/aggregator.rs.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional

from dynamo_tpu_torch.protocols.openai import (
    chat_completion_response,
    completion_response,
)


class ChoiceAcc:
    def __init__(self) -> None:
        self.text: list[str] = []
        self.finish_reason: Optional[str] = None
        self.role: str = "assistant"
        self.tool_calls: list[dict[str, Any]] = []


def aggregate_chunks(chunks: Iterable[dict[str, Any]]) -> dict[str, Any]:
    """Fold streaming chunks (chat or completion) into the final response."""
    rid = model = None
    created = None
    chat = True
    choices: dict[int, ChoiceAcc] = {}
    usage = {"prompt_tokens": 0, "completion_tokens": 0, "total_tokens": 0}

    for ch in chunks:
        rid = ch.get("id", rid)
        model = ch.get("model", model)
        created = ch.get("created", created)
        chat = ch.get("object", "chat.completion.chunk").startswith("chat")
        if ch.get("usage"):
            usage = ch["usage"]
        for c in ch.get("choices", []):
            acc = choices.setdefault(c.get("index", 0), ChoiceAcc())
            if chat:
                delta = c.get("delta", {})
                if delta.get("content"):
                    acc.text.append(delta["content"])
                if delta.get("role"):
                    acc.role = delta["role"]
                if delta.get("tool_calls"):
                    acc.tool_calls.extend(delta["tool_calls"])
            else:
                if c.get("text"):
                    acc.text.append(c["text"])
            if c.get("finish_reason"):
                acc.finish_reason = c["finish_reason"]

    out_choices = []
    for idx in sorted(choices):
        acc = choices[idx]
        if chat:
            msg: dict[str, Any] = {"role": acc.role, "content": "".join(acc.text)}
            if acc.tool_calls:
                msg["tool_calls"] = acc.tool_calls
            out_choices.append(
                {"index": idx, "message": msg, "finish_reason": acc.finish_reason}
            )
        else:
            out_choices.append(
                {"index": idx, "text": "".join(acc.text), "finish_reason": acc.finish_reason}
            )

    build = chat_completion_response if chat else completion_response
    resp = build(
        rid=rid or "",
        model=model or "",
        choices=out_choices,
        prompt_tokens=usage.get("prompt_tokens", 0),
        completion_tokens=usage.get("completion_tokens", 0),
        created=created,
    )
    resp["usage"] = usage
    return resp
