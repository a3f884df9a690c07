"""OpenAI request preprocessing: chat template + tokenization (a copy of
the JAX package's preprocessor.py, text only).

Turns a validated OpenAI request into a `PreprocessedRequest` for the
engine: apply model defaults, render the chat template (the port's Jinja
subset, chat_template.py, where the reference uses jinja2), tokenize, and
attach stop/sampling options and the nvext overload hints. Mirrors the
reference OpenAIPreprocessor (lib/llm/src/preprocessor.rs:104). Image
content parts are refused: the engine serves no multimodal input yet.
Loading a template from a model directory (``from_dir``) waits with the
HF tokenizer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Union

from dynamo_tpu_torch.chat_template import ChatTemplate
from dynamo_tpu_torch.overload.deadline import apply_request_hints
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
)
from dynamo_tpu_torch.tokenizer import Tokenizer

DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message.role }}|>\n{{ message.content }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)


@dataclass
class PromptFormatter:
    """Renders OpenAI `messages` into a prompt string. The template is
    compiled when the formatter is built, so one outside the supported
    subset raises ``ValueError`` here."""

    template: str = DEFAULT_CHAT_TEMPLATE
    bos_token: str = ""
    eos_token: str = ""

    def __post_init__(self):
        self._tpl = ChatTemplate(self.template)

    def render(
        self,
        messages: list[dict[str, Any]],
        *,
        tools: Optional[list[dict[str, Any]]] = None,
        add_generation_prompt: bool = True,
        extra: Optional[dict[str, Any]] = None,
    ) -> str:
        ctx = {
            "messages": messages,
            "tools": tools,
            "add_generation_prompt": add_generation_prompt,
            "bos_token": self.bos_token,
            "eos_token": self.eos_token,
        }
        # user chat_template_args may override defaults but never the messages
        ctx.update({k: v for k, v in (extra or {}).items() if k != "messages"})
        return self._tpl.render(**ctx)


def _flatten_content(content: Union[str, list, None]) -> str:
    """OpenAI content may be a list of typed parts; keep the text parts.
    An image part raises: the engine takes no multimodal input yet."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    parts = []
    for p in content:
        if not isinstance(p, dict):
            continue
        ptype = p.get("type")
        if ptype == "text":
            parts.append(p.get("text", ""))
        elif ptype in ("image_url", "image_data"):
            raise ValueError(
                "image content is not supported by the PyTorch engine yet")
    return "".join(parts)


@dataclass
class OpenAIPreprocessor:
    """model defaults + template + tokenize -> PreprocessedRequest."""

    tokenizer: Tokenizer
    formatter: PromptFormatter = field(default_factory=PromptFormatter)
    model_name: str = ""
    default_max_tokens: Optional[int] = None
    context_length: Optional[int] = None

    def preprocess_chat(self, req: ChatCompletionRequest) -> PreprocessedRequest:
        messages = [
            {
                "role": m.role,
                "content": _flatten_content(m.content),
                **({"tool_calls": m.tool_calls} if m.tool_calls else {}),
                **({"tool_call_id": m.tool_call_id} if m.tool_call_id else {}),
                **({"name": m.name} if m.name else {}),
            }
            for m in req.messages
        ]
        prompt = self.formatter.render(
            messages, tools=req.tools, extra=req.chat_template_args
        )
        return self._finish(req, self.tokenizer.encode(prompt))

    def preprocess_completion(self, req: CompletionRequest) -> PreprocessedRequest:
        p = req.prompt
        if isinstance(p, str):
            token_ids = self.tokenizer.encode(p)
        elif p and isinstance(p[0], int):
            token_ids = list(p)  # pre-tokenized
        elif p and isinstance(p[0], str):
            if len(p) != 1:
                raise ValueError("batch prompts not supported on this endpoint")
            token_ids = self.tokenizer.encode(p[0])
        elif p and isinstance(p[0], list):
            if len(p) != 1:
                raise ValueError("batch prompts not supported on this endpoint")
            token_ids = list(p[0])
        else:
            raise ValueError("empty prompt")
        return self._finish(req, token_ids)

    def _finish(self, req, token_ids: list[int]) -> PreprocessedRequest:
        if self.context_length and len(token_ids) >= self.context_length:
            raise ValueError(
                f"prompt length {len(token_ids)} exceeds context length {self.context_length}"
            )
        stop = req.to_stop_conditions(self.default_max_tokens)
        stop.stop_token_ids = list(
            dict.fromkeys(list(stop.stop_token_ids) + list(self.tokenizer.eos_token_ids))
        )
        pre = PreprocessedRequest(
            token_ids=token_ids,
            model=req.model or self.model_name,
            stop_conditions=stop,
            sampling_options=req.to_sampling(),
            output_options=req.to_output_options(),
        )
        nvext = req.nvext or {}
        if nvext.get("annotations"):
            pre.annotations = list(nvext["annotations"])
        # nvext priority/timeout_ms/tenant fold onto the request here so
        # every caller of preprocess() gets them; the HTTP service
        # re-applies with headers on top (headers win)
        apply_request_hints(pre, None, nvext)
        return pre
