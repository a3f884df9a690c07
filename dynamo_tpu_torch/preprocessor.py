"""OpenAI request preprocessing: chat template + tokenization (a copy of
the JAX package's preprocessor.py).

Turns a validated OpenAI request into a `PreprocessedRequest` for the
engine: apply model defaults, render the chat template (the port's Jinja
subset, chat_template.py, where the reference uses jinja2), tokenize, and
attach stop/sampling options and the nvext overload hints. Mirrors the
reference OpenAIPreprocessor (lib/llm/src/preprocessor.rs:104). With an
``image_token_id``, image content parts are lowered to runs of
placeholder tokens and encode-worker payloads (multimodal.py); without
one they are dropped, as in the reference. ``PromptFormatter.from_dir`` reads a model directory's
``tokenizer_config.json`` as the reference does.
"""
from __future__ import annotations

import base64
import json
import math
import os
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

    @classmethod
    def from_dir(cls, path: str) -> "PromptFormatter":
        """The template and BOS/EOS strings of a model directory's
        ``tokenizer_config.json``: ``chat_template`` as a string, or as a
        list of named templates from which ``default`` is taken; the
        tokens as strings or ``{"content": ...}`` dicts. Without the file
        (or a template in it) the default template."""
        tc = os.path.join(path, "tokenizer_config.json")
        template, bos, eos = DEFAULT_CHAT_TEMPLATE, "", ""
        if os.path.exists(tc):
            with open(tc) as f:
                cfg = json.load(f)
            t = cfg.get("chat_template")
            if isinstance(t, list):  # multi-template form: pick "default"
                t = next((e.get("template") for e in t
                          if e.get("name") == "default"), None)
            if isinstance(t, str):
                template = t
            for name in ("bos_token", "eos_token"):
                v = cfg.get(name)
                if isinstance(v, dict):
                    v = v.get("content")
                if name == "bos_token":
                    bos = v or ""
                else:
                    eos = v or ""
        return cls(template=template, bos_token=bos, eos_token=eos)

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


_IMG_SENTINEL = "\x00<dynamo:image>\x00"


def _flatten_content(
    content: Union[str, list, None],
    images: Optional[list] = None,
) -> str:
    """OpenAI content may be a list of typed parts; keep the text parts.
    With `images` given, image parts are collected into it and replaced by
    a sentinel the tokenizer never merges across — preprocess_chat splices
    placeholder token runs at the sentinel positions (the multimodal
    image_url lowering, reference examples/multimodal processor). Without
    it, image parts are dropped."""
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
        elif ptype in ("image_url", "image_data") and images is not None:
            if ptype == "image_url":
                url = (p.get("image_url") or {}).get("url", "")
                if not url.startswith("data:"):
                    raise ValueError(
                        "only data: image URLs are supported "
                        "(no egress from the serving host)"
                    )
                images.append({"data_url": url})
            else:
                images.append({
                    "data": p.get("data"), "shape": p.get("shape"),
                })
            parts.append(_IMG_SENTINEL)
    return "".join(parts)


@dataclass
class OpenAIPreprocessor:
    """model defaults + template + tokenize -> PreprocessedRequest."""

    tokenizer: Tokenizer
    formatter: PromptFormatter = field(default_factory=PromptFormatter)
    model_name: str = ""
    default_max_tokens: Optional[int] = None
    context_length: Optional[int] = None
    # multimodal lowering (None disables): each image part becomes a run
    # of `image_token_count` x `image_token_id` placeholders whose
    # positions travel in PreprocessedRequest.multimodal
    image_token_id: Optional[int] = None
    image_token_count: int = 0

    def preprocess_chat(self, req: ChatCompletionRequest) -> PreprocessedRequest:
        images: list = []
        collect = images if self.image_token_id is not None else None
        messages = [
            {
                "role": m.role,
                "content": _flatten_content(m.content, collect),
                **({"tool_calls": m.tool_calls} if m.tool_calls else {}),
                **({"tool_call_id": m.tool_call_id} if m.tool_call_id else {}),
                **({"name": m.name} if m.name else {}),
            }
            for m in req.messages
        ]
        prompt = self.formatter.render(
            messages, tools=req.tools, extra=req.chat_template_args
        )
        if not images:
            return self._finish(req, self.tokenizer.encode(prompt))

        # splice placeholder runs at the sentinel positions
        segments = prompt.split(_IMG_SENTINEL)
        if len(segments) != len(images) + 1:
            raise ValueError("image sentinel mismatch in rendered prompt")
        token_ids: list[int] = []
        positions = []
        for i, seg in enumerate(segments):
            if seg:
                token_ids.extend(self.tokenizer.encode(seg))
            if i < len(images):
                positions.append(len(token_ids))
                token_ids.extend(
                    [self.image_token_id] * self.image_token_count)
        pre = self._finish(req, token_ids)
        pre.multimodal = {"images": [
            dict(self._resolve_image(im), pos=pos)
            for im, pos in zip(images, positions)
        ]}
        return pre

    @staticmethod
    def _resolve_image(im: dict) -> dict:
        """Normalize an image part to the encode-worker wire payload
        ({data: b64-f32, shape}). data: URLs carry raw f32 bytes; the
        shape rides in the fragment (#HxWx3) or defaults to square RGB."""
        if "data_url" in im:
            url = im["data_url"]
            frag = ""
            if "#" in url:
                url, frag = url.rsplit("#", 1)
            payload = url.split(",", 1)[1] if "," in url else ""
            if frag:
                shape = [int(x) for x in frag.split("x")]
            else:
                n = len(base64.b64decode(payload)) // 4 // 3
                side = int(math.isqrt(n))
                shape = [side, side, 3]
            return {"data": payload, "shape": shape}
        return {"data": im["data"], "shape": im["shape"]}

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
