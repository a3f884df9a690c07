"""Model registry: name -> serving chain (a copy of the JAX package's
frontend/model_manager.py; reference
lib/llm/src/discovery/model_manager.rs:90-99).

A `ModelChain` wires the per-model pipeline the reference builds as a
pipeline graph (entrypoint/input/common.rs:126-150):

    OpenAI request -> OpenAIPreprocessor -> engine.generate -> Backend

A fine-tune variant (``register_variant``) is a chain that shares its
base's preprocessor, engine and backend and stamps its resident LoRA
bank row on every request, with its own name as the prefix-cache salt.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.backend import Backend
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.protocols.common import (
    LLMEngineOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
)


class ModelNotFound(KeyError):
    pass


@dataclass
class ModelChain:
    """One model's serving pipeline. `engine` is anything with the
    `generate(PreprocessedRequest)` contract (TorchEngine, EchoEngine)."""

    name: str
    preprocessor: OpenAIPreprocessor
    engine: Any
    backend: Backend
    # which OpenAI endpoints this model serves (reference ModelType)
    chat: bool = True
    completions: bool = True
    # nonzero when this chain is a registered fine-tune VARIANT of a base
    # model: the resident LoRA bank row serving its requests (0 = the
    # base model itself)
    adapter_id: int = 0

    def preprocess(
        self, req: ChatCompletionRequest | CompletionRequest
    ) -> PreprocessedRequest:
        if isinstance(req, ChatCompletionRequest):
            pre = self.preprocessor.preprocess_chat(req)
        else:
            pre = self.preprocessor.preprocess_completion(req)
        if self.adapter_id:
            pre.adapter_id = self.adapter_id
            # the VARIANT name is the prefix-cache salt: adapter deltas
            # change hidden states, so variants must never share cached
            # KV with the base model or each other
            pre.model = self.name
        return pre

    def generate(
        self, pre: PreprocessedRequest
    ) -> AsyncIterator[LLMEngineOutput]:
        """Engine token stream -> detokenized text-delta stream."""
        return self.backend.transform(
            self.engine.generate(pre),
            prompt_ids=pre.token_ids,
            stop=pre.stop_conditions,
        )


@dataclass
class ModelManager:
    """Registry the HTTP handlers resolve models against (one asyncio
    loop uses it)."""

    _models: dict[str, ModelChain] = field(default_factory=dict)

    def register(self, chain: ModelChain) -> None:
        self._models[chain.name] = chain

    def unregister(self, name: str) -> Optional[ModelChain]:
        return self._models.pop(name, None)

    def register_variant(self, name: str, base: str,
                         adapter_id: int) -> ModelChain:
        """Serve ``name`` as a fine-tune variant of ``base``: the variant
        shares the base chain's preprocessor, engine and backend (one
        weight load, one tokenizer) and differs only in the adapter row
        stamped onto each request."""
        if adapter_id <= 0:
            raise ValueError(
                f"variant {name!r} needs a positive adapter_id "
                f"(0 is the base model)")
        base_chain = self._models.get(base)
        if base_chain is None:
            raise ModelNotFound(base)
        chain = replace(base_chain, name=name, adapter_id=adapter_id)
        self._models[name] = chain
        return chain

    def get(self, name: str, *, chat: bool = False, completion: bool = False) -> ModelChain:
        chain = self._models.get(name)
        if chain is None:
            raise ModelNotFound(name)
        if chat and not chain.chat:
            raise ModelNotFound(f"{name} does not serve chat completions")
        if completion and not chain.completions:
            raise ModelNotFound(f"{name} does not serve completions")
        return chain

    def list_models(self) -> list[str]:
        return sorted(self._models)

    def __len__(self) -> int:
        return len(self._models)
