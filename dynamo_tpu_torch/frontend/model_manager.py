"""Model registry: name -> serving chain (a copy of the JAX package's
frontend/model_manager.py; reference
lib/llm/src/discovery/model_manager.rs:90-99).

A `ModelChain` wires the per-model pipeline the reference builds as a
pipeline graph (entrypoint/input/common.rs:126-150):

    OpenAI request -> OpenAIPreprocessor -> engine.generate -> Backend

Fine-tune variants (LoRA adapter rows) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
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

    def preprocess(
        self, req: ChatCompletionRequest | CompletionRequest
    ) -> PreprocessedRequest:
        if isinstance(req, ChatCompletionRequest):
            return self.preprocessor.preprocess_chat(req)
        return self.preprocessor.preprocess_completion(req)

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
