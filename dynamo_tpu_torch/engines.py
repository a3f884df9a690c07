"""Built-in test engines (a copy of the JAX package's engines.py;
reference lib/llm/src/engines.rs).

`EchoEngine` mirrors EchoEngineCore (engines.rs:83): a deterministic
token-level engine that streams back the prompt's token ids one per step at
a fixed cadence. It implements the same `generate()` contract as
TorchEngine, so the whole frontend→preprocessor→backend pipeline can be
exercised without a model or a card.
"""
from __future__ import annotations

import asyncio
import math
from typing import AsyncIterator

from dynamo_tpu_torch.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
)

# reference engines.rs TOKEN_ECHO_DELAY (1.5ms per token)
ECHO_DELAY_S = 0.0015


class EchoEngine:
    """Echoes prompt tokens back, one per step (engines.rs EchoEngineCore)."""

    def __init__(self, delay_s: float = ECHO_DELAY_S):
        self.delay_s = delay_s

    def start(self) -> None:  # lifecycle parity with TorchEngine
        pass

    async def stop(self) -> None:
        pass

    def embed(self, token_ids: list[int], dim: int = 16) -> list[float]:
        """Deterministic fake embedding (token-id histogram folded into a
        fixed dim, L2-normalized) — exercises the /v1/embeddings plumbing."""
        v = [0.0] * dim
        for i, t in enumerate(token_ids):
            v[(t + i) % dim] += 1.0 + (t % 7) * 0.1
        norm = math.sqrt(sum(x * x for x in v)) or 1.0
        return [x / norm for x in v]

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[LLMEngineOutput]:
        prompt = request.token_ids
        if not prompt:
            raise ValueError("empty prompt")
        sc = request.stop_conditions
        n = sc.max_tokens if sc.max_tokens is not None else len(prompt)
        for i in range(n):
            await asyncio.sleep(self.delay_s)
            yield LLMEngineOutput(token_ids=[prompt[i % len(prompt)]])
        yield LLMEngineOutput(token_ids=[], finish_reason=FinishReason.LENGTH)
