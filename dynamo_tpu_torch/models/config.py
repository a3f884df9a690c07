"""Model architecture configuration (a copy of the JAX package's
models/config.py: same fields, same canned shapes)."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family architecture hyperparameters."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    # hashable: tuple of sorted (key, value) pairs, e.g. (("factor", 8.0),
    # ("rope_type", "llama3"), ...). Use `rope_scaling_dict` to read.
    rope_scaling: Optional[tuple[tuple[str, Any], ...]] = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    model_type: str = "llama"
    dtype: str = "bfloat16"
    # Mixture-of-Experts FFN: kept so configs match the reference field
    # for field; the port does not serve it yet (models/llama.py raises)
    moe: Optional[tuple[tuple[str, Any], ...]] = None
    # "int8": w8a16 weights, symmetric per-output-channel int8 with f32
    # scales (models/llama.py quantize_params, ops/w8a16.py)
    quant: Optional[str] = None

    @property
    def rope_scaling_dict(self) -> Optional[dict[str, Any]]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @classmethod
    def from_hf_dict(cls, d: dict[str, Any]) -> "ModelConfig":
        num_heads = d["num_attention_heads"]
        head_dim = d.get("head_dim") or d["hidden_size"] // num_heads
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=d.get("num_key_value_heads", num_heads),
            head_dim=head_dim,
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=(
                tuple(sorted(d["rope_scaling"].items()))
                if d.get("rope_scaling")
                else None
            ),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 8192),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            model_type=d.get("model_type", "llama"),
        )

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "ModelConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_hf_dict(json.load(f))

    # ---- canned configs (shapes only; weights are random) ----

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        """4-layer toy model for CPU tests."""
        base = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=4,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            max_position_embeddings=512,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama3_1b(cls, **kw) -> "ModelConfig":
        """Llama-3.2-1B shapes."""
        base = dict(
            vocab_size=128256,
            hidden_size=2048,
            intermediate_size=8192,
            num_layers=16,
            num_heads=32,
            num_kv_heads=8,
            head_dim=64,
            rope_theta=500000.0,
            max_position_embeddings=131072,
            tie_word_embeddings=True,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama3_8b(cls, **kw) -> "ModelConfig":
        """Llama-3.1-8B / DeepSeek-R1-Distill-Llama-8B shapes."""
        base = dict(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
            max_position_embeddings=131072,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def llama3_8b_int8(cls, **kw) -> "ModelConfig":
        """Llama-3.1-8B with w8a16 int8 weights (~8 GB)."""
        return cls.llama3_8b(**{"quant": "int8", **kw})

    @classmethod
    def llama3_1b_int8(cls, **kw) -> "ModelConfig":
        return cls.llama3_1b(**{"quant": "int8", **kw})

    def num_params(self) -> int:
        """Approximate parameter count (for memory planning)."""
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = (
            h * self.q_dim + 2 * h * self.kv_dim + self.q_dim * h  # attn
            + 3 * h * i  # mlp
            + 2 * h  # norms
        )
        embed = v * h * (1 if self.tie_word_embeddings else 2)
        return self.num_layers * per_layer + embed + h
