"""Token sequences and chained block hashing.

A block of `block_size` tokens is identified by a *chained* content hash,
``hash(block) = xxh3_64(parent_hash || token_bytes, seed=1337)``, so equal
hashes imply an identical prefix — the property prefix-cache reuse and
KV-aware routing rely on. The hash is the JAX package's bit for bit
(``dynamo_tpu/tokens.py``), computed by the port's own standard-library
XXH3 (``xxh3.py``), so port and JAX workers can share a router and KV
pages. Every component here must go through this module.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np

from dynamo_tpu_torch.xxh3 import xxh3_64

HASH_SEED = 1337
# Hash value used as the parent of the first block in a sequence (optionally
# replaced by a salt hash when multiple models share one control plane).
NO_PARENT = 0


def hash_tokens(tokens: Sequence[int], parent: int = NO_PARENT,
                seed: int = HASH_SEED) -> int:
    """Chained content hash of one block of tokens."""
    data = (struct.pack("<Q", parent)
            + np.asarray(tokens, dtype=np.dtype("<u4")).tobytes())
    return xxh3_64(data, seed)


def salt_hash(salt: str) -> int:
    """Root parent hash for a (model, lora, ...) namespace salt."""
    if not salt:
        return NO_PARENT
    return xxh3_64(salt.encode("utf-8"), HASH_SEED)


def compute_block_hashes(
    tokens: Sequence[int], block_size: int, salt: str = ""
) -> list[int]:
    """Hashes of all *complete* blocks of a token sequence (the
    router-side entry point): the trailing partial block is not hashed
    because it cannot be cached."""
    parent = salt_hash(salt)
    out: list[int] = []
    for start in range(0, len(tokens) - len(tokens) % block_size, block_size):
        parent = hash_tokens(tokens[start:start + block_size], parent)
        out.append(parent)
    return out


@dataclass(frozen=True)
class TokenBlock:
    """An immutable, complete block of `block_size` tokens plus its chain hash."""

    tokens: tuple[int, ...]
    block_hash: int
    parent_hash: int
    position: int  # block index within the sequence


@dataclass
class TokenBlockSequence:
    """A growing token sequence chunked into hash-chained blocks: complete
    blocks are eligible for the reuse pool; the partial tail is not."""

    block_size: int
    salt: str = ""
    blocks: list[TokenBlock] = field(default_factory=list)
    partial: list[int] = field(default_factory=list)

    def __post_init__(self):
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")

    @classmethod
    def from_tokens(
        cls, tokens: Iterable[int], block_size: int, salt: str = ""
    ) -> "TokenBlockSequence":
        seq = cls(block_size=block_size, salt=salt)
        seq.extend(tokens)
        return seq

    @property
    def last_hash(self) -> int:
        return self.blocks[-1].block_hash if self.blocks else salt_hash(self.salt)

    def block_hashes(self) -> list[int]:
        return [b.block_hash for b in self.blocks]

    def append(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the newly completed block, if any."""
        self.partial.append(int(token))
        if len(self.partial) == self.block_size:
            return self._seal()
        return None

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        """Append many tokens; returns all newly completed blocks."""
        new_blocks: list[TokenBlock] = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                new_blocks.append(b)
        return new_blocks

    def _seal(self) -> TokenBlock:
        parent = self.last_hash
        blk = TokenBlock(
            tokens=tuple(self.partial),
            block_hash=hash_tokens(self.partial, parent),
            parent_hash=parent,
            position=len(self.blocks),
        )
        self.blocks.append(blk)
        self.partial = []
        return blk
