"""The port's block hashing against the JAX package's and the ``xxhash``
package: the port's standard-library XXH3-64 must give xxhash's value for
every input length across all of the algorithm's length paths, and the
chained block hashes must equal ``dynamo_tpu.tokens`` exactly, so that
port and JAX workers can share a KV router and KV pages."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import xxhash

from dynamo_tpu import tokens as jt
from dynamo_tpu_torch import tokens as tt
from dynamo_tpu_torch.xxh3 import xxh3_64


@pytest.mark.parametrize("seed", [0, 1337, 2**63 + 5])
def test_xxh3_64_equals_xxhash_for_every_length(seed):
    """Lengths 0..1100 cover the 0, 1-3, 4-8, 9-16, 17-128, 129-240 and
    long paths, the long path with one and with several 1024-byte blocks
    (and the custom secret for a non-zero seed). Exact."""
    data = np.random.RandomState(seed % 2**32).bytes(1100)
    got = [xxh3_64(data[:n], seed) for n in range(1101)]
    want = [xxhash.xxh3_64_intdigest(data[:n], seed=seed)
            for n in range(1101)]
    assert got == want


@pytest.mark.parametrize("salt", ["", "meta-llama/Llama-3.1-8B"])
@pytest.mark.parametrize("block", [4, 16, 64])
def test_block_hashes_equal_the_jax_package(salt, block):
    """hash_tokens, salt_hash, compute_block_hashes and the sequence's
    chain: exact. At block 64 a block is 8 + 256 = 264 bytes (the long
    path)."""
    toks = np.random.RandomState(block).randint(0, 128256, size=300).tolist()
    assert tt.salt_hash(salt) == jt.salt_hash(salt)
    assert (tt.hash_tokens(toks[:block], 12345)
            == jt.hash_tokens(toks[:block], 12345))
    assert (tt.hash_tokens(toks[:block], 7, seed=99)
            == jt.hash_tokens(toks[:block], 7, seed=99))
    want = jt.compute_block_hashes(toks, block, salt)
    assert tt.compute_block_hashes(toks, block, salt) == want
    assert len(want) == 300 // block
    seq = tt.TokenBlockSequence.from_tokens(toks, block, salt)
    assert seq.block_hashes() == want
    assert (seq.blocks[-1].parent_hash
            == jt.TokenBlockSequence.from_tokens(
                toks, block, salt).blocks[-1].parent_hash)


def test_port_never_imports_xxhash():
    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, dynamo_tpu_torch.tokens as t\n"
        "t.compute_block_hashes(list(range(200)), 64, 'm')\n"
        "print([m for m in sys.modules if m.split('.')[0] == 'xxhash'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
