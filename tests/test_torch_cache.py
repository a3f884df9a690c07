"""The port's copies of the host-side planes against the JAX package's:
the page allocator driven through the same operations must hand out the
same pages and emit the same events, and the port's block hashing must
keep the chained-prefix property and give the reference's values."""
import pytest

from dynamo_tpu.engine.cache import PageAllocator as JAllocator
from dynamo_tpu.tokens import TokenBlockSequence as JSequence
from dynamo_tpu_torch.engine.cache import PageAllocator as TAllocator
from dynamo_tpu_torch.tokens import TokenBlockSequence as TSequence


def _drive(allocator_cls):
    """Fill a 6-page pool with two committed chains, free them into the
    LRU, hit one prefix, then allocate past the free list (evictions)."""
    events = []
    a = allocator_cls(7, 4, worker_id="w", on_event=events.append)
    out = {"first": a.allocate(4)}
    for i, page in enumerate(out["first"]):
        assert a.commit(page, 100 + i, 99 + i if i else 0)
    assert not a.commit(a.allocate(1)[0], 101, 100)  # duplicate hash
    a.free(out["first"])
    out["hit"] = a.match_prefix([100, 101, 555])
    out["fresh"] = a.allocate(3)
    out["refused"] = a.allocate(5)
    out["hits"] = (a.hit_blocks, a.lookup_blocks)
    out["events"] = [(e.kind.value, e.event_id, e.worker_id, e.parent_hash,
                      [b.block_hash for b in e.blocks], e.removed_hashes)
                     for e in events]
    return out


def test_page_allocator_matches_jax():
    assert _drive(TAllocator) == _drive(JAllocator)


@pytest.mark.parametrize("salt", ["", "model-a"])
def test_block_hashes_chain_like_the_reference(salt):
    """Same block structure and hash values as the reference; equal
    hashes exactly when the whole prefix is equal."""
    toks = list(range(1, 11))
    t, j = TSequence.from_tokens(toks, 4, salt), JSequence.from_tokens(toks, 4, salt)
    assert [(b.tokens, b.position) for b in t.blocks] == [
        (b.tokens, b.position) for b in j.blocks]
    assert t.partial == j.partial == [9, 10]
    assert t.block_hashes() == j.block_hashes()
    assert t.blocks[1].parent_hash == t.blocks[0].block_hash
    same_tail = TSequence.from_tokens([0] + toks[1:], 4, salt)
    assert same_tail.blocks[1].tokens == t.blocks[1].tokens
    assert same_tail.block_hashes()[1] != t.block_hashes()[1]
    assert TSequence.from_tokens(toks, 4, salt).block_hashes() == t.block_hashes()
    other_salt = TSequence.from_tokens(toks, 4, salt + "x")
    assert other_salt.block_hashes()[0] != t.block_hashes()[0]
