"""Speculative decoding (port of the JAX package's spec/).

A proposer drafts K candidate tokens ahead of the target model, the
verifier scores all of them in one target forward (the batch_prefill
shape with q_start > 0) and accepts on the device, and the engine
commits the accepted prefix plus one bonus token: one decode step turns
into up to K+1 output tokens. Under tree speculation (``spec_tree``) the
proposals form a token tree a slot (an n-gram trie, or a comb of M
draft candidates a level), scored under a tree-causal mask in one
forward; the deepest surviving root-to-leaf path is committed.

  proposer.py   the n-gram (prompt-lookup) proposer with its trie, the
                draft-model proposer and comb_parents; drafting for every
                speculating slot is one batched llama.batch_draft a round
  verifier.py   score + longest-prefix / rejection-sampling acceptance on
                the device, with and without penalties, for a chain
                (spec_verify) and a tree (spec_verify_tree)
  decoder.py    SpecDecoder, the engine-facing facade (eligibility,
                proposals, verify dispatch, counters, draft rollback, the
                acceptance gate) and AdaptiveKController
  metrics.py    the SPEC registry on every scrape surface

The engine (engine/engine.py) keeps speculating slots out of the fused
decode round (their lanes stay parked on the scratch lane, as freed
slots' are) and drives them through verify dispatches; rejected tokens
need no device cleanup, because attention masks by sequence length and
later writes overwrite the dead span: rollback is pointer truncation.
"""
from dynamo_tpu_torch.spec.decoder import AdaptiveKController, SpecDecoder
from dynamo_tpu_torch.spec.metrics import SPEC
from dynamo_tpu_torch.spec.proposer import (
    DraftModelProposer,
    NGramProposer,
    comb_parents,
)
from dynamo_tpu_torch.spec.verifier import (
    accept_tokens,
    accept_tokens_penalized,
    accept_tree,
    accept_tree_penalized,
    spec_verify,
    spec_verify_tree,
    tree_meta,
)

__all__ = [
    "SpecDecoder",
    "AdaptiveKController",
    "NGramProposer",
    "DraftModelProposer",
    "accept_tokens",
    "accept_tokens_penalized",
    "spec_verify",
    "comb_parents",
    "tree_meta",
    "accept_tree",
    "accept_tree_penalized",
    "spec_verify_tree",
    "SPEC",
]
