"""Speculative decoding (port of the JAX package's spec/, the linear
chain).

A proposer drafts K candidate tokens ahead of the target model, the
verifier scores all of them in one target forward (the batch_prefill
shape with q_start > 0) and accepts on the device, and the engine
commits the accepted prefix plus one bonus token: one decode step turns
into up to K+1 output tokens.

  proposer.py   the n-gram (prompt-lookup) proposer and the draft-model
                proposer; drafting for every speculating slot is one
                batched llama.batch_draft per round
  verifier.py   score + longest-prefix / rejection-sampling acceptance on
                the device, with and without penalties
  decoder.py    SpecDecoder, the engine-facing facade (eligibility,
                proposals, verify dispatch, counters, draft rollback, the
                acceptance gate) and AdaptiveKController
  metrics.py    the SPEC registry on every scrape surface

The engine (engine/engine.py) keeps speculating slots out of the fused
decode round (their lanes stay parked on the scratch lane, as freed
slots' are) and drives them through verify dispatches; rejected tokens
need no device cleanup, because attention masks by sequence length and
later writes overwrite the dead span: rollback is pointer truncation.

Left out here: tree speculation (``--spec-tree``, ``comb_parents``,
``accept_tree``, ``spec_verify_tree``, ``tree_meta``), ROADMAP item 7b.
"""
from dynamo_tpu_torch.spec.decoder import AdaptiveKController, SpecDecoder
from dynamo_tpu_torch.spec.metrics import SPEC
from dynamo_tpu_torch.spec.proposer import DraftModelProposer, NGramProposer
from dynamo_tpu_torch.spec.verifier import (
    accept_tokens,
    accept_tokens_penalized,
    spec_verify,
)

__all__ = [
    "SpecDecoder",
    "AdaptiveKController",
    "NGramProposer",
    "DraftModelProposer",
    "accept_tokens",
    "accept_tokens_penalized",
    "spec_verify",
    "SPEC",
]
