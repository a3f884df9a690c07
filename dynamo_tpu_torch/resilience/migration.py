"""Mid-stream request migration (Llumnix-style live replay; a copy of the
JAX package's resilience/migration.py).

When a streaming worker dies, the request is reconstructed as
``prompt + tokens-emitted-so-far`` and replayed as a *prefill* on a
healthy worker. The replay prompt IS the suppression of the replayed
suffix: the new worker's first sampled token is the next token of the
generation, so the client stream carries every token exactly once by
construction, and under greedy decoding the merged stream is
token-identical to an uninterrupted run (the continuation depends only on
sequence content). The paged-KV prefix cache makes the replayed prefill
mostly a hit when the new worker served this prefix before.

Stop conditions shift with the replay: ``max_tokens``/``min_tokens``
count tokens already delivered, so LENGTH fires at the same total and
``min_tokens`` suppression doesn't repeat.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

from dynamo_tpu_torch.protocols.common import PreprocessedRequest


@dataclass
class MigrationPolicy:
    """Knobs for the router's mid-stream migration path."""

    enabled: bool = True
    # migrations attempted for ONE request before giving up (each targets
    # a different worker; the dead ones are excluded from re-routing)
    max_migrations: int = 3

    def budget(self, n_workers: int) -> int:
        return min(self.max_migrations, max(n_workers - 1, 0))


def build_replay_request(
    request: PreprocessedRequest, emitted: list[int]
) -> Optional[PreprocessedRequest]:
    """The replay form of a partially-streamed request, or None when the
    request cannot migrate (its token budget is already spent — the caller
    should finish it with LENGTH instead of replaying a 0-token tail)."""
    sc = request.stop_conditions
    if sc.max_tokens is not None and len(emitted) >= sc.max_tokens:
        return None
    replay = copy.copy(request)
    replay.token_ids = list(request.token_ids) + list(emitted)
    replay.stop_conditions = copy.copy(sc)
    if sc.max_tokens is not None:
        replay.stop_conditions.max_tokens = sc.max_tokens - len(emitted)
    if sc.min_tokens is not None:
        replay.stop_conditions.min_tokens = max(
            0, sc.min_tokens - len(emitted)
        )
    # the router annotates per-route; never reuse the dead worker's hint
    replay.estimated_prefix_hit_num_blocks = None
    return replay
