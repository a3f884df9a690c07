"""Speculation metric plane (a copy of the JAX package's spec/metrics.py).

One process-wide CounterRegistry (telemetry/metrics.py) with the
reference's four families, so that every scrape surface renders the same
series whichever package serves it:

  dynamo_spec_tree_nodes_total          tree nodes scored by verify
                                        (root excluded)
  dynamo_spec_tree_accepted_path_len_total
                                        accepted tree path tokens
  dynamo_spec_tree_gated_despecs_total  streams de-speculated by the
                                        acceptance gate
  dynamo_spec_accept_rate               live acceptance fraction (gauge,
                                        accepted/proposed)

The two tree counters move under tree speculation (``spec_tree``); the
gate counter and the rate gauge under either path. The engine's spec
result paths increment them; the frontend
(frontend/service.py) and the worker's system server
(runtime/system_server.py) append ``SPEC.render()`` to /metrics.
"""
from __future__ import annotations

from dynamo_tpu_torch.telemetry.metrics import CounterRegistry

SPEC_FAMILIES: tuple[tuple[str, str, str], ...] = (
    (
        "dynamo_spec_tree_nodes_total",
        "counter",
        "Speculative tree nodes scored by verification (root excluded)",
    ),
    (
        "dynamo_spec_tree_accepted_path_len_total",
        "counter",
        "Accepted root-to-leaf path tokens across tree verify steps",
    ),
    (
        "dynamo_spec_tree_gated_despecs_total",
        "counter",
        "Streams de-speculated by the acceptance gate "
        "(--spec-gate-acceptance)",
    ),
    (
        "dynamo_spec_accept_rate",
        "gauge",
        "Live speculation acceptance fraction (accepted/proposed)",
    ),
)

SPEC = CounterRegistry(SPEC_FAMILIES, label="spec")
