"""TorchEngine's linear speculation against TpuEngine (tiny, f32, CPU),
continued from tests/test_torch_spec_engine.py: adaptive K walking both
ways and de-speculating a collapsed stream, the acceptance gate with and
without re-arm, logprob requests kept on the fused round beside
speculating ones (the round snapshot's filter), and the spec fields of
metrics(), the finishing annotation and the scrape surfaces."""
import asyncio

import numpy as np
import pytest

from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.runtime.system_server import SystemServer
from dynamo_tpu_torch.spec.metrics import SPEC, SPEC_FAMILIES
from tests.test_torch_spec_engine import (  # noqa: F401 — fixtures
    assert_same_run,
    baseline_mixed,
    collect,
    make_engine,
    prompts_mixed,
    request,
    run,
    weights,
)


def test_adaptive_k_walks_both_ways_identically(weights, baseline_mixed):
    """One repetitive and one random prompt: K shrinks on the random one
    and the output stays the non-speculative run's, with the
    reference's counters."""
    kw = dict(speculative="ngram", num_speculative_tokens=4,
              spec_adaptive=True, spec_min_k=1)
    t = run("torch", weights, prompts_mixed(), **kw)
    assert_same_run(t, run("jax", weights, prompts_mixed(), **kw),
                    baseline_mixed)
    assert t[2]["spec_adaptive"] is True and t[2]["spec_k_shrink_total"] > 0


def test_adaptive_despec_on_collapsed_acceptance(weights):
    """A stream with nothing to look up de-speculates mid-stream (far
    from the region's end) and continues token-identically."""
    prompt = [np.random.RandomState(2).randint(1, 256, 20).tolist()]
    kw = dict(speculative="ngram", num_speculative_tokens=4)
    t = run("torch", weights, prompt, 40, **kw)
    assert_same_run(t, run("jax", weights, prompt, 40, **kw),
                    run("torch", weights, prompt, 40))
    assert t[2]["spec_despec_total"] >= 1


@pytest.mark.parametrize("gate,window,rearm", [(0.5, 2, 4), (0.9, 1, 0)],
                         ids=["rearm", "no_rearm"])
def test_acceptance_gate(weights, gate, window, rearm):
    """Low-acceptance streams are gated back to the fused round; with a
    re-arm budget they speculate again after it (the two-phase drain),
    without one they finish fused. Either way the output is the plain
    run's and the reference's. Without re-arm the counters are the
    reference's too; a re-arm waits out the rounds in flight when it
    fires, which depends on when each package's fetches land, so there
    the counters are held to the gate's rules only."""
    kw = dict(speculative="ngram", num_speculative_tokens=4,
              spec_adaptive=False, spec_gate_acceptance=gate,
              spec_gate_window=window, spec_rearm_tokens=rearm)
    n = 48 if rearm else 32
    t = run("torch", weights, prompts_mixed(), n, **kw)
    j = run("jax", weights, prompts_mixed(), n, **kw)
    assert_same_run(t, j, run("torch", weights, prompts_mixed(), n),
                    counters=not rearm)
    assert t[2]["spec_gated_despec_total"] >= 1
    if rearm:
        assert t[2]["spec_rearm_total"] >= 1
    else:
        assert t[2]["spec_rearm_total"] == 0
    assert t[4].metrics().worker_stats.spec_gated_despecs_total == \
        t[2]["spec_gated_despec_total"]


def test_logprob_requests_stay_on_the_fused_round(weights):
    """A logprob request decodes on the fused round while an eligible
    one speculates in the same engine; the speculating stream equals
    its solo run (the round snapshot leaves its parked lane out), and
    both equal the reference's."""
    rng = np.random.RandomState(9)
    elig = rng.randint(1, 256, 6).tolist() * 4
    lp_prompt = rng.randint(1, 256, 12).tolist()
    kw = dict(speculative="ngram", num_speculative_tokens=4)
    solo = run("torch", weights, [elig], **kw)
    t = run("torch", weights, [lp_prompt, elig], logprobs=[2, None], **kw)
    j = run("jax", weights, [lp_prompt, elig], logprobs=[2, None], **kw)
    assert t[0] == j[0] and all(len(s) == 24 for s in t[0])
    assert t[0][1] == solo[0][0]
    eng = t[4]
    assert eng.step_count > 0 and eng.spec.verify_steps > 0
    assert "spec" not in t[1][0].annotations     # the fused one
    assert t[1][1].annotations["spec"]["proposed"] > 0


def test_metrics_annotations_and_scrape_surfaces(weights):
    """metrics() carries the spec fields (draft == target: acceptance
    high), the finishing output the request's counters, and the worker's
    system server and SPEC registry render the spec families."""
    eng = make_engine("torch", weights, draft=True, speculative="draft",
                      num_speculative_tokens=4)

    async def go():
        try:
            return await collect(eng, request(tproto, prompts_mixed()[0],
                                              16))
        finally:
            await eng.stop()

    toks, outs = asyncio.run(go())
    ws = eng.metrics().worker_stats
    assert len(toks) == 16
    assert ws.spec_proposed_total == eng.spec.proposed_total > 0
    assert ws.spec_accepted_total == eng.spec.accepted_total > 0
    assert ws.spec_acceptance_rate > 0.5
    # the request finished: nothing speculates, so the K distribution
    # reads 0; a live slot reads the cap (acceptance never sagged)
    assert (ws.spec_effective_k, ws.spec_effective_k_p50,
            ws.spec_effective_k_p95) == (0.0, 0.0, 0.0)
    assert eng.spec.effective_k_dist([0]) == (4.0, 4.0, 4.0)
    ann = outs[-1].annotations
    assert outs[-1].finish_reason is not None
    assert ann["spec"]["proposed"] > 0
    assert ann["spec"]["acceptance_rate"] == pytest.approx(
        ann["spec"]["accepted"] / ann["spec"]["proposed"])
    assert "timing" in ann
    assert SPEC.get("dynamo_spec_accept_rate") == pytest.approx(
        eng.spec.acceptance_rate())
    text = SystemServer(eng).render()
    for name in ("dynamo_spec_proposed_total", "dynamo_spec_accepted_total",
                 "dynamo_spec_acceptance_rate", "dynamo_spec_effective_k"):
        assert name in text
    for name, _, _ in SPEC_FAMILIES:
        assert name in text
