"""The steady decode round's dispatch budget in TorchEngine (the
reference's tests/test_dispatch_budget.py, ``_steady_window_budget``):
with round pipelining on (the default), a steady round costs ONE round
program (one graph replay on the card) and ONE stacked-token fetch.
Seals ride the round program, never a standalone seal; no patch,
prefill, prefix load or first-token sample lands in the window. The
budget is read from the engine's own ``dispatch_counts``, on
ModelConfig.tiny (f32) on the CPU, dense and int8 KV."""
import asyncio

import numpy as np
import pytest

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.protocols.common import (
    PreprocessedRequest,
    StopConditions,
)

PS = 16


async def _steady_window_budget(**kw):
    eng = TorchEngine(ModelConfig.tiny(dtype="float32"), EngineConfig(
        num_pages=128, page_size=PS, max_pages_per_seq=16,
        max_decode_slots=4, prefill_buckets=(64,), cache_dtype="float32",
        **kw), device="cpu")
    assert eng.ecfg.round_pipeline is True
    eng.start()
    rng = np.random.RandomState(0)
    n_req, osl = 4, 64
    prompts = [rng.randint(1, 256, 48).tolist() for _ in range(n_req)]
    progress = [0] * n_req

    async def one(i):
        async for out in eng.generate(PreprocessedRequest(
            token_ids=list(prompts[i]),
            stop_conditions=StopConditions(max_tokens=osl,
                                           ignore_eos=True),
        )):
            progress[i] += len(out.token_ids)

    tasks = [asyncio.ensure_future(one(i)) for i in range(n_req)]
    # the window opens once every request is admitted and decoding...
    while not all(p >= 4 for p in progress):
        await asyncio.sleep(0.005)
    d0 = dict(eng.dispatch_counts)
    # ...and closes well before any finishes (the dispatch front runs
    # ahead of emitted tokens by flush_every * (max_inflight_rounds + 1)
    # = 12 steps, so closing 20 tokens short of osl keeps release
    # patches out of the window)
    while not any(p >= osl - 20 for p in progress):
        await asyncio.sleep(0.005)
    d1 = dict(eng.dispatch_counts)
    await asyncio.gather(*tasks)
    await eng.stop()

    delta = {k: d1[k] - d0.get(k, 0) for k in d1}
    rounds = delta["round"] + delta["round_seal"]
    assert rounds >= 5, delta
    assert delta["seal"] == 0, delta          # seals fused, not standalone
    assert delta["patch"] == 0, delta         # no admissions/releases
    assert delta["prefill"] == 0 and delta["prefill_batch"] == 0, delta
    assert delta["load_ctx"] == 0 and delta["sample_first"] == 0, delta
    total = sum(delta.values())
    # 1 program + 1 fetch per round; a snapshot can land between a
    # round's program and its fetch, so one straggler per window edge
    assert total <= 2 * rounds + 2, (total, rounds, delta)
    # blocks complete every PS tokens: with 4 slots x 4 steps a round
    # the fused-seal round must be exercised in the window
    assert delta["round_seal"] >= 1, delta
    stats = eng.pipeline_stats()
    assert stats["pipelined_dispatches"] >= rounds - 2, (stats, delta)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_steady_decode_round_budget(kv_quant):
    """A steady window costs 1 round program + 1 fetch a round in both KV
    modes: the int8 ring flush's requantization and the raw int8 seals
    ride the round program too."""
    asyncio.run(_steady_window_budget(kv_quant=kv_quant))
