"""chip_smoke.py's teacher-forced check of the verify, on the CPU at
tiny (f32): plain greedy streams with their top-2 logprobs, fed back
through the verify's scorer (llama.batch_score) K+1 tokens a row, must
give the plain decode's logprobs and top-2 gaps at every step; the same
streams with their logprobs one step out of place must not."""
import asyncio

import numpy as np
import pytest

import chip_smoke as cs
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig

# f32 on both paths: the fused decode and the scorer sum in other orders
TOL = 1e-4


@pytest.fixture(scope="module")
def plain_streams():
    cfg = ModelConfig.tiny(dtype="float32")
    params = llama.init_params(cfg, 0, device="cpu")
    ecfg = EngineConfig(num_pages=64, page_size=16, max_pages_per_seq=8,
                        max_decode_slots=4, prefill_buckets=(32, 64, 128),
                        cache_dtype="float32")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 50)]
    eng = TorchEngine(cfg, ecfg, params=params, device="cpu")

    async def go():
        out = await cs.generate_all(eng, prompts, cs.SPEC_NEW, logprobs=2)
        await eng.stop()
        return out

    return cfg, params, ecfg, prompts, asyncio.run(go())


def test_score_plain_gives_the_plain_decodes_logprobs(plain_streams):
    cfg, params, ecfg, prompts, plain = plain_streams
    assert all(len(p[0]) == cs.SPEC_NEW and len(p[4]) == cs.SPEC_NEW
               for p in plain)
    (err, at), (gap, gap_at) = cs.score_plain(cfg, params, prompts, plain,
                                              ecfg)
    assert err <= TOL, (err, at)
    assert gap <= TOL, (gap, gap_at)


def test_score_plain_sees_logprobs_one_step_off(plain_streams):
    cfg, params, ecfg, prompts, plain = plain_streams
    shifted = [(t, f, a, g, top[1:] + top[:1])
               for t, f, a, g, top in plain]
    (err, _), (gap, _) = cs.score_plain(cfg, params, prompts, shifted, ecfg)
    assert err > cs.SPEC_LP_TOL
    assert gap > cs.SPEC_TIE
