"""TorchEngine against TpuEngine on ModelConfig.tiny (f32) with int8 KV
(``kv_quant="int8"``: int8 ctx region and prefix pool), the same weights
and the same traffic: 5 concurrent requests asking for 2 logprobs, a
prefix-cache hit, a 120-token prompt prefilled alone in two chunks
(the single-request prefill), a seeded request at temperature 0.8 and a
greedy request without logprobs.

Tolerances: tokens identical; chosen-token logprobs within 1e-4 (f32
products summed in another order); KV event block hashes identical."""
import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto

ENGINE_KW = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                 max_decode_slots=4, prefill_buckets=(32, 64),
                 cache_dtype="float32", kv_quant="int8")
_rng = np.random.RandomState(0)
PROMPTS = [list(range(1 + i, 30 + 3 * i)) for i in range(4)] + [
    [int(t) for t in _rng.randint(1, 256, size=100)]]
LONG = [int(t) for t in _rng.randint(1, 256, size=120)]
N_NEW = 12
LP_TOL = 1e-4


async def _collect(engine, proto, prompt, n_new, logprobs=2, **sampling):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True),
        sampling_options=proto.SamplingOptions(**sampling),
        output_options=proto.OutputOptions(logprobs=logprobs),
    )
    return [out async for out in engine.generate(req)]


async def _drive(engine, proto):
    outs = await asyncio.gather(
        *[_collect(engine, proto, p, N_NEW) for p in PROMPTS])
    outs.append(await _collect(engine, proto, PROMPTS[0], N_NEW))
    outs.append(await _collect(engine, proto, LONG, 8))
    outs.append(await _collect(engine, proto, PROMPTS[1], 24,
                               temperature=0.8, top_p=0.9, seed=7))
    outs.append(await _collect(engine, proto, PROMPTS[2], N_NEW,
                               logprobs=None))
    await engine.stop()
    return outs


def _tokens(outs):
    return [t for o in outs for t in o.token_ids]


def _chosen(outs):
    return [x for o in outs for x in (o.log_probs or [])]


def _stored(events):
    return sorted((b.block_hash, e.parent_hash) for e in events
                  if e.kind.value == "stored" for b in e.blocks)


@pytest.fixture(scope="module")
def runs():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    jevents, tevents = [], []
    jeng = TpuEngine(JConfig.tiny(dtype="float32"),
                     JEngineConfig(**ENGINE_KW), params=jparams,
                     mesh_config=MeshConfig(tp=1),
                     on_kv_event=jevents.append)
    jouts = asyncio.run(_drive(jeng, jproto))
    teng = TorchEngine(TConfig.tiny(dtype="float32"),
                       TEngineConfig(**ENGINE_KW),
                       params=params_from_jax(
                           jax.tree.map(np.asarray, jparams), device="cpu"),
                       device="cpu", on_kv_event=tevents.append)
    touts = asyncio.run(_drive(teng, tproto))
    return jouts, touts, teng, jevents, tevents


def test_int8_engine_greedy_identical_to_tpu_engine(runs):
    jouts, touts, teng, _, _ = runs
    assert teng.ctx["k"].dtype == teng.cache["k"].dtype == torch.int8
    assert teng.ring["k"].dtype == torch.float32
    for j, t in zip(jouts, touts):
        assert _tokens(t) == _tokens(j)
        assert t[-1].finish_reason.value == "length"
    # prefix hit: a 29-token prompt matches one 16-token block
    assert touts[5][-1].annotations["cached_blocks"] == 1
    # the single-request prefill ran, over several chunks for LONG
    assert teng.dispatch_counts["prefill"] >= 2
    assert len(_tokens(touts[6])) == 8


def test_int8_engine_logprobs_match_tpu_engine(runs):
    jouts, touts, _, _, _ = runs
    for j, t in zip(jouts, touts):
        got, want = _chosen(t), _chosen(j)
        assert len(got) == len(want)
        np.testing.assert_allclose(got, want, atol=LP_TOL, rtol=0)


def test_seeded_temperature_stream_identical_to_tpu_engine(runs):
    jouts, touts, _, _, _ = runs
    seeded = _tokens(touts[7])
    assert len(seeded) == 24 and seeded == _tokens(jouts[7])
    # sampling really happened: the stream leaves the greedy one
    assert seeded[:N_NEW] != _tokens(touts[1])


def test_kv_event_block_hashes_equal_tpu_engine(runs):
    _, _, _, jevents, tevents = runs
    stored = _stored(tevents)
    assert len(stored) >= 10
    assert stored == _stored(jevents)


def test_logprob_payloads_have_the_reference_shape(runs):
    """Every output carries one chosen logprob and one list of 2 [id,
    logprob] pairs per emitted token (none when not asked for), as the
    reference's outputs do."""
    jouts, touts, _, _, _ = runs
    for j, t in zip(jouts, touts):
        assert [len(o.token_ids) for o in t] == [len(o.token_ids) for o in j]
        for jo, to in zip(j, t):
            if jo.log_probs is None:
                assert to.log_probs is None and to.top_logprobs is None
                continue
            assert len(to.log_probs) == len(to.token_ids)
            assert len(to.top_logprobs) == len(to.token_ids)
            for tp, jp in zip(to.top_logprobs, jo.top_logprobs):
                assert [i for i, _ in tp] == [i for i, _ in jp]
                assert all(isinstance(i, int) and isinstance(v, float)
                           for i, v in tp)
                np.testing.assert_allclose([v for _, v in tp],
                                           [v for _, v in jp], atol=LP_TOL)
    assert touts[8][0].log_probs is None
