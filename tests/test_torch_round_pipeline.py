"""Round pipelining in TorchEngine (``EngineConfig.round_pipeline``, on by
default as in the reference), held against the strict order and against
TpuEngine on ModelConfig.tiny (f32), dense and int8 KV.

The pipeline dispatches round N+1 before round N's tokens are processed:
a reordering of host work against device work, so greedy streams must
be byte-identical with it on and off through its flush points
(admission bursts, releases, a prefix hit that lands mid-stream), and
equal to TpuEngine's with its default (pipelined) config. The cases are
the reference's (tests/test_round_pipeline.py). Also held here: the
round and patch functions that the card captures as CUDA graphs
(engine/graphs.py), run eagerly, against the round and patch they
replace (indexed writes and rebinding, as the engine issued them
before); and, as in the reference, a graceful drain (pipelined against
strict) and a chaos kill landing with rounds in flight."""
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
from dynamo_tpu_torch.engine import graphs, sampling
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto

PS = 16
ENGINE_KW = dict(num_pages=128, page_size=PS, max_pages_per_seq=16,
                 max_decode_slots=4, prefill_buckets=(64,),
                 cache_dtype="float32")


def _burst_jobs():
    """(prompt, max_tokens, delay_s): staggered arrivals against live
    decode (admission flushes), early finishers (release flushes)."""
    rng = np.random.RandomState(0)
    return [
        (rng.randint(1, 256, 48).tolist(), 40, 0.0),
        (rng.randint(1, 256, 24).tolist(), 12, 0.0),   # early release
        (rng.randint(1, 256, 40).tolist(), 32, 0.15),  # burst arrival
        (rng.randint(1, 256, 17).tolist(), 20, 0.3),   # second burst
    ]


def _prefix_jobs():
    """A shared 3-block head; its follower arrives mid-decode and hits
    the prefix (a load_ctx + patch pair against pool state)."""
    rng = np.random.RandomState(1)
    head = rng.randint(1, 256, 3 * PS).tolist()
    return [
        (head + [7], 36, 0.0),
        (rng.randint(1, 256, 32).tolist(), 36, 0.0),
        (head + [9], 24, 0.4),
    ]


async def _run_jobs(eng, proto, jobs):
    async def one(prompt, max_tokens, delay):
        if delay:
            await asyncio.sleep(delay)
        req = proto.PreprocessedRequest(
            token_ids=list(prompt),
            stop_conditions=proto.StopConditions(max_tokens=max_tokens,
                                                 ignore_eos=True))
        toks = []
        async for out in eng.generate(req):
            toks.extend(out.token_ids)
        return toks

    try:
        return await asyncio.gather(*[one(*job) for job in jobs])
    finally:
        await eng.stop()


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    return jparams, jax.tree.map(np.asarray, jparams)


def _torch_engine(weights, **kw):
    return TorchEngine(TConfig.tiny(dtype="float32"),
                       TEngineConfig(**{**ENGINE_KW, **kw}),
                       params=params_from_jax(weights[1], device="cpu"),
                       device="cpu")


def _both_modes(weights, jobs, **kw):
    """The jobs pipelined and strict: (tokens on, tokens off, stats on)."""
    out = {}
    for mode in (True, False):
        eng = _torch_engine(weights, round_pipeline=mode, **kw)
        toks = asyncio.run(_run_jobs(eng, tproto, jobs))
        out[mode] = (toks, eng.pipeline_stats())
    off = out[False][1]
    assert off["round_pipeline"] is False
    assert off["pipelined_dispatches"] == 0, off
    assert sum(off["pipe_flushes"].values()) == 0, off
    return out[True][0], out[False][0], out[True][1]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_differential_admission_burst_and_releases(weights, kv_quant):
    """Every arrival flushes the pipeline (a patch must not race an
    in-flight round) and every early finisher exercises the release
    flush point; the pipelined streams equal the strict ones and
    TpuEngine's (default config: pipelined)."""
    jobs = _burst_jobs()
    on, off, stats = _both_modes(weights, jobs, kv_quant=kv_quant)
    assert on == off, "pipelined tokens diverged from the strict order"
    assert [len(t) for t in on] == [mt for _, mt, _ in jobs]
    assert stats["round_pipeline"] is True
    assert stats["pipelined_dispatches"] > 0, stats
    assert stats["pipe_flushes"]["admission"] > 0, stats
    assert 1.0 <= stats["pipeline_depth"] <= 3.0, stats
    jcfg = JEngineConfig(**ENGINE_KW, kv_quant=kv_quant)
    assert jcfg.round_pipeline is True
    ref = TpuEngine(JConfig.tiny(dtype="float32"), jcfg, params=weights[0],
                    mesh_config=MeshConfig(tp=1))
    assert on == asyncio.run(_run_jobs(ref, jproto, jobs))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_differential_mid_stream_prefix_hit_patch(weights, kv_quant):
    on, off, stats = _both_modes(weights, _prefix_jobs(), kv_quant=kv_quant)
    assert on == off
    assert stats["pipelined_dispatches"] > 0, stats


# ---------------------------------------------------------------------------
# graceful drain and a chaos kill with rounds in flight


def _req(prompt, max_tokens):
    return tproto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=tproto.StopConditions(max_tokens=max_tokens,
                                              ignore_eos=True))


async def _stream_into(eng, prompt, max_tokens, sink):
    async for out in eng.generate(_req(prompt, max_tokens)):
        sink.extend(out.token_ids)
    return sink


def test_differential_drain(weights):
    """begin_drain with requests decoding: both modes run the in-flight
    work to completion (identical tokens), refuse new admissions with
    WorkerDrainingError, and report drained with no round left in
    flight; the pipelined mode counts its drain flushes."""
    from dynamo_tpu_torch.resilience.drain import WorkerDrainingError

    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 256, 32).tolist() for _ in range(3)]

    async def run(mode):
        eng = _torch_engine(weights, round_pipeline=mode)
        sinks = [[] for _ in prompts]
        tasks = [asyncio.ensure_future(_stream_into(eng, p, 48, s))
                 for p, s in zip(prompts, sinks)]
        try:
            for _ in range(2000):        # every stream is decoding
                if all(sinks):
                    break
                await asyncio.sleep(0.002)
            assert not eng.drained()
            eng.begin_drain()
            with pytest.raises(WorkerDrainingError):
                await _stream_into(eng, prompts[0], 4, [])
            toks = await asyncio.wait_for(asyncio.gather(*tasks), 60)
            for _ in range(2000):
                if eng.drained():
                    break
                await asyncio.sleep(0.005)
            assert eng.drained(), mode
            assert not eng._entries and not eng._slot_active.any()
            return toks, eng.pipeline_stats()
        finally:
            await eng.stop()

    on, stats = asyncio.run(run(True))
    off, off_stats = asyncio.run(run(False))
    assert on == off
    assert all(len(t) == 48 for t in on)
    assert stats["pipe_flushes"]["drain"] > 0, stats
    assert off_stats["pipe_flushes"]["drain"] == 0


def test_chaos_kill_with_a_round_in_flight_replays_identically(weights):
    """A chaos kill fired while the pipelined engine has rounds in flight
    leaves the migrated client with the stream of an uninterrupted run
    (and TpuEngine's): the replay prefill over prompt + emitted tokens
    picks up where the dead stream stopped."""
    from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.resilience.chaos import CHAOS
    from dynamo_tpu_torch.resilience.metrics import RESILIENCE

    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 256, 40).tolist()
    want = asyncio.run(_run_jobs(_torch_engine(weights), tproto,
                                 [(prompt, 24, 0.0)]))[0]
    ref = TpuEngine(JConfig.tiny(dtype="float32"), JEngineConfig(**ENGINE_KW),
                    params=weights[0], mesh_config=MeshConfig(tp=1))
    assert asyncio.run(_run_jobs(ref, jproto, [(prompt, 24, 0.0)]))[0] == want

    class ChaosWorker:
        """The remote-engine handler's shape: the engine stream runs
        through the chaos hooks when any point is armed."""

        def __init__(self, inner):
            self.inner = inner

        async def generate(self, req):
            src = self.inner.generate(req)
            if CHAOS.any_armed():
                src = CHAOS.wrap_stream(src)
            async for out in src:
                yield out

    async def run():
        eng = _torch_engine(weights)
        # one live engine behind two worker ids: the replay lands on a
        # warm engine whose pipeline is already running
        push = KvPushRouter(KvRouter(PS, KvRouterConfig(
            router_temperature=0.0)), {"w0": ChaosWorker(eng),
                                       "w1": ChaosWorker(eng)})
        migrations0 = RESILIENCE.get("dynamo_migration_total")
        CHAOS.reset()
        CHAOS.arm("kill_worker", after_outputs=6, once=True)
        try:
            got = []
            async for out in push.generate(_req(prompt, 24)):
                got.extend(out.token_ids)
            return (got, CHAOS.points["kill_worker"].injected_total,
                    push.migrations,
                    RESILIENCE.get("dynamo_migration_total") - migrations0,
                    eng.pipeline_stats())
        finally:
            CHAOS.reset()
            await eng.stop()

    got, injected, migrations, counted, stats = asyncio.run(run())
    assert got == want, "the migrated stream diverged from the clean run"
    assert (injected, migrations, counted) == (1, 1, 1)
    assert stats["pipelined_dispatches"] > 0, stats


# ---------------------------------------------------------------------------
# the captured functions, run eagerly

def _state(cfg, ecfg, seed):
    """A tiny engine's device state with random contents: ctx region,
    ring, pool and the per-slot state of 4 live slots."""
    g = torch.Generator().manual_seed(seed)
    B, V = ecfg.max_decode_slots, cfg.vocab_size
    ctx = llama.init_ctx(cfg, B, ecfg.max_context, torch.float32, "cpu",
                         kv_quant=ecfg.kv_quant, group=ecfg.page_size)
    ring = llama.init_ring(cfg, B, ecfg.flush_every, torch.float32, "cpu")
    cache = llama.init_cache(cfg, ecfg.num_pages, ecfg.page_size,
                             torch.float32, "cpu", kv_quant=ecfg.kv_quant)
    for name, t in (*ctx.items(), *ring.items(), *cache.items()):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        elif name.endswith("_scale"):
            t.copy_(torch.rand(t.shape, generator=g) * 0.01 + 0.01)
        else:
            t.copy_(torch.randn(t.shape, generator=g) * 0.5)
    dev = {
        "tokens": torch.randint(1, V, (B,), generator=g, dtype=torch.int32),
        "ctx": torch.tensor([21, 40, 17, 64], dtype=torch.int32),
        "dest": torch.tensor([0, 1, 2, B], dtype=torch.int32),  # 3 freed
        "counts": torch.randint(0, 2, (B, V), generator=g,
                                dtype=torch.int32),
        "keys": torch.randint(0, 2**32, (B, 2), generator=g),
        "temp": torch.tensor([0.0, 0.8, 1.0, 0.0]),
        "top_k": torch.tensor([0, 20, 0, 0], dtype=torch.int32),
        "top_p": torch.tensor([1.0, 0.9, 1.0, 1.0]),
        "freq": torch.tensor([0.0, 0.5, 0.0, 0.0]),
        "pres": torch.tensor([0.0, 0.0, 0.3, 0.0]),
        "rep": torch.tensor([1.0, 1.0, 1.2, 1.0]),
    }
    return ctx, ring, cache, dev


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("want_sample,want_lp", [(False, False),
                                                 (True, True)])
def test_round_in_place_equals_the_rebinding_round(kv_quant, want_sample,
                                                   want_lp):
    """``graphs.run_round`` (state written in place, outputs into static
    buffers, the seal batch fused) leaves the same state and tokens as
    the round the engine issued before: tokens and lengths rebound per
    step, fresh output tensors, the seal after the flush."""
    cfg = TConfig.tiny(dtype="float32")
    ecfg = TEngineConfig(**{**ENGINE_KW, "kv_quant": kv_quant})
    params = llama.init_params(cfg, 3, "cpu")
    ctx, ring, cache, dev = _state(cfg, ecfg, 5)
    seal = torch.tensor([[0, 2, 0, 0], [0, 16, 0, 0], [5, 9, 0, 0]],
                        dtype=torch.int32)
    n, B, K = ecfg.flush_every, ecfg.max_decode_slots, ecfg.max_logprobs

    # before: the rebinding round
    c1, r1, p1, d1 = _clone(ctx), _clone(ring), _clone(cache), _clone(dev)
    ring_base = torch.clamp(d1["ctx"] - 1, min=0)
    sp = sampling.SamplingParams(
        temperature=d1["temp"], top_k=d1["top_k"], top_p=d1["top_p"],
        frequency_penalty=d1["freq"], presence_penalty=d1["pres"],
        repetition_penalty=d1["rep"])
    want_toks, want_lp_rows = [], []
    for s in range(n):
        logits = llama.decode_step(cfg, params, c1, r1, d1["tokens"],
                                   d1["ctx"], ring_base, s)
        if want_sample:
            toks = sampling.sample_step(logits, d1["counts"], sp,
                                        ecfg.max_top_k, d1["keys"])
        else:
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        want_toks.append(toks)
        want_lp_rows.append(sampling.pack_logprobs(
            *sampling.compute_logprobs(logits, toks, K)))
        d1["tokens"] = toks
        d1["ctx"] = torch.clamp(d1["ctx"] + 1, max=ecfg.max_context)
    llama.flush_ctx(c1, r1, d1["dest"], ring_base,
                    torch.clamp(ecfg.max_context - ring_base, max=n))
    llama.seal_blocks(p1, c1, *seal, ecfg.page_size)

    # now: in place
    c2, r2, p2, d2 = _clone(ctx), _clone(ring), _clone(cache), _clone(dev)
    addrs = {k: v.data_ptr() for k, v in d2.items()}
    out = {"ring_base": torch.zeros(B, dtype=torch.int32),
           "toks": torch.zeros(n, B, dtype=torch.int32),
           "lp": torch.zeros(n, B, 1 + 2 * K)}
    graphs.run_round(cfg, ecfg, params, c2, r2, p2, d2, out, want_sample,
                     want_lp, seal)
    assert {k: v.data_ptr() for k, v in d2.items()} == addrs
    assert torch.equal(out["toks"], torch.stack(want_toks))
    if want_lp:
        assert torch.equal(out["lp"], torch.stack(want_lp_rows))
    for got, want in ((c2, c1), (r2, r1), (p2, p1), (d2, d1)):
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_packed_patch_equals_the_indexed_patch():
    """``graphs.run_patch`` of a ``pack_patch`` row (releases, then one
    admission with a negative penalty, whose f32 bits travel as a signed
    int32) leaves the state the indexed writes left."""
    cfg = TConfig.tiny(dtype="float32")
    ecfg = TEngineConfig(**ENGINE_KW)
    B = ecfg.max_decode_slots
    _, _, _, dev = _state(cfg, ecfg, 7)
    admit = dict(slot=2, ctx=33, tok=torch.tensor([77], dtype=torch.int32),
                 keys=[0xDEADBEEF, 12345], temp=0.7, top_k=40, top_p=0.95,
                 freq=-0.5, pres=0.25, rep=1.1)

    def indexed(d, clear_slots=(), admit=None):
        if clear_slots:
            idx = torch.tensor(clear_slots)
            d["ctx"][idx] = 1
            d["tokens"][idx] = 0
            d["temp"][idx] = 0.0
            d["counts"][idx] = 0
            d["dest"][idx] = B
        if admit is not None:
            s = admit["slot"]
            d["tokens"][s] = admit["tok"][0]
            d["ctx"][s] = admit["ctx"]
            d["dest"][s] = s
            d["counts"][s] = 0
            d["keys"][s, 0], d["keys"][s, 1] = admit["keys"]
            for key in ("temp", "top_k", "top_p", "freq", "pres", "rep"):
                d[key][s] = admit[key]

    want, got = _clone(dev), _clone(dev)
    zero_tok = torch.zeros(1, dtype=torch.int32)
    for clear, adm in (([0, 3], None), ((), admit)):
        indexed(want, clear, adm)
        row = torch.from_numpy(graphs.pack_patch(B, clear, adm))
        graphs.run_patch(got, row, adm["tok"] if adm else zero_tok)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert float(got["freq"][2]) == np.float32(-0.5)


def test_device_graphs_run_eagerly_on_the_cpu():
    """On the CPU the engine's programs run eagerly: no graph, no
    replay, no kernel launch, and the round's tokens land in the static
    output buffer."""
    eng = TorchEngine(TConfig.tiny(dtype="float32"),
                      TEngineConfig(**ENGINE_KW), device="cpu")
    g = eng.graphs
    assert not g.on_card
    assert g.round(False, False, None) == 0
    assert g.round(False, True, np.zeros((3, eng._seal_fuse_w),
                                         np.int32)) == 0
    assert g.replays == 0 and not g.capture_s and g.pool_bytes == 0
    assert bool((g.out["toks"] >= 0).all())
    assert int(eng._dev["ctx"][0]) == 1 + 2 * eng.ecfg.flush_every
