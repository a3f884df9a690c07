"""TorchEngine's linear speculative decoding against TpuEngine with the
same settings and weights, on ModelConfig.tiny (f32, CPU): greedy n-gram
and draft speculation token-identical to the reference (and to the
non-speculative run) with equal proposed and accepted counts, the
de-speculation at the context limit, seeded sampled streams that draw
the reference's tokens, penalties (and a despec that restores their
counts), the prefix-cache registry left as a clean run leaves it, and
one draft dispatch a round. The gate, adaptive K, mixed rounds and the
metrics are in tests/test_torch_spec_gate.py."""
import asyncio
import queue

import jax
import numpy as np
import pytest

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

PS = 16
BASE = dict(num_pages=64, page_size=PS, max_pages_per_seq=8,
            max_decode_slots=2, prefill_buckets=(32, 64),
            cache_dtype="float32")
# the counters both engines keep, compared equal
COUNTERS = ("spec_proposed_total", "spec_accepted_total",
            "spec_verify_steps", "spec_reject_events", "spec_despec_total",
            "spec_draft_dispatch_total", "spec_verify_dispatch_total",
            "spec_gated_despec_total", "spec_rearm_total",
            "spec_k_grow_total", "spec_k_shrink_total")


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def prompts_mixed():
    """[repetitive, random]: tests/test_spec.py's prompts."""
    rng = np.random.RandomState(0)
    pat = rng.randint(1, 256, 8).tolist()
    return [pat * 4, rng.randint(1, 256, 20).tolist()]


def prompt_long():
    return [np.random.RandomState(1).randint(1, 256, 20).tolist()]


def make_engine(pkg, weights, draft=False, **kw):
    cfg = dict(BASE)
    cfg.update(kw)
    if pkg == "jax":
        ekw = (dict(draft_config=JConfig.tiny(dtype="float32"),
                    draft_params=weights[0]) if draft else {})
        return TpuEngine(JConfig.tiny(dtype="float32"), JEngineConfig(**cfg),
                         params=weights[0], mesh_config=MeshConfig(tp=1),
                         **ekw)
    ekw = (dict(draft_config=TConfig.tiny(dtype="float32"),
                draft_params=weights[1]) if draft else {})
    return TorchEngine(TConfig.tiny(dtype="float32"), TEngineConfig(**cfg),
                       params=weights[1], device="cpu", **ekw)


def request(proto, prompt, max_tokens, so=None, logprobs=None):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(max_tokens=max_tokens,
                                             ignore_eos=True))
    if so is not None:
        req.sampling_options = proto.SamplingOptions(**so)
    if logprobs is not None:
        req.output_options = proto.OutputOptions(logprobs=logprobs)
    return req


class GatedIntake(queue.Queue):
    """An engine's intake that shows nothing until ``n`` requests wait in
    it, and the engine's loop, which would otherwise start with the first
    request, starts only when the ``n``-th is put: each package's loop
    then begins with one round whose intake drain takes the whole burst
    (an idle loop that polls the intake, as the JAX package's does, would
    take the first request alone before the round drains the rest), so
    batching (and the counters that follow from it, such as verify
    dispatches) does not depend on the host's timing (with
    settle_results for the JAX package's asynchronous results)."""

    def __init__(self, n, engine=None):
        super().__init__()
        self.n, self.open, self.engine = n, False, engine
        if engine is not None:
            engine._started = True   # generate() starts no loop

    def put(self, item, block=True, timeout=None):
        super().put(item, block, timeout)
        if self.engine is not None and len(self.queue) == self.n:
            self.engine._started = False
            self.engine.start()

    def _qsize(self):
        if not self.open:
            if len(self.queue) < self.n:
                return 0
            self.open = True
        return len(self.queue)


def settle_results(eng):
    """Make a TpuEngine take each dispatched result only once its device
    work is done, as the CPU TorchEngine does (its results are ready when
    dispatched): the JAX package dispatches asynchronously and consumes a
    result when ``is_ready()``, so on a loaded host one slot's first token
    or verify could land a round after another's, and the verify batching
    (the dispatch counters) would follow the host's timing."""
    process = eng._process_entries

    def settled(block=False):
        for en in list(eng._entries):
            jax.block_until_ready((en.handle, en.lp_handle))
        process(block)

    eng._process_entries = settled


async def collect(eng, req):
    toks, outs = [], []
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
        outs.append(out)
    return toks, outs


def run(pkg, weights, prompts, max_tokens=24, so=None, draft=False,
        logprobs=None, **kw):
    """(token streams, finishing outputs, spec stats or None, the prefix
    registry's hashes, the engine) of one engine over ``prompts``
    submitted together and admitted in one intake drain."""
    eng = make_engine(pkg, weights, draft=draft, **kw)
    eng._intake = GatedIntake(len(prompts), eng)
    if pkg == "jax":
        settle_results(eng)
    proto = jproto if pkg == "jax" else tproto
    lps = logprobs or [None] * len(prompts)

    async def go():
        try:
            return await asyncio.gather(*[
                collect(eng, request(proto, p, max_tokens, so, lp))
                for p, lp in zip(prompts, lps)])
        finally:
            await eng.stop()

    res = asyncio.run(go())
    stats = eng.spec.stats() if eng.spec is not None else None
    return ([t for t, _ in res], [o[-1] for _, o in res], stats,
            frozenset(eng.allocator._registry), eng)


def assert_same_run(t, j, baseline=None, counters=True):
    """The port's run equals the reference's: streams, the prefix
    registry and (with ``counters``) the spec counters; with
    ``baseline`` (a non-speculative run) its streams and registry too."""
    assert t[0] == j[0]
    if counters:
        assert {k: t[2].get(k) for k in COUNTERS} == \
            {k: j[2].get(k) for k in COUNTERS}
    assert t[3] == j[3]
    if baseline is not None:
        assert t[0] == baseline[0]
        assert t[3] == baseline[3]


@pytest.fixture(scope="module")
def baseline_mixed(weights):
    return run("torch", weights, prompts_mixed())


@pytest.mark.parametrize("k", [2, 4])
def test_greedy_ngram_identical_to_the_reference(weights, baseline_mixed, k):
    """Mid-batch rejections (random weights reject most n-gram drafts)
    exercise the rollback; the registry matches a clean run's."""
    kw = dict(speculative="ngram", num_speculative_tokens=k)
    t = run("torch", weights, prompts_mixed(), **kw)
    assert_same_run(t, run("jax", weights, prompts_mixed(), **kw),
                    baseline_mixed)
    assert t[2]["spec_verify_steps"] > 0 and t[2]["spec_reject_events"] > 0


@pytest.mark.parametrize("batched", [True, False])
def test_greedy_draft_identical_to_the_reference(weights, baseline_mixed,
                                                 batched):
    """Draft == target accepts (nearly) everything; batched drafting is
    one draft dispatch a verify round, the per-slot path k a slot."""
    kw = dict(speculative="draft", num_speculative_tokens=4,
              spec_batch_draft=batched)
    t = run("torch", weights, prompts_mixed(), draft=True, **kw)
    assert_same_run(t, run("jax", weights, prompts_mixed(), draft=True,
                           **kw), baseline_mixed)
    st = t[2]
    assert st["spec_acceptance_rate"] > 0.8
    dc = t[4].dispatch_counts
    if batched:
        assert (st["spec_draft_dispatch_total"]
                == st["spec_verify_dispatch_total"]
                == dc["spec_draft"] == dc["spec_verify"] > 0)
    else:
        assert (st["spec_draft_dispatch_total"]
                > st["spec_verify_dispatch_total"] == dc["spec_verify"])
        assert dc["spec_draft"] == 0


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_despec_at_the_context_limit(weights, mode):
    """Near the region's end the verify no longer fits: the slot goes
    back to the fused round and its tail matches the reference's (64
    positions: a cap of 44 new tokens)."""
    kw = dict(max_pages_per_seq=4, speculative=mode,
              num_speculative_tokens=4)
    t = run("torch", weights, prompt_long(), 100, draft=mode == "draft",
            **kw)
    j = run("jax", weights, prompt_long(), 100, draft=mode == "draft", **kw)
    base = run("torch", weights, prompt_long(), 100, max_pages_per_seq=4)
    assert_same_run(t, j, base)
    assert len(t[0][0]) == 44 and t[2]["spec_despec_total"] >= 1


@pytest.mark.parametrize("so", [
    dict(temperature=0.9, seed=7),
    dict(temperature=0.9, seed=11, presence_penalty=0.5),
], ids=["sampled", "sampled_penalized"])
def test_seeded_sampled_streams_draw_the_reference_tokens(weights, so):
    """Rejection sampling consumes the slot's key stream as the JAX
    verifier does: a seeded request draws the reference's tokens, and
    repeats itself."""
    kw = dict(speculative="ngram", num_speculative_tokens=4)
    t = run("torch", weights, prompts_mixed()[:1], so=so, **kw)
    assert_same_run(t, run("jax", weights, prompts_mixed()[:1], so=so, **kw))
    again = run("torch", weights, prompts_mixed()[:1], so=so, **kw)
    assert again[0] == t[0] and len(t[0][0]) == 24
    assert t[2]["spec_verify_steps"] > 0


PENALTIES = dict(repetition_penalty=1.3, frequency_penalty=0.4,
                 presence_penalty=0.2)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_penalized_greedy_identical_to_the_reference(weights, mode):
    """Penalized requests speculate: the histogram advances along the
    accepted prefix, so greedy output equals the fused round's."""
    kw = dict(speculative=mode, num_speculative_tokens=4)
    draft = mode == "draft"
    t = run("torch", weights, prompts_mixed(), so=PENALTIES, draft=draft,
            **kw)
    j = run("jax", weights, prompts_mixed(), so=PENALTIES, draft=draft, **kw)
    assert_same_run(t, j, run("torch", weights, prompts_mixed(),
                              so=PENALTIES))
    assert t[2]["spec_verify_steps"] > 0


def test_penalized_despec_restores_the_counts(weights):
    """A context-limit despec hands the penalty histogram back to the
    fused sampler: the tail stays the non-speculative run's."""
    so = dict(repetition_penalty=1.4, frequency_penalty=0.3)
    kw = dict(max_pages_per_seq=4, speculative="ngram",
              num_speculative_tokens=4)
    t = run("torch", weights, prompt_long(), 100, so=so, **kw)
    j = run("jax", weights, prompt_long(), 100, so=so, **kw)
    base = run("torch", weights, prompt_long(), 100, so=so,
               max_pages_per_seq=4)
    assert_same_run(t, j, base)
    assert len(t[0][0]) == 44 and t[2]["spec_despec_total"] >= 1
