"""The tenancy plane of the PyTorch port against the JAX package's, on the
CPU: adapters, quotas and the tenant metrics on the same inputs, the
model functions with a LoRA bank (params_from_jax carries it across),
variant registration and its prefix-cache salt, /debug/tenants and the
tenant_stats tool.

Tolerances: the quota, admission and metric arithmetic is exact (equal
values and text); model logits and written KV in f32 within 1e-4
absolute, as the dense parity tests (another summation order of the same
products; the variants' factors at scale 0.5 put K/V values near 10, and
those move by up to 6e-5); adapter 0's logits bit-equal to a bank-less
model's (its delta is exactly 0.0, and the port issues no delta at all
for a host-known 0).
"""
import asyncio
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.overload import admission as radm
from dynamo_tpu.overload.errors import EngineOverloadedError as REOE
from dynamo_tpu.tenancy import adapters as ra
from dynamo_tpu.tenancy import metrics as rmetrics
from dynamo_tpu.tenancy import quotas as rq
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.overload import admission as padm
from dynamo_tpu_torch.overload.errors import EngineOverloadedError as PEOE
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.tenancy import adapters as pa
from dynamo_tpu_torch.tenancy import metrics as pmetrics
from dynamo_tpu_torch.tenancy import quotas as pq

ROOT = Path(__file__).resolve().parent.parent
RANK = 4


@pytest.fixture(autouse=True)
def _clean_tenant_registries():
    pmetrics.TENANT.reset()
    rmetrics.TENANT.reset()
    yield
    pmetrics.TENANT.reset()
    rmetrics.TENANT.reset()


# ---------------------------------------------------------------------------
# adapters


def test_site_dims_bank_and_random_factors_equal_the_references():
    for dtype in ("float32", "bfloat16"):
        jc, tc = JConfig.tiny(dtype=dtype), TConfig.tiny(dtype=dtype)
        assert pa.adapter_site_dims(tc) == ra.adapter_site_dims(jc)
    assert (pa.ATTN_SITES, pa.MLP_SITES) == (ra.ATTN_SITES, ra.MLP_SITES)
    jc, tc = JConfig.tiny(), TConfig.tiny()
    rbank = ra.init_adapter_bank(jc, 3, RANK)
    pbank = pa.init_adapter_bank(tc, 3, RANK, device="cpu")
    assert set(pbank) == set(rbank)
    for site in rbank:
        for f in "ab":
            assert tuple(pbank[site][f].shape) == rbank[site][f].shape
            assert not pbank[site][f].any()
    # the same numpy draws for a seed, so both packages install one variant
    for seed, scale in ((0, 0.05), (7, 0.5)):
        rf, pf = (ra.random_adapter(jc, RANK, seed=seed, scale=scale),
                  pa.random_adapter(tc, RANK, seed=seed, scale=scale))
        for site in rf:
            for f in "ab":
                np.testing.assert_array_equal(pf[site][f], rf[site][f])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_set_adapter_installs_the_references_rows(dtype):
    jc, tc = JConfig.tiny(), TConfig.tiny()
    w = ra.random_adapter(jc, RANK, seed=3, scale=0.5)
    # sites absent from the weights keep their rows
    w.pop("wd")
    rbank = ra.set_adapter(ra.init_adapter_bank(jc, 3, RANK), 2, w)
    pbank = pa.init_adapter_bank(tc, 3, RANK, dtype=dtype, device="cpu")
    ptrs = {s: ab["a"].data_ptr() for s, ab in pbank.items()}
    assert pa.set_adapter(pbank, 2, w) is pbank
    for site in rbank:
        assert pbank[site]["a"].data_ptr() == ptrs[site]  # in place
        for f in "ab":
            want = torch.tensor(np.asarray(rbank[site][f])).to(dtype)
            assert torch.equal(pbank[site][f], want), (site, f)
    with pytest.raises(ValueError, match="identity"):
        pa.set_adapter(pbank, 0, w)
    with pytest.raises(ValueError, match="identity"):
        ra.set_adapter(rbank, 0, w)
    with pytest.raises(ValueError, match="outside the bank"):
        pa.set_adapter(pbank, 3, w)
    bad = {"wq": {"a": np.zeros((2, 3, RANK)), "b": np.zeros((2, RANK, 5))}}
    with pytest.raises(ValueError, match="shape"):
        pa.set_adapter(pbank, 1, bad)


def test_adapter_registry_behaves_as_the_references():
    for reg in (ra.AdapterRegistry(), pa.AdapterRegistry()):
        reg.register("base:v1", "base", 1)
        reg.register("base:v2", "base", 2)
        assert reg.resolve("base:v1") == ("base", 1)
        assert reg.resolve("nope") is None
        reg.unregister("base:v1")
        reg.unregister("base:v1")  # twice is fine
        assert reg.variants() == {"base:v2": ("base", 2)}
        with pytest.raises(ValueError, match="start at 1"):
            reg.register("x", "base", 0)


# ---------------------------------------------------------------------------
# quotas and admission: the same arithmetic on the same inputs


@pytest.mark.parametrize("mreq,mtok,cases", [
    (2, 0, [(1, 0), (2, 0), (3, 999)]),
    (0, 100, [(50, 99), (0, 100), (9, 101)]),
    (0, 0, [(0, 0), (100, 10 ** 6)]),
    (3, 64, [(2, 63), (2, 64), (3, 0)]),
])
def test_quotas_and_admission_budgets_equal_the_references(mreq, mtok,
                                                           cases):
    waits = [0.3, 2.0, 0.01, 1.5, 0.7]
    rquo = rq.TenantQuotas(mreq, mtok, weights={"big": 4.0, "typo": 0.0})
    pquo = pq.TenantQuotas(mreq, mtok, weights={"big": 4.0, "typo": 0.0})
    for w in waits:
        rquo.note_queue_wait("storm", w)
        pquo.note_queue_wait("storm", w)
    radc = radm.AdmissionController(mreq, mtok, queue_wait_s=lambda: 0.8)
    padc = padm.AdmissionController(mreq, mtok, queue_wait_s=lambda: 0.8)
    assert (pquo.bounded, padc.bounded) == (rquo.bounded, radc.bounded)
    for t in ("big", "typo", "none"):
        assert pquo.weight(t) == rquo.weight(t)
    assert pquo.snapshot() == rquo.snapshot()
    for n, tok in cases:
        assert pquo.over_budget(n, tok) == rquo.over_budget(n, tok)
        assert padc.over_budget(n, tok) == radc.over_budget(n, tok)
        for t in ("storm", "fresh"):
            assert pquo.retry_after_s(t, n) == rquo.retry_after_s(t, n)
        assert padc.retry_after_s(n) == radc.retry_after_s(n)
        for (pcheck, rcheck) in ((lambda: pquo.check("storm", n, tok),
                                  lambda: rquo.check("storm", n, tok)),
                                 (lambda: padc.check(n, tok),
                                  lambda: radc.check(n, tok))):
            got = want = None
            try:
                pcheck()
            except PEOE as e:
                got = (str(e), e.retry_after_s, e.tenant)
            try:
                rcheck()
            except REOE as e:
                want = (str(e), e.retry_after_s, e.tenant)
            assert got == want
    assert (padm.RETRY_AFTER_MIN_S, padm.RETRY_AFTER_MAX_S,
            padm.DEFAULT_QUEUE_WAIT_S) == (radm.RETRY_AFTER_MIN_S,
                                           radm.RETRY_AFTER_MAX_S,
                                           radm.DEFAULT_QUEUE_WAIT_S)


def test_a_failing_queue_wait_probe_falls_back_as_the_reference():
    def boom():
        raise RuntimeError("probe")

    for mod in (padm, radm):
        adc = mod.AdmissionController(1, queue_wait_s=boom)
        assert adc.retry_after_s(4) == 4 * mod.DEFAULT_QUEUE_WAIT_S


@pytest.mark.parametrize("value", [None, "", "  acme ", 'ac"me\\x\n',
                                   123, "x" * 200])
def test_parse_tenant_equals_the_reference(value):
    assert pq.parse_tenant(value) == rq.parse_tenant(value)
    assert (pq.TENANT_HEADER, pq.DEFAULT_TENANT) == (rq.TENANT_HEADER,
                                                     rq.DEFAULT_TENANT)


# ---------------------------------------------------------------------------
# the dynamo_tenant_* families


def _drive_registry(reg):
    reg.inc("dynamo_tenant_admitted_total", "acme")
    reg.inc("dynamo_tenant_admitted_total", "acme", 2)
    reg.inc("dynamo_tenant_rejected_total", 'sto"rm\n')
    reg.set("dynamo_tenant_queue_depth", "acme", 3)
    reg.set("dynamo_tenant_queue_tokens", "acme", 2.5)
    for v in (0.004, 0.2, 1.7):
        reg.observe("dynamo_tenant_request_ttft_seconds", "acme", v)
    reg.observe("dynamo_tenant_request_queue_seconds", "zed", 0.03)


def test_tenant_registry_renders_and_snapshots_as_the_reference():
    assert pmetrics.FAMILIES == rmetrics.FAMILIES
    assert pmetrics.HISTOGRAMS == rmetrics.HISTOGRAMS
    # the heads render before any tenant is seen
    assert pmetrics.TenantRegistry().render() == \
        rmetrics.TenantRegistry().render()
    p, r = pmetrics.TenantRegistry(), rmetrics.TenantRegistry()
    _drive_registry(p)
    _drive_registry(r)
    assert p.render() == r.render()
    assert p.snapshot() == r.snapshot()
    assert p.tenants() == r.tenants()
    for t in ("acme", "zed", "nobody"):
        for q in (0.5, 0.99):
            assert (p.percentile("dynamo_tenant_request_ttft_seconds", t, q)
                    == r.percentile("dynamo_tenant_request_ttft_seconds",
                                    t, q))
    assert p.get("dynamo_tenant_admitted_total", "acme") == 3
    with pytest.raises(AssertionError):
        p.inc("dynamo_tenant_nope_total", "acme")
    p.reset()
    assert p.tenants() == []


# ---------------------------------------------------------------------------
# the model functions with a bank


@pytest.fixture(scope="module")
def banked():
    """Tiny f32 weights with a 4-row bank (rows 1 and 2 random, 3 zero),
    in both packages."""
    jc = JConfig.tiny(dtype="float32")
    p = jl.init_params(jc, 0)
    bank = ra.init_adapter_bank(jc, 4, RANK)
    for aid, seed in ((1, 7), (2, 8)):
        bank = ra.set_adapter(bank, aid,
                              ra.random_adapter(jc, RANK, seed=seed,
                                                scale=0.5))
    jp = dict(p, adapters=bank)
    tp = tl.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, TConfig.tiny(dtype="float32"), jp, tp


def test_params_from_jax_carries_the_bank(banked):
    _, _, jp, tp = banked
    for site, ab in jp["adapters"].items():
        for f in "ab":
            np.testing.assert_array_equal(tp["adapters"][site][f].numpy(),
                                          np.asarray(ab[f]))
    assert tp["adapters"]["wq"]["a"].dtype == torch.float32


def _ctx(jc, lanes, length, seed):
    rng = np.random.RandomState(seed)
    shape = (jc.num_layers, jc.num_kv_heads, lanes, length, jc.head_dim)
    st = {n: (rng.randn(*shape) * 0.5).astype(np.float32) for n in "kv"}
    return ({n: jnp.asarray(a) for n, a in st.items()},
            {n: torch.from_numpy(a.copy()) for n, a in st.items()})


@pytest.mark.parametrize("aid", [0, 1, 2, 3])
def test_prefill_logits_with_an_adapter_match_jax(banked, aid):
    jc, tc, jp, tp = banked
    toks = np.random.RandomState(5).randint(1, jc.vocab_size, 32)
    toks = toks.astype(np.int32)
    jctx, tctx = _ctx(jc, 3, 64, 6)
    _, jlog = jl.prefill_impl(jc, jp, jctx, jnp.asarray(toks), jnp.int32(1),
                              jnp.int32(0), jnp.int32(27), None, None,
                              jnp.int32(aid))
    tlog = tl.prefill(tc, tp, tctx, torch.from_numpy(toks), 1, 0, 27, aid)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    if aid in (0, 3):
        # a zero row: the logits of the model without a bank, bit for bit
        bare = {k: v for k, v in tp.items() if k != "adapters"}
        _, tctx2 = _ctx(jc, 3, 64, 6)
        assert torch.equal(
            tl.prefill(tc, bare, tctx2, torch.from_numpy(toks), 1, 0, 27),
            tlog)


def test_batch_prefill_with_mixed_adapters_matches_jax(banked):
    """Four chunks with ids 0, 1, 2, 1 (the last over prior context)."""
    jc, tc, jp, tp = banked
    rng = np.random.RandomState(9)
    T = 16
    toks = rng.randint(1, jc.vocab_size, (4, T)).astype(np.int32)
    slots, q_starts, seq_lens = [0, 1, 2, 3], [0, 0, 0, 16], [16, 11, 16, 29]
    ids = [0, 1, 2, 1]
    jctx, tctx = _ctx(jc, 5, 64, 10)
    jctx, jlog = jl.batch_prefill_impl(
        jc, jp, jctx, jnp.asarray(toks), jnp.asarray(slots),
        jnp.asarray(q_starts), jnp.asarray(seq_lens), 64,
        jnp.asarray(ids, jnp.int32))
    tlog = tl.batch_prefill(tc, tp, tctx, torch.from_numpy(toks), slots,
                            q_starts, seq_lens, 64, adapter_ids=ids)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    # the rows each chunk wrote below its seq_len (a padding row's KV
    # follows its fully masked attention, which the two attentions leave
    # in different states)
    for n in "kv":
        for i, (q, sl) in enumerate(zip(q_starts, seq_lens)):
            np.testing.assert_allclose(
                tctx[n][:, :, slots[i], q:sl].numpy(),
                np.asarray(jctx[n])[:, :, slots[i], q:sl], rtol=0,
                atol=1e-4)


def test_decode_step_with_mixed_adapters_matches_jax(banked):
    """Three steps of B = 4 slots with ids 2, 0, 1, 3, fed the reference's
    greedy tokens; the rows gathered once (``gathered``) or in the step
    give the same logits."""
    jc, tc, jp, tp = banked
    B, R = 4, 4
    jctx, tctx = _ctx(jc, B + 1, 64, 11)
    jring, tring = _ctx(jc, B, R, 12)
    ids = np.asarray([2, 0, 1, 3], np.int32)
    tids = torch.from_numpy(ids)
    toks = np.asarray([3, 9, 27, 81], np.int32)
    base = np.asarray([20, 33, 7, 50], np.int32)
    pre = tl.gather_adapters(tp["adapters"], tids)
    for step in range(3):
        lens = base + step + 1
        jring, jlog = jl.decode_step_impl(
            jc, jp, jctx, jring, jnp.asarray(toks), jnp.asarray(lens),
            jnp.asarray(base), jnp.int32(step), None, jnp.asarray(ids))
        args = (tc, tp, tctx, tring, torch.from_numpy(toks.copy()),
                torch.from_numpy(lens), torch.from_numpy(base), step)
        tlog = tl.decode_step(*args, adapter_ids=tids)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-4)
        assert torch.equal(tl.decode_step(*args, gathered=pre), tlog)
        toks = np.asarray(jnp.argmax(jlog, axis=-1), np.int32)


def test_gather_adapters_skips_host_zero_ids(banked):
    _, _, _, tp = banked
    bank = tp["adapters"]
    assert tl.gather_adapters(None, [1]) is None
    assert tl.gather_adapters(bank, None) is None
    assert tl.gather_adapters(bank, 0) is None
    assert tl.gather_adapters(bank, [0, 0, 0]) is None
    one = tl.gather_adapters(bank, 2)
    assert one["wq"][0].data_ptr() == bank["wq"]["a"][2].data_ptr()
    rows = tl.gather_adapters(bank, [2, 0])
    assert torch.equal(rows["wd"][1][0], bank["wd"]["b"][2])
    assert not rows["wd"][1][1].any()
    # device ids are always gathered (a graph cannot look at them)
    assert tl.gather_adapters(bank, torch.zeros(2, dtype=torch.int64)) \
        is not None


def test_tree_chunks_refuse_adapters(banked):
    jc, tc, _, tp = banked
    _, tctx = _ctx(jc, 2, 64, 13)
    toks = torch.ones(1, 4, dtype=torch.int64)
    with pytest.raises(AssertionError, match="base-model only"):
        tl._batch_forward(tc, tp, tctx, toks, [0], [8], [12], 64,
                          depths=torch.zeros(1, 4, dtype=torch.int64),
                          chunk_masks=torch.ones(1, 4, 4, dtype=torch.bool),
                          adapter_ids=[1])


# ---------------------------------------------------------------------------
# variants: registration and the prefix-cache salt


def test_register_variant_shares_the_base_chain():
    from dynamo_tpu_torch.frontend.model_manager import (
        ModelChain,
        ModelManager,
        ModelNotFound,
    )
    from dynamo_tpu_torch.protocols.openai import CompletionRequest

    class _StubPre:
        def preprocess_completion(self, r):
            return PreprocessedRequest(token_ids=[1, 2], model="base")

    engine = object()
    mgr = ModelManager()
    mgr.register(ModelChain(name="base", preprocessor=_StubPre(),
                            engine=engine, backend=None))
    var = mgr.register_variant("base:support-bot", "base", adapter_id=2)
    # one engine (one weight load, one tokenizer) behind both names
    assert var.engine is engine
    assert mgr.get("base:support-bot").adapter_id == 2
    assert mgr.get("base").adapter_id == 0
    creq = CompletionRequest(model="base:support-bot", prompt="hi")
    pre = var.preprocess(creq)
    # the VARIANT name is the prefix-cache salt
    assert (pre.adapter_id, pre.model) == (2, "base:support-bot")
    base_pre = mgr.get("base").preprocess(creq)
    assert (base_pre.adapter_id, base_pre.model) == (0, "base")
    with pytest.raises(ValueError):
        mgr.register_variant("bad", "base", adapter_id=0)
    with pytest.raises(ModelNotFound):
        mgr.register_variant("x", "no-such-base", adapter_id=1)


def test_variant_salt_keeps_variants_off_each_others_prefix_pages():
    """One banked engine, one 40-token prompt as the base, as variant v1
    twice and as variant v2: the second v1 run matches v1's cached
    blocks; the base and v2 runs match nothing of another name's."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    tc = TConfig.tiny(dtype="float32")
    eng = TorchEngine(tc, EngineConfig(
        num_pages=64, page_size=16, max_pages_per_seq=8, max_decode_slots=2,
        prefill_buckets=(32, 64), cache_dtype="float32", lora_adapters=3,
        lora_rank=RANK), device="cpu")
    eng.install_adapter(1, pa.random_adapter(tc, RANK, seed=7, scale=0.5))
    eng.install_adapter(2, pa.random_adapter(tc, RANK, seed=8, scale=0.5))
    prompt = np.random.RandomState(4).randint(1, 256, 40).tolist()

    async def one(model, aid):
        req = PreprocessedRequest(token_ids=list(prompt), model=model,
                                  adapter_id=aid)
        req.stop_conditions.max_tokens = 4
        req.stop_conditions.ignore_eos = True
        toks, ann = [], {}
        async for out in eng.generate(req):
            toks.extend(out.token_ids)
            ann = out.annotations or ann
        return toks, ann["cached_blocks"]

    async def run():
        got = [await one("base", 0), await one("base:v1", 1),
               await one("base:v1", 1), await one("base:v2", 2)]
        await eng.stop()
        return got

    (b, cb), (v1, c1), (v1b, c1b), (v2, c2) = asyncio.run(run())
    assert (cb, c1, c1b, c2) == (0, 0, 2, 0)
    assert v1 == v1b and len({tuple(b), tuple(v1), tuple(v2)}) == 3


# ---------------------------------------------------------------------------
# /debug/tenants and the tenant_stats tool


def _service(engine):
    from dynamo_tpu_torch.backend import Backend
    from dynamo_tpu_torch.frontend.model_manager import ModelChain, \
        ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor, \
        PromptFormatter
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    tok = make_test_tokenizer([f"w{i}" for i in range(100)])
    mgr = ModelManager()
    mgr.register(ModelChain(
        name="tiny", preprocessor=OpenAIPreprocessor(
            tokenizer=tok, formatter=PromptFormatter(), model_name="tiny"),
        engine=engine, backend=Backend(tok)))
    return HttpService(mgr, host="127.0.0.1", port=0)


def _tool(*args):
    return subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.tools.tenant_stats", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


def _ref_tool(*args):
    return subprocess.run(
        [sys.executable, str(ROOT / "tools" / "tenant_stats.py"), *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_debug_tenants_and_the_tool_exit_contract():
    """The frontend's /debug/tenants over a banked TorchEngine with tenant
    budgets; the port's tool keeps the JAX package's exit codes and
    prints what the JAX package's tool prints."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.frontend.http import HttpClient

    eng = TorchEngine(TConfig.tiny(dtype="float32"), EngineConfig(
        num_pages=64, page_size=16, max_pages_per_seq=8, max_decode_slots=2,
        prefill_buckets=(32, 64), cache_dtype="float32", lora_adapters=2,
        lora_rank=RANK, tenant_max_waiting_requests=3,
        tenant_weights={"acme": 2.0}), device="cpu")
    svc = _service(eng)

    async def run():
        await svc.start()
        addr = f"127.0.0.1:{svc.port}"
        try:
            first = await asyncio.to_thread(_tool, "--frontend", addr)
            async with HttpClient("127.0.0.1", svc.port) as c:
                for tenant in ("acme", "other"):
                    r = await c.request(
                        "POST", "/v1/completions",
                        json_body={"model": "tiny", "prompt": "w1 w2 w3",
                                   "max_tokens": 3},
                        headers={"X-Tenant-Id": tenant})
                    assert r.status == 200
                r = await c.request("GET", "/debug/tenants")
                view = json.loads(r.body)
            runs = await asyncio.gather(*[asyncio.to_thread(f, *a) for f, a in (
                (_tool, ("--frontend", addr)),
                (_tool, ("--frontend", addr, "--tenant", "acme")),
                (_ref_tool, ("--frontend", addr, "--tenant", "acme")),
                (_tool, ("--frontend", addr, "--tenant", "ghost")),
                (_tool, ("--frontend", "127.0.0.1:1")),
                (_tool, ()))])
            return first, view, runs
        finally:
            await svc.stop()
            await eng.stop()

    first, view, (all_, acme, ref_acme, ghost, down, usage) = \
        asyncio.run(run())
    assert first.returncode == 1, first.stderr
    assert json.loads(first.stdout)["engines"]["tiny"]["tenants"] == {}
    dbg = view["engines"]["tiny"]
    assert (dbg["bounded"], dbg["max_waiting_requests"],
            dbg["n_adapters"]) == (True, 3, 2)
    a = dbg["tenants"]["acme"]
    assert a["waiting_requests"] == 0 and a["weight"] == 2.0
    assert a["queue_wait_p50_s"] >= 0
    assert a["metrics"]["dynamo_tenant_admitted_total"] == 1
    assert view["tenants"]["acme"]["dynamo_tenant_admitted_total"] == 1
    assert all_.returncode == 0
    assert set(json.loads(all_.stdout)["engines"]["tiny"]["tenants"]) == {
        "acme", "other"}
    assert acme.returncode == 0 == ref_acme.returncode
    assert set(json.loads(acme.stdout)["engines"]["tiny"]["tenants"]) == {
        "acme"}
    assert json.loads(acme.stdout)["engines"]["tiny"]["tenants"].keys() \
        == json.loads(ref_acme.stdout)["engines"]["tiny"]["tenants"].keys()
    assert ghost.returncode == 2 and "not seen" in ghost.stderr
    assert down.returncode == 2 and "cannot reach" in down.stderr
    assert usage.returncode == 2


def test_metrics_surfaces_render_the_tenant_families():
    from dynamo_tpu_torch.runtime.system_server import SystemServer

    pmetrics.TENANT.inc("dynamo_tenant_admitted_total", "acme")
    text = SystemServer(None).render()
    for name, typ, _ in pmetrics.FAMILIES:
        assert f"# TYPE {name} {typ}" in text
    assert 'dynamo_tenant_admitted_total{tenant="acme"} 1' in text
