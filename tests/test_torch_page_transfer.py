"""The port's page-transfer plane against the JAX package's.

- Device ops: ``gather_pages``/``scatter_pages`` (``_q`` for an int8
  pool) and the cross-mode ``load_ctx_pages``/``seal_blocks`` (a dense
  pool beside an int8 region and the reverse) against the JAX
  ``*_impl`` functions on the same inputs from a numpy seed: int8 bytes
  and scales exact, dense values within 1e-6.
- Host bundle (kv_quant.py): ``quantize_pages``, ``dequantize`` and
  ``to_pool_dtype`` byte-equal to the JAX package's.
- Engine: after the same prompts, TorchEngine's ``export_pages`` equals
  TpuEngine's within f32 rounding (the two packages compute the KV with
  different summation orders); with the JAX engine's exported bytes
  imported into the port's pool, ``export_pages``,
  ``export_pages_by_hash`` and the two streams (chunks concatenated)
  give exactly those bytes, as the JAX engine's own do; import then
  export round-trips; a dense payload imported into an int8 pool gives
  the JAX engine's bytes; an abandoned stream releases its page pins
  after ``kv_transfer_stream_idle_timeout_s``; ``clear_kv_blocks``
  returns the JAX count.
- Entry points: POST /clear_kv_blocks over the port's HTTP service,
  /metrics with the KV families, and the launcher's offload flags."""
import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.kv_quant import QuantizedPages as JQuantizedPages
from dynamo_tpu.kv_quant import quantize_pages as j_quantize_pages
from dynamo_tpu.kv_quant import to_pool_dtype as j_to_pool_dtype
from dynamo_tpu.launch import run as rrun
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.frontend.http import HttpClient
from dynamo_tpu_torch.frontend.model_manager import ModelChain, ModelManager
from dynamo_tpu_torch.frontend.service import HttpService
from dynamo_tpu_torch.kv_quant import (
    QuantizedPages,
    is_quantized,
    quantize_pages,
    to_pool_dtype,
)
from dynamo_tpu_torch.launch import run as prun
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto

PS = 16
L, KVH, HD = 2, 2, 8


def raw(x) -> bytes:
    if isinstance(x, (QuantizedPages, JQuantizedPages)):
        return raw(x.data) + raw(x.scales)
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def to_torch(x):
    """A JAX export (array or bundle) as the port's host pages."""
    if isinstance(x, JQuantizedPages):
        return QuantizedPages(torch.from_numpy(np.array(x.data)),
                              torch.from_numpy(np.array(x.scales)))
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# device ops against the JAX impls


def _pool(rng, n_pages, quant):
    shape = (L, KVH, n_pages, PS, HD)
    if quant:
        q = rng.integers(-127, 128, size=shape).astype(np.int8)
        s = rng.uniform(0.01, 0.1, size=(L, n_pages)).astype(np.float32)
        return {"k": q, "v": q[::-1].copy(), "k_scale": s,
                "v_scale": s[::-1].copy()}
    k = rng.standard_normal(shape).astype(np.float32)
    return {"k": k, "v": -k}


def _ctx(rng, lanes, S, quant):
    shape = (L, KVH, lanes, S, HD)
    if quant:
        q = rng.integers(-127, 128, size=shape).astype(np.int8)
        s = rng.uniform(0.01, 0.1, size=(L, lanes, S // PS)).astype(
            np.float32)
        return {"k": q, "v": q[::-1].copy(), "k_scale": s,
                "v_scale": s[::-1].copy()}
    k = rng.standard_normal(shape).astype(np.float32)
    return {"k": k, "v": k * 0.5}


def _tt(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _check(got: dict, want: dict):
    assert set(got) == set(want)
    for name, t in got.items():
        w = np.asarray(want[name])
        if w.dtype == np.int8 or name.endswith("_scale"):
            # int8 payloads and their scales: exact
            assert raw(t) == raw(w), name
        else:
            np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("pool_q,ctx_q", [(True, False), (False, True),
                                          (True, True), (False, False)])
def test_load_ctx_pages_cross_mode_as_jax(pool_q, ctx_q):
    rng = np.random.default_rng(1)
    cache, ctx = _pool(rng, 6, pool_q), _ctx(rng, 3, 4 * PS, ctx_q)
    ids = np.array([4, 1, 5, 0], np.int32)   # the last one pads to page 0
    want = jl.load_ctx_pages_impl(
        {k: jnp.asarray(v) for k, v in ctx.items()},
        {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.int32(1), jnp.asarray(ids))
    got = _tt(ctx)
    tl.load_ctx_pages(got, _tt(cache), 1, torch.from_numpy(ids).long())
    _check(got, want)


@pytest.mark.parametrize("pool_q,ctx_q", [(True, False), (False, True),
                                          (True, True), (False, False)])
def test_seal_blocks_cross_mode_as_jax(pool_q, ctx_q):
    rng = np.random.default_rng(2)
    cache, ctx = _pool(rng, 6, pool_q), _ctx(rng, 3, 4 * PS, ctx_q)
    slots = np.array([0, 2, 1, 0], np.int32)
    starts = np.array([PS, 0, 3 * PS, 0], np.int32)
    pages = np.array([3, 5, 1, 0], np.int32)
    want = jl.seal_blocks_impl(
        {k: jnp.asarray(v) for k, v in cache.items()},
        {k: jnp.asarray(v) for k, v in ctx.items()},
        jnp.asarray(slots), jnp.asarray(starts), jnp.asarray(pages), PS)
    got = _tt(cache)
    tl.seal_blocks(got, _tt(ctx), *(torch.from_numpy(a).long()
                                    for a in (slots, starts, pages)), PS)
    _check(got, want)


@pytest.mark.parametrize("quant", [False, True])
def test_gather_scatter_pages_as_jax(quant):
    rng = np.random.default_rng(3)
    cache = _pool(rng, 6, quant)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    ids = np.array([2, 5, 1], np.int32)
    tids = torch.from_numpy(ids).long()
    src = _tt(_pool(np.random.default_rng(4), 6, quant))
    if quant:
        jd, js = jl.gather_pages_q_impl(jcache, jnp.asarray(ids))
        td, ts = tl.gather_pages_q(_tt(cache), tids)
        assert raw(td) == raw(jd) and raw(ts) == raw(js)
        d, s = tl.gather_pages_q(src, tids)
        want = jl.scatter_pages_q_impl(jcache, jnp.asarray(ids),
                                       jnp.asarray(d.numpy()),
                                       jnp.asarray(s.numpy()))
        got = _tt(cache)
        storage = got["k"].data_ptr()
        tl.scatter_pages_q(got, tids, d, s)
    else:
        assert raw(tl.gather_pages(_tt(cache), tids)) == raw(
            jl.gather_pages_impl(jcache, jnp.asarray(ids)))
        d = tl.gather_pages(src, tids)
        want = jl.scatter_pages_impl(jcache, jnp.asarray(ids),
                                     jnp.asarray(d.numpy()))
        got = _tt(cache)
        storage = got["k"].data_ptr()
        tl.scatter_pages(got, tids, d)
    _check(got, want)
    # in place: the round graphs captured the pool's storage
    assert got["k"].data_ptr() == storage


# ---------------------------------------------------------------------------
# host page bundle


def test_quantize_dequantize_to_pool_dtype_as_jax():
    rng = np.random.default_rng(5)
    dense = rng.standard_normal((2, L, KVH, 3, PS, HD)).astype(np.float32)
    dense[:, :, :, 1] = 0.0   # an all-zero page takes the scale floor
    jq = j_quantize_pages(dense)
    tq = quantize_pages(torch.from_numpy(dense))
    assert raw(tq.data) == raw(jq.data) and raw(tq.scales) == raw(jq.scales)
    assert tq.n_pages == 3 and tq.shape == jq.shape
    assert tq.nbytes == jq.nbytes
    assert raw(tq.dequantize(torch.float32)) == raw(
        jq.dequantize(np.float32))
    sl = tq.slice_pages(1, 3)
    assert sl.n_pages == 2 and raw(sl.page(0)[0]) == raw(jq.page(1)[0])
    assert is_quantized(tq) and not is_quantized(tq.data)
    assert raw(to_pool_dtype(torch.from_numpy(dense), True, torch.float32)
               ) == raw(j_to_pool_dtype(dense, True, np.float32))
    assert raw(to_pool_dtype(tq, False, torch.float32)) == raw(
        j_to_pool_dtype(jq, False, np.float32))
    assert to_pool_dtype(tq, True, torch.float32) is tq


# ---------------------------------------------------------------------------
# engine page I/O, TorchEngine beside TpuEngine

KW = dict(num_pages=32, page_size=PS, max_pages_per_seq=8,
          max_decode_slots=2, prefill_buckets=(32, 64),
          cache_dtype="float32")
PROMPTS = [list(range(1, 70)), list(range(100, 140))]


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    return jparams, jax.tree.map(np.asarray, jparams)


async def _collect(eng, proto, prompt, n_new=20):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True))
    toks = []
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
    return toks


def _chain(eng):
    """The committed pages of the first prompt's chain, in chain order,
    and their hashes."""
    a = eng.allocator
    pages = sorted(a._page_hash)
    return pages, [a._page_hash[p] for p in pages]


async def _transfers(eng, proto, imported=None):
    """Prompts, then every export form of the first prompt's chain; with
    ``imported`` (a host payload), that payload is first imported over
    the chain's pages."""
    toks = [await _collect(eng, proto, p) for p in PROMPTS[:1]]
    await asyncio.sleep(0.1)
    pages, hashes = _chain(eng)
    run = asyncio.to_thread
    if imported is not None:
        await run(eng.import_pages, pages, imported)
    exp = await run(eng.export_pages, pages)
    found, by_hash = await run(eng.export_pages_by_hash, hashes + [12345])
    stream = await run(lambda: list(eng.export_pages_stream(pages, 2)))
    found2, it = await run(eng.export_hash_stream, hashes, 2, 1)
    hstream = await run(lambda: list(it))
    out = dict(toks=toks, pages=pages, exp=exp, found=found,
               by_hash=by_hash, stream=stream, found2=found2,
               hstream=hstream)
    await eng.stop()
    return out


def _cat(chunks):
    """Stream chunks concatenated along the page axis, as bytes."""
    if isinstance(chunks[0], JQuantizedPages):
        return raw(np.concatenate([c.data for c in chunks], axis=3)) + raw(
            np.concatenate([c.scales for c in chunks], axis=2))
    if isinstance(chunks[0], QuantizedPages):
        return raw(torch.cat([c.data for c in chunks], dim=3)) + raw(
            torch.cat([c.scales for c in chunks], dim=2))
    if isinstance(chunks[0], torch.Tensor):
        return raw(torch.cat(chunks, dim=3))
    return raw(np.concatenate([np.asarray(c) for c in chunks], axis=3))


def _engines(weights, **kw):
    j = TpuEngine(JConfig.tiny(dtype="float32"), JEngineConfig(**KW, **kw),
                  params=weights[0], mesh_config=MeshConfig(tp=1))
    t = TorchEngine(TConfig.tiny(dtype="float32"), TEngineConfig(**KW, **kw),
                    params=params_from_jax(weights[1], device="cpu"),
                    device="cpu")
    return j, t


@pytest.fixture(scope="module", params=["none", "int8"])
def exports(request, weights):
    j, t = _engines(weights, kv_quant=request.param)
    jres = asyncio.run(_transfers(j, jproto))
    tres = asyncio.run(_transfers(t, tproto))
    # the same payload (the JAX engine's export) imported into both pools
    j2, t2 = _engines(weights, kv_quant=request.param)
    jimp = asyncio.run(_transfers(j2, jproto, imported=jres["exp"]))
    timp = asyncio.run(_transfers(t2, tproto, imported=to_torch(jres["exp"])))
    return request.param, jres, tres, jimp, timp


def test_export_pages_equal_tpu_engine_within_f32(exports):
    kv_quant, j, t, _, _ = exports
    assert t["toks"] == j["toks"] and t["pages"] == j["pages"]
    assert len(t["pages"]) == 5   # 4 prompt blocks + 1 sealed in decode
    if kv_quant == "int8":
        # requantized from KV that differs in f32 rounding: compare the
        # values, one quantization step per element at most
        jd = np.asarray(j["exp"].data, np.float32) * np.asarray(
            j["exp"].scales)[:, :, None, :, None, None]
        td = t["exp"].dequantize(torch.float32).numpy()
        step = float(np.asarray(j["exp"].scales).max())
        assert np.abs(td - jd).max() <= 1.01 * step + 1e-6
        # the scales are absmax / 127 of values whose own rounding
        # differences passed through the earlier layers' int8 KV
        np.testing.assert_allclose(t["exp"].scales.numpy(),
                                   np.asarray(j["exp"].scales), rtol=1e-4)
    else:
        np.testing.assert_allclose(t["exp"].numpy(), np.asarray(j["exp"]),
                                   rtol=0, atol=1e-5)


def test_exports_of_imported_bytes_equal_tpu_engine(exports):
    """One payload in both pools: every export form is byte-equal to it,
    in the port as in the JAX engine."""
    _, j, _, jimp, timp = exports
    want = raw(j["exp"])
    for res in (jimp, timp):
        assert raw(res["exp"]) == want
        assert res["found"] == len(res["pages"])
        assert raw(res["by_hash"]) == want
        assert _cat(res["stream"]) == want
        assert len(res["stream"]) == 3   # chunks of 2, 2, 1 pages
        assert res["found2"] == len(res["pages"])
        assert _cat(res["hstream"]) == want


def test_import_export_round_trip_and_cross_mode_import(weights):
    async def drive(eng, proto, payload):
        await _collect(eng, proto, PROMPTS[0])
        await asyncio.sleep(0.1)
        pages, _ = _chain(eng)
        first = await asyncio.to_thread(eng.export_pages, pages)
        fresh = eng.allocator.allocate(len(pages))
        await asyncio.to_thread(eng.import_pages, fresh, first)
        again = await asyncio.to_thread(eng.export_pages, fresh)
        # a dense payload into this (int8) pool quantizes on the way in
        await asyncio.to_thread(eng.import_pages, fresh, payload)
        crossed = await asyncio.to_thread(eng.export_pages, fresh)
        eng.allocator.free(fresh)
        await eng.stop()
        return raw(first), raw(again), raw(crossed)

    rng = np.random.default_rng(6)
    c = TConfig.tiny(dtype="float32")
    dense = rng.standard_normal(
        (2, c.num_layers, c.num_kv_heads, 5, PS, c.head_dim)).astype(
        np.float32)
    j, t = _engines(weights, kv_quant="int8")
    jr = asyncio.run(drive(j, jproto, dense))
    tr = asyncio.run(drive(t, tproto, torch.from_numpy(dense)))
    assert tr[0] == tr[1] and jr[0] == jr[1]
    assert tr[2] == jr[2]


def test_abandoned_stream_releases_its_pins(weights):
    """A hash stream whose consumer stops pulling parks with a full queue;
    after the idle timeout the engine frees its page pins and the
    consumer's next pull raises."""
    eng = TorchEngine(TConfig.tiny(dtype="float32"),
                      TEngineConfig(**KW,
                                    kv_transfer_stream_idle_timeout_s=0.3),
                      params=params_from_jax(weights[1], device="cpu"),
                      device="cpu")

    async def drive():
        await _collect(eng, tproto, PROMPTS[0])
        await asyncio.sleep(0.1)
        pages, hashes = _chain(eng)
        found, it = await asyncio.to_thread(eng.export_hash_stream,
                                            hashes, 1, 1)
        assert found == len(pages)
        assert all(eng.allocator._ref.get(p) for p in pages)  # pinned
        t0 = time.monotonic()
        while any(eng.allocator._ref.get(p) for p in pages):
            assert time.monotonic() - t0 < 10, "pins never released"
            await asyncio.sleep(0.05)
        assert time.monotonic() - t0 >= 0.2
        chunks = []
        with pytest.raises(RuntimeError, match="abandoned"):
            for c in it:
                chunks.append(c)
        assert 1 <= len(chunks) < len(pages)
        # the pages park again, prefix-hittable
        assert eng.allocator.cached_prefix_len(hashes) == len(pages)
        await eng.stop()

    asyncio.run(drive())


def test_clear_kv_blocks_returns_the_tpu_engine_count(weights):
    async def drive(eng, proto):
        for p in PROMPTS:
            await _collect(eng, proto, p)
        await asyncio.sleep(0.1)
        n = await asyncio.to_thread(eng.clear_kv_blocks)
        left = len(eng.allocator._registry)
        await eng.stop()
        return n, left

    j, t = _engines(weights)
    jn, tn = asyncio.run(drive(j, jproto)), asyncio.run(drive(t, tproto))
    assert tn == jn and tn[0] >= 7 and tn[1] == 0


def test_transfer_ops_after_stop_raise(weights):
    _, t = _engines(weights)
    asyncio.run(t.stop())
    with pytest.raises(RuntimeError, match="stopped"):
        t.export_pages([1])
    with pytest.raises(RuntimeError, match="stopped"):
        t.export_pages_stream([1])


# ---------------------------------------------------------------------------
# entry points


async def test_clear_kv_blocks_route_and_kv_metrics(weights):
    from dynamo_tpu_torch.backend import Backend
    from dynamo_tpu_torch.engines import EchoEngine
    from dynamo_tpu_torch.preprocessor import (
        OpenAIPreprocessor,
        PromptFormatter,
    )
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    eng = TorchEngine(TConfig.tiny(dtype="float32"),
                      TEngineConfig(**KW, kv_quant="int8"),
                      params=params_from_jax(weights[1], device="cpu"),
                      device="cpu")
    tok = make_test_tokenizer()
    manager = ModelManager()
    for name, engine in (("m", eng), ("echo", EchoEngine())):
        manager.register(ModelChain(
            name=name, preprocessor=OpenAIPreprocessor(
                tokenizer=tok, formatter=PromptFormatter(), model_name=name),
            engine=engine, backend=Backend(tok)))
    await _collect(eng, tproto, PROMPTS[0])
    await asyncio.sleep(0.1)
    assert len(eng.allocator._lru) >= 4
    svc = HttpService(manager, host="127.0.0.1", port=0)
    await svc.start()
    try:
        async with HttpClient("127.0.0.1", svc.port) as c:
            r = await c.request("POST", "/clear_kv_blocks")
            assert r.status == 200 and r.json() == {"cleared": ["m"]}
            r = await c.request("GET", "/metrics")
    finally:
        await svc.stop()
        await eng.stop()
    assert len(eng.allocator._lru) == 0
    fams = {f.name: f for f in text_string_to_metric_families(
        r.body.decode())}
    assert fams["dynamo_kv_quant_ctx_seal_raw_pages"].samples[0].value >= 4
    for name in ("dynamo_kv_integrity_verified", "dynamo_kv_quant_pages",
                 "dynamo_kv_integrity_g3_scrub_dropped",
                 "dynamo_kv_pool_capacity_blocks"):
        assert name in fams, name


def test_launcher_offload_flags(tmp_path, monkeypatch):
    for k in list(__import__("os").environ):
        if k.startswith("DYNTPU_"):
            monkeypatch.delenv(k)
    argv = ["in=text", "out=torch", "--model-config", "tiny",
            "--cache-dtype", "float32", "--device", "cpu",
            "--host-offload-pages", "8", "--disk-offload-pages", "4",
            "--disk-offload-path", str(tmp_path / "g3.mmap"),
            "--scrub-on-start"]
    ref = {a.dest: a.default for a in rrun.build_parser()._actions}
    port = {a.dest: a.default for a in prun.build_parser()._actions}
    for dest in ("host_offload_pages", "disk_offload_pages",
                 "disk_offload_path", "scrub_on_start"):
        assert port[dest] == ref[dest], dest
    args = prun.build_parser().parse_intermixed_args(argv)
    prun.refuse_unported(args)
    _, chain = prun.build_chain(args)
    eng = chain.engine
    e = eng.ecfg
    assert (e.host_offload_pages, e.disk_offload_pages, e.disk_offload_path,
            e.scrub_on_start) == (8, 4, str(tmp_path / "g3.mmap"), True)
    assert eng.offload.num_pages == 8 and eng.offload.spill.num_pages == 4
    with pytest.raises(ValueError, match="requires host_offload_pages"):
        prun.build_chain(prun.build_parser().parse_intermixed_args(
            argv[:6] + ["--disk-offload-pages", "4"]))
