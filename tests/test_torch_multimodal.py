"""The port's multimodal path against the JAX package's, on
ModelConfig.tiny (f32) with VisionConfig.tiny (16 patches) and the same
weights: TorchEngine behind the port's MultimodalEngine is greedy
token-identical to TpuEngine behind the reference's — an image request,
a placeholder run that straddles a prefill chunk boundary, two images in
one prompt, an image request in a burst beside text requests (it
prefills alone), the same image again as a prefix hit (its rows below
the hit are skipped) and another image with identical placeholder tokens
(no hit: the digest salt) — in dense and int8 KV, with the same salted
block hashes in the KV events. Over the runtime the rows ride array
frames whose server and client interoperate with the reference's in
both directions, tickets one-shot and expiring; and an image content
part is served over HTTP as the reference serves it."""
import asyncio
import base64

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu import kv_transfer as rkvt
from dynamo_tpu import multimodal as rmm
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import vision as jv
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu_torch import kv_transfer as pkvt
from dynamo_tpu_torch import multimodal as pmm
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.models import vision as tv
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto

IMG_TOK = 7
N_NEW = 6
# a 32-token prefill chunk at most: a run placed at 28 straddles it
ENGINE_KW = dict(num_pages=48, page_size=16, max_pages_per_seq=8,
                 max_decode_slots=4, prefill_buckets=(16, 32),
                 cache_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    cfg = JConfig.tiny(dtype="float32")
    vcfg = jv.VisionConfig.tiny(out_hidden_size=cfg.hidden_size)
    jparams = jl.init_params(cfg, 0)
    jvparams = jv.init_vision_params(vcfg, 0)
    return (cfg, vcfg, jparams, jvparams,
            params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
            tv.vision_params_from_jax(jax.tree.map(np.asarray, jvparams),
                                      "cpu"))


def image(seed):
    return np.random.RandomState(seed).rand(16, 16, 3).astype(np.float32)


def mm_request(proto, mod, head, images, tail, n_new=N_NEW):
    """Prompt ``head`` + a placeholder run per image (separated by one
    text token) + ``tail``."""
    toks, ims = list(head), []
    for i, img in enumerate(images):
        if i:
            toks.append(3)
        ims.append(dict(mod.encode_image_payload(img), pos=len(toks)))
        toks += [IMG_TOK] * 16
    toks += list(tail)
    return proto.PreprocessedRequest(
        token_ids=toks,
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True),
        multimodal={"images": ims})


def text_request(proto, toks, n_new=N_NEW):
    return proto.PreprocessedRequest(
        token_ids=list(toks),
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True))


async def collect(engine, req):
    toks = []
    async for out in engine.generate(req):
        toks.extend(out.token_ids)
    return toks


async def drive(eng, inner, proto, mod):
    """Every scenario on one engine, in order; returns the streams and
    the prefix-cache hits each scenario added."""
    out, hits = {}, {}

    def mark(name, before):
        hits[name] = inner.allocator.hit_blocks - before

    h = inner.allocator.hit_blocks
    out["image"] = await collect(eng, mm_request(
        proto, mod, [1, 2, 3, 4], [image(0)], [5, 6, 8]))
    mark("image", h)
    h = inner.allocator.hit_blocks
    out["straddle"] = await collect(eng, mm_request(
        proto, mod, list(range(20, 48)), [image(1)], [9, 10, 11, 12, 13]))
    mark("straddle", h)
    h = inner.allocator.hit_blocks
    out["two images"] = await collect(eng, mm_request(
        proto, mod, [1, 2], [image(2), image(3)], [4, 5]))
    mark("two images", h)
    h = inner.allocator.hit_blocks
    burst = await asyncio.gather(
        collect(eng, text_request(proto, range(60, 80))),
        collect(eng, mm_request(proto, mod, [11, 12], [image(4)], [13])),
        collect(eng, text_request(proto, range(90, 110))),
        collect(eng, text_request(proto, range(120, 131))))
    out["burst"] = burst
    mark("burst", h)
    h = inner.allocator.hit_blocks
    out["repeat"] = await collect(eng, mm_request(
        proto, mod, [1, 2, 3, 4], [image(0)], [5, 6, 8]))
    mark("repeat", h)
    h = inner.allocator.hit_blocks
    out["other image"] = await collect(eng, mm_request(
        proto, mod, [1, 2, 3, 4], [image(5)], [5, 6, 8]))
    mark("other image", h)
    await eng.stop()
    return out, hits


def _stored(events):
    return [[b.block_hash for b in ev.blocks] for ev in events
            if ev.kind.value == "stored"]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_multimodal_engine_matches_reference(weights, kv_quant):
    cfg, vcfg, jparams, jvparams, tparams, tvparams = weights
    jev, tev = [], []
    jinner = TpuEngine(cfg, JEngineConfig(kv_quant=kv_quant, **ENGINE_KW),
                       params=jparams, mesh_config=MeshConfig(tp=1),
                       on_kv_event=jev.append)
    jeng = rmm.MultimodalEngine(
        jinner, local_encoder=rmm.EncodeWorker(None, vcfg, jvparams))
    want, want_hits = asyncio.run(drive(jeng, jinner, jproto, rmm))
    tinner = TorchEngine(TConfig.tiny(dtype="float32"),
                         TEngineConfig(kv_quant=kv_quant, **ENGINE_KW),
                         params=tparams, device="cpu",
                         on_kv_event=tev.append)
    teng = pmm.MultimodalEngine(
        tinner, local_encoder=pmm.EncodeWorker(None, vcfg, tvparams))
    got, got_hits = asyncio.run(drive(teng, tinner, tproto, pmm))
    assert got == want
    assert got_hits == want_hits
    assert all(len(t) == N_NEW for t in got["burst"])
    # the same image again hits its first block (rows below the hit are
    # skipped); another image with the same placeholder tokens does not
    assert got_hits["repeat"] == 1 and got_hits["other image"] == 0
    # the burst's text requests batch
    assert tinner.dispatch_counts["prefill_batch"] >= 1
    assert teng.images_resolved == 7
    # salted hashes: the stored blocks are the reference's
    assert _stored(tev) == _stored(jev)


def _gate(eng, n):
    """Hold the engine's intake until ``n`` requests wait in it, so a
    burst is admitted in one round whatever the arrival timing."""
    drain, state = eng._drain_intake, {"open": False}

    def gated():
        if not state["open"]:
            if eng._intake.qsize() < n:
                return
            state["open"] = True
        drain()

    eng._drain_intake = gated


def test_image_request_prefills_alone_in_a_gated_burst(weights):
    """An image request admitted in one round with text requests of the
    same chunk width is never batched with them (the batched program
    carries no image rows): it prefills alone, the texts as one group,
    and its stream equals the one it gets served alone."""
    cfg, vcfg, _, _, tparams, tvparams = weights
    enc = pmm.EncodeWorker(None, vcfg, tvparams)
    req = mm_request(tproto, pmm, [11, 12], [image(4)], [13])
    rows = asyncio.run(enc.encode_arrays(req.multimodal["images"]))
    req.multimodal = {
        "embeddings": [{"pos": im["pos"], "data": r} for im, r in
                       zip(req.multimodal["images"], rows)],
        "digest": pmm.images_digest(req.multimodal["images"])}
    texts = [text_request(tproto, range(60, 80)),
             text_request(tproto, range(90, 110))]

    def engine():
        return TorchEngine(TConfig.tiny(dtype="float32"),
                           TEngineConfig(**ENGINE_KW), params=tparams,
                           device="cpu")

    alone_eng = engine()
    alone = asyncio.run(collect(alone_eng, req))
    asyncio.run(alone_eng.stop())
    eng = engine()
    _gate(eng, 3)

    async def burst():
        return await asyncio.gather(collect(eng, texts[0]),
                                    collect(eng, req),
                                    collect(eng, texts[1]))

    got = asyncio.run(burst())
    asyncio.run(eng.stop())
    assert got[1] == alone
    dc = eng.dispatch_counts
    # the first text alone (the image request ends its group), the image
    # request alone, then the second text
    assert dc["prefill"] == 3 and dc["prefill_batch"] == 0
    # without the image rows the same tokens give another stream
    plain_eng = engine()
    plain = asyncio.run(collect(plain_eng, text_request(
        tproto, req.token_ids)))
    asyncio.run(plain_eng.stop())
    assert plain != alone


def test_salted_block_hashes_match_reference():
    from dynamo_tpu.tokens import TokenBlockSequence as RSeq
    from dynamo_tpu_torch.tokens import TokenBlockSequence as PSeq

    imgs = [dict(pmm.encode_image_payload(image(0)), pos=4)]
    digest = pmm.images_digest(imgs)
    assert digest == rmm.images_digest(imgs)
    toks = [1, 2, 3, 4] + [IMG_TOK] * 40 + [5]
    salted = PSeq.from_tokens(toks, 16, salt=f"m|mm:{digest}")
    assert salted.block_hashes() == RSeq.from_tokens(
        toks, 16, salt=f"m|mm:{digest}").block_hashes()
    assert salted.block_hashes() != PSeq.from_tokens(
        toks, 16, salt="m").block_hashes()
    other = pmm.images_digest([pmm.encode_image_payload(image(1))])
    assert other != digest


def test_image_payloads_match_reference():
    img = image(3)
    p = pmm.encode_image_payload(img)
    assert p == rmm.encode_image_payload(img)
    np.testing.assert_array_equal(pmm.decode_image_payload(p), img)
    np.testing.assert_array_equal(rmm.decode_image_payload(p), img)


def test_multimodal_request_is_not_mutated(weights):
    """The engine gets a resolved copy; the caller's request keeps its
    raw images (a retry re-dispatches it as it was)."""
    cfg, vcfg, _, _, tparams, tvparams = weights
    inner = TorchEngine(TConfig.tiny(dtype="float32"),
                        TEngineConfig(**ENGINE_KW), params=tparams,
                        device="cpu")
    eng = pmm.MultimodalEngine(
        inner, local_encoder=pmm.EncodeWorker(None, vcfg, tvparams))
    req = mm_request(tproto, pmm, [1, 2], [image(0)], [3])
    before = dict(req.multimodal)
    first = asyncio.run(collect(eng, req))
    again = asyncio.run(collect(eng, req))
    asyncio.run(eng.stop())
    assert req.multimodal == before and "embeddings" not in req.multimodal
    assert first == again


# ---------------------------------------------------------------------------
# array frames


async def _frames_roundtrip(server_mod, client_mod):
    srv = server_mod.ArrayFrameServer(host="127.0.0.1")
    await srv.start()
    try:
        a = np.random.RandomState(0).randn(16, 64).astype(np.float32)
        b = np.arange(12, dtype=np.int32).reshape(3, 4)
        if server_mod is pkvt:
            a_park, b_park = torch.from_numpy(a), torch.from_numpy(b)
        else:
            a_park, b_park = a, b
        ta = srv.park(a_park)
        tb = srv.park(b_park)
        got_b = await client_mod.take_remote_array(srv.host, srv.port, tb)
        got_a = await client_mod.take_remote_array(srv.host, srv.port, ta)
        errors = []
        for t in (ta, "t999"):   # one-shot: a second take fails
            try:
                await client_mod.take_remote_array(srv.host, srv.port, t)
            except client_mod.BlockTransferError as e:
                errors.append(str(e))
        return a, b, got_a, got_b, errors
    finally:
        await srv.stop()


def _np(x):
    return x.numpy() if torch.is_tensor(x) else x


@pytest.mark.parametrize("server,client", [
    ("port", "port"), ("port", "ref"), ("ref", "port")])
async def test_array_frames_interoperate(server, client):
    mods = {"port": pkvt, "ref": rkvt}
    a, b, got_a, got_b, errors = await _frames_roundtrip(mods[server],
                                                         mods[client])
    np.testing.assert_array_equal(_np(got_a), a)
    np.testing.assert_array_equal(_np(got_b), b)
    assert _np(got_a).dtype == np.float32 and _np(got_b).dtype == np.int32
    if client == "port":
        assert torch.is_tensor(got_a)
    assert errors == ["unknown or expired ticket"] * 2


async def test_array_frames_expire_and_advertise():
    srv = pkvt.ArrayFrameServer(ttl_s=0.0)
    assert srv.host == "127.0.0.1" and srv.bind_host == "0.0.0.0"
    assert pkvt.ArrayFrameServer(
        advertise_host="10.0.0.7").host == "10.0.0.7"
    await srv.start()
    try:
        old = srv.park(torch.ones(2, 2, dtype=torch.bfloat16))
        await asyncio.sleep(0.01)
        new = srv.park(torch.full((2, 2), 3.0, dtype=torch.bfloat16))
        assert old not in srv._parked   # swept by the next park
        got = await pkvt.take_remote_array(srv.host, srv.port, new)
        assert got.dtype == torch.bfloat16 and got.eq(3.0).all()
        with pytest.raises(pkvt.BlockTransferError):
            await pkvt.take_remote_array(srv.host, srv.port, old)
    finally:
        await srv.stop()


# ---------------------------------------------------------------------------
# over the runtime


@pytest.mark.parametrize("encoder", ["port", "ref"])
async def test_multimodal_over_runtime_matches_in_process(weights, encoder):
    """The port's MultimodalEngine resolves images over the port's store
    through the port's (or the reference's) EncodeWorker, rows as array
    frames: token-identical to the in-process encoder."""
    from dynamo_tpu.runtime.component import DistributedRuntime as RRuntime
    from dynamo_tpu_torch.runtime.component import (
        DistributedRuntime as PRuntime,
    )
    from dynamo_tpu_torch.runtime.store import serve_store

    cfg, vcfg, _, jvparams, tparams, tvparams = weights
    req = mm_request(tproto, pmm, [1, 2, 3, 4], [image(0)], [5, 6, 8])
    inner = TorchEngine(TConfig.tiny(dtype="float32"),
                        TEngineConfig(**ENGINE_KW), params=tparams,
                        device="cpu")
    local = pmm.MultimodalEngine(
        inner, local_encoder=pmm.EncodeWorker(None, vcfg, tvparams))
    want = await collect(local, req)
    await local.stop()

    server, _ = await serve_store(port=0, sweep_interval_s=0.05)
    port = server.sockets[0].getsockname()[1]
    rt_enc = await (PRuntime if encoder == "port" else RRuntime).connect(
        port=port)
    rt_dec = await PRuntime.connect(port=port)
    enc = (pmm.EncodeWorker(rt_enc, vcfg, tvparams, namespace="mm")
           if encoder == "port"
           else rmm.EncodeWorker(rt_enc, vcfg, jvparams, namespace="mm"))
    await enc.start()
    inner = TorchEngine(TConfig.tiny(dtype="float32"),
                        TEngineConfig(**ENGINE_KW), params=tparams,
                        device="cpu")
    eng = pmm.MultimodalEngine(inner, rt=rt_dec, namespace="mm")
    try:
        got = await collect(eng, req)
        assert got == want
        assert enc.images_encoded == 1 and eng.images_resolved == 1
        # the reply carries tickets, not float lists
        client = await rt_dec.namespace("mm").component(
            "encoder").endpoint("encode").client()
        async for item in client.generate({"images": [
                pmm.encode_image_payload(image(1))]}):
            ents = item["embeddings"]
        assert all("ticket" in e and "data" not in e for e in ents)
        rows = await pkvt.take_remote_array(ents[0]["host"], ents[0]["port"],
                                            ents[0]["ticket"])
        assert tuple(rows.shape) == (16, cfg.hidden_size)
    finally:
        await eng.stop()
        await enc.stop()
        await rt_dec.close()
        await rt_enc.close()
        server.close()


# ---------------------------------------------------------------------------
# HTTP image lowering


async def test_http_image_part_matches_reference(weights):
    """A chat message with image parts is lowered to placeholder runs and
    payloads by the preprocessor, resolved by the MultimodalEngine and
    served: the same body as the reference's; a non-data image URL is
    refused alike."""
    from dynamo_tpu.backend import Backend as RBackend
    from dynamo_tpu.frontend import ModelChain as RChain
    from dynamo_tpu.frontend import ModelManager as RManager
    from dynamo_tpu.preprocessor import OpenAIPreprocessor as RPre
    from dynamo_tpu.preprocessor import PromptFormatter as RFormatter
    from dynamo_tpu.tokenizer import make_test_tokenizer as r_tokenizer
    from dynamo_tpu_torch.backend import Backend as PBackend
    from dynamo_tpu_torch.frontend.model_manager import ModelChain as PChain
    from dynamo_tpu_torch.frontend.model_manager import (
        ModelManager as PManager,
    )
    from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor as PPre
    from dynamo_tpu_torch.preprocessor import PromptFormatter as PFormatter
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer as p_tokenizer
    from tests.test_torch_frontend import _Port, _Ref, _strip

    cfg, vcfg, jparams, jvparams, tparams, tvparams = weights
    words = [f"w{i}" for i in range(60)]
    raw = image(6)
    b64 = base64.b64encode(raw.tobytes()).decode()
    bodies = [
        {"model": "mm", "max_tokens": 5, "messages": [
            {"role": "user", "content": [
                {"type": "text", "text": "w1 w2 "},
                {"type": "image_data", "data": b64, "shape": [16, 16, 3]},
                {"type": "text", "text": " w3"}]}]},
        {"model": "mm", "max_tokens": 4, "messages": [
            {"role": "user", "content": [
                {"type": "image_url",
                 "image_url": {"url": f"data:,{b64}#16x16x3"}},
                {"type": "text", "text": "w9"}]}]},
        {"model": "mm", "max_tokens": 2, "messages": [
            {"role": "user", "content": [
                {"type": "image_url",
                 "image_url": {"url": "https://example.com/x.png"}}]}]},
    ]
    out = []
    for port in (True, False):
        tok = (p_tokenizer if port else r_tokenizer)(words)
        fmt = (PFormatter if port else RFormatter)(
            template="{% for m in messages %}{{ m.content }}{% endfor %}")
        if port:
            inner = TorchEngine(TConfig.tiny(dtype="float32"),
                                TEngineConfig(**ENGINE_KW), params=tparams,
                                device="cpu")
            eng = pmm.MultimodalEngine(
                inner, local_encoder=pmm.EncodeWorker(None, vcfg, tvparams))
        else:
            inner = TpuEngine(cfg, JEngineConfig(**ENGINE_KW),
                              params=jparams, mesh_config=MeshConfig(tp=1))
            eng = rmm.MultimodalEngine(
                inner, local_encoder=rmm.EncodeWorker(None, vcfg, jvparams))
        chain = (PChain if port else RChain)(
            name="mm",
            preprocessor=(PPre if port else RPre)(
                tokenizer=tok, formatter=fmt, model_name="mm",
                image_token_id=IMG_TOK, image_token_count=vcfg.num_patches),
            engine=eng, backend=(PBackend if port else RBackend)(tok))
        manager = (PManager if port else RManager)()
        manager.register(chain)
        res = []
        async with (_Port if port else _Ref)(manager) as s:
            for body in bodies:
                status, _, data = await s.call(
                    "POST", "/v1/chat/completions", body)
                res.append((status, _strip(data)))
        res.append(eng.images_resolved)
        await eng.stop()
        out.append(res)
    assert out[0] == out[1]
    assert [s for s, _ in out[0][:3]] == [200, 200, 400]
    assert out[0][3] == 2
    assert out[0][0][1]["usage"]["prompt_tokens"] >= vcfg.num_patches + 3
