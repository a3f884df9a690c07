"""KVBM G4 in the port (reference block_manager.rs:69-82 CacheLevel::G4):
a COLD port worker whose G1/G2/G3 tiers miss a prefix fetches the sealed
pages from a PEER worker's pool over the transfer plane
(kv_transfer.RemoteKvFetcher), lands them in its G2 host tier and
onboards them through the normal path.

- The peer is the port's TorchEngine or the JAX package's TpuEngine, in
  dense or int8 KV, over the monolithic hash read or the chunked probe +
  stream: the cold worker is greedy token-identical to the warm worker,
  onboards every matchable block (``remote_onboard_blocks``), and its
  onboarded pages are byte-equal to the peer's; a second request is a
  local hit with no fetch.
- A dead peer and a peer that misses cost one probe timeout at most and a
  recompute, never an error, with the same tokens as an engine without
  G4."""
import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu import kv_transfer as jkt
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.kv_quant import QuantizedPages as JQuantizedPages
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu_torch import kv_transfer as tkt
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.kv_quant import QuantizedPages
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.runtime.client import KvClient
from dynamo_tpu_torch.runtime.store import serve_store
from dynamo_tpu_torch.tokens import compute_block_hashes

PS = 16
KW = dict(num_pages=64, page_size=PS, max_pages_per_seq=8,
          max_decode_slots=2, prefill_buckets=(32, 64),
          cache_dtype="float32", flush_every=2, max_inflight_rounds=1)
PROMPT = list(range(1, PS * 3 + 4))   # 3 full blocks + a tail


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    return jparams, jax.tree.map(np.asarray, jparams)


def port_engine(weights, **kw):
    return TorchEngine(TConfig.tiny(dtype="float32"),
                       TEngineConfig(**KW, **kw),
                       params=params_from_jax(weights[1], device="cpu"),
                       device="cpu")


def ref_engine(weights, **kw):
    return TpuEngine(JConfig.tiny(dtype="float32"),
                     JEngineConfig(**KW, **kw), params=weights[0],
                     mesh_config=MeshConfig(tp=1))


async def collect(eng, proto, prompt, n=6):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(max_tokens=n, ignore_eos=True))
    toks = []
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
    return toks


def raw(x) -> bytes:
    if isinstance(x, (QuantizedPages, JQuantizedPages)):
        return raw(x.data) + raw(x.scales)
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


async def store_and_client():
    server, _ = await serve_store("127.0.0.1", 0, sweep_interval_s=0.1)
    port = server.sockets[0].getsockname()[1]
    return server, await KvClient(port=port).connect()


async def serve_pool(mod, eng, kv, ns, wid):
    """The peer's pool on the transfer plane, its descriptor published."""
    srv = mod.BlockTransferServer(
        read_fn=eng.export_pages,
        read_hashes_fn=eng.export_pages_by_hash,
        count_hashes_fn=eng.allocator.cached_prefix_len,
        read_hashes_stream_fn=eng.export_hash_stream)
    host, port = await srv.start()
    cfg = eng.config
    await tkt.publish_descriptor(kv, ns, tkt.BlocksetDescriptor(
        wid, host, port, tkt.KvCacheLayout(
            cfg.num_layers, cfg.num_kv_heads, PS, cfg.head_dim,
            "int8" if eng.ecfg.kv_quant == "int8" else "float32")))
    return srv


@pytest.mark.parametrize("peer,kv_quant,chunk_pages", [
    ("port", "none", 0), ("port", "none", 2), ("port", "int8", 2),
    ("ref", "none", 2), ("ref", "int8", 0),
])
@pytest.mark.asyncio_timeout(180)
async def test_cold_worker_onboards_a_prefix_from_a_peer_pool(
        peer, kv_quant, chunk_pages, weights):
    server, kv = await store_and_client()
    warm = (port_engine if peer == "port" else ref_engine)(
        weights, kv_quant=kv_quant)
    cold = port_engine(weights, kv_quant=kv_quant, host_offload_pages=16)
    srv = None
    try:
        warm_toks = await collect(warm, tproto if peer == "port" else jproto,
                                  PROMPT)
        srv = await serve_pool(tkt if peer == "port" else jkt, warm, kv,
                               "g4", "warm")
        cold.remote_kv = tkt.RemoteKvFetcher(kv, "g4", "cold",
                                             chunk_pages=chunk_pages)
        assert await collect(cold, tproto, PROMPT) == warm_toks
        assert cold.remote_kv.hits == 1
        assert cold.remote_kv.chunked_fetches == (1 if chunk_pages else 0)
        assert cold.remote_onboard_blocks == 3
        assert cold.offload.onboard_hits >= 3   # onboarded, not recomputed
        # the onboarded pages are the peer's, byte for byte
        hashes = compute_block_hashes(PROMPT, PS)[:3]
        wpages = [warm.allocator.page_for_hash(h) for h in hashes]
        cpages = [cold.allocator.page_for_hash(h) for h in hashes]
        assert raw(await asyncio.to_thread(cold.export_pages, cpages)) == \
            raw(await asyncio.to_thread(warm.export_pages, wpages))
        # again: a local hit, no round trip to the peer
        fetches = cold.remote_kv.fetches
        assert await collect(cold, tproto, PROMPT) == warm_toks
        assert cold.remote_kv.fetches == fetches
    finally:
        if srv is not None:
            await srv.stop()
        await warm.stop()
        await cold.stop()
        await kv.close()
        server.close()


@pytest.mark.parametrize("chunk_pages", [0, 2])
@pytest.mark.asyncio_timeout(120)
async def test_misses_and_dead_peers_cost_one_timeout_and_a_recompute(
        chunk_pages, weights):
    server, kv = await store_and_client()
    prompt = list(range(1, PS * 2 + 3))
    want = None
    plain = port_engine(weights)
    try:
        want = await collect(plain, tproto, prompt)
    finally:
        await plain.stop()
    # a descriptor at a dead port, a listener that never answers, and a
    # live peer that holds nothing
    await tkt.publish_descriptor(kv, "g4m", tkt.BlocksetDescriptor(
        "gone", "127.0.0.1", 1, tkt.KvCacheLayout(1, 1, PS, 4, "float32")))

    async def silent(reader, writer):
        await asyncio.sleep(30)

    mute = await asyncio.start_server(silent, "127.0.0.1", 0)
    await tkt.publish_descriptor(kv, "g4m", tkt.BlocksetDescriptor(
        "mute", "127.0.0.1", mute.sockets[0].getsockname()[1],
        tkt.KvCacheLayout(1, 1, PS, 4, "float32")))
    empty = port_engine(weights)
    srv = await serve_pool(tkt, empty, kv, "g4m", "empty")
    eng = port_engine(weights, host_offload_pages=8)
    eng.remote_kv = tkt.RemoteKvFetcher(kv, "g4m", "me", timeout_s=0.5,
                                        chunk_pages=chunk_pages)
    try:
        t0 = time.monotonic()
        assert await collect(eng, tproto, prompt) == want
        # one probe timeout in all (never one per peer), then a recompute
        assert time.monotonic() - t0 < 0.5 + 3.0
        assert eng.remote_kv.fetches == 1 and eng.remote_kv.hits == 0
        assert eng.remote_onboard_blocks == 0
    finally:
        mute.close()
        await srv.stop()
        await empty.stop()
        await eng.stop()
        await kv.close()
        server.close()
