"""Disaggregated prefill/decode in the port (dynamo_tpu_torch/disagg.py)
against the JAX package's, on ModelConfig.tiny in f32 with the weights
of the JAX package's init_params (params_from_jax).

A decode worker's long prompt goes to the store's prefill queue; a
prefill worker prefills it and streams its pages over the block-transfer
plane into the decode worker's pages; the decode worker commits them
under their chained hashes and computes only the sub-page tail.

- The config watch, and the config and job JSON equal to the JAX
  package's.
- A remote prefill end to end is greedy token-identical to aggregated
  serving (the port's engine alone and TpuEngine alone), with every
  transferred block matched at admission.
- The fallback: no prefill worker, a counted local fallback after the
  timeout; the late worker drops the expired job; a write for a job no
  longer pending is refused (``guarded_import``).
- The queue-cap decision keeps a prompt local.
- Through the port's distributed stack: a store, launch.run's
  ``serve_worker`` with ``--role decode``, ``serve_prefill_worker`` with
  ``--role prefill`` and a frontend (ModelWatcher + HttpService), over
  HTTP, token-identical to an aggregated stack.
- The chunked stream (``--kv-transfer-chunk-pages 2``, several frames)
  is greedy token-identical to the monolithic path (``0``).
- Across the packages: a port decode worker with a JAX prefill worker,
  and a JAX decode worker with a port prefill worker, each
  token-identical to the JAX package's own disaggregated pair.
- The port's prefill worker runs one prefill at a time and pops the next
  job once a prefill ends, while the last job's pages still stream.

- The request's trace: a chunk-streamed remote prefill's finishing
  output carries ``disagg_kv_transfer`` and the prefill worker's
  ``remote_prefill`` span with a ``kv_chunk`` child a frame, in the shape
  of the JAX package's pair; the stream timeline counts frame sends and
  receives, the eof-ack wait and commit wakeups, and the pieces export
  as a Perfetto timeline.

The JAX package's chaos stall test (item 5) is not mirrored."""
import asyncio
import json
import time

import jax
import numpy as np
import pytest

from dynamo_tpu import disagg as jdisagg
from dynamo_tpu import kv_transfer as jkt
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.runtime.component import DistributedRuntime as JRuntime
from dynamo_tpu_torch import disagg as tdisagg
from dynamo_tpu_torch import kv_transfer as tkt
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.kv_transfer_metrics import KV_TRANSFER
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.store import serve_store
from tests.test_torch_telemetry import span_shape

PS = 16
KW = dict(num_pages=64, page_size=PS, max_pages_per_seq=8,
          max_decode_slots=4, prefill_buckets=(32, 64),
          cache_dtype="float32")
P49 = list(range(1, 50))          # 3 complete blocks + a 1-token tail


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    return jparams, jax.tree.map(np.asarray, jparams)


def port_engine(weights, wid, **over):
    return TorchEngine(TConfig.tiny(dtype="float32"),
                       TEngineConfig(**KW, worker_id=wid, **over),
                       params=params_from_jax(weights[1], device="cpu"),
                       device="cpu")


def ref_engine(weights, wid, **over):
    return TpuEngine(JConfig.tiny(dtype="float32"),
                     JEngineConfig(**KW, worker_id=wid, **over),
                     params=weights[0], mesh_config=MeshConfig(tp=1))


# each side of a pair, by package
SIDES = {
    "port": dict(engine=port_engine, disagg=tdisagg, kt=tkt, proto=tproto,
                 rt=DistributedRuntime),
    "ref": dict(engine=ref_engine, disagg=jdisagg, kt=jkt, proto=jproto,
                rt=JRuntime),
}


def req_for(proto, prompt, n_new=10):
    return proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True))


async def collect(engine, req):
    toks = []
    async for out in engine.generate(req):
        toks.extend(out.token_ids)
    return toks


async def local_tokens(make, weights, prompt, proto, n_new=10):
    eng = make(weights, "local")
    try:
        return await collect(eng, req_for(proto, prompt, n_new))
    finally:
        await eng.stop()


async def start_store():
    server, store = await serve_store("127.0.0.1", 0, sweep_interval_s=0.05)
    return server, server.sockets[0].getsockname()[1]


class Pair:
    """A decode worker (its engine in the disagg wrapper, its pool on the
    transfer plane, its descriptor published) and a prefill worker, each
    of package ``dec`` / ``pre`` ("port" or "ref"), on a store."""

    @classmethod
    async def up(cls, weights, port, dec="port", pre="port", ns="dynamo",
                 timeout_s=30.0, chunk_pages=None, wid="dec", pwid="pre"):
        self = cls()
        d, p = SIDES[dec], SIDES[pre]
        self.d, self.p = d, p
        self.rt_d = await d["rt"].connect(port=port)
        self.rt_p = await p["rt"].connect(port=port)
        self.inner = d["engine"](weights, wid)
        dis = d["disagg"]
        self.conf = await dis.DisaggConfigWatcher(
            self.rt_d.kv, ns, default=dis.DisaggConfig(
                max_local_prefill_length=PS, max_prefill_queue_size=4),
        ).start()
        self.decode = dis.DisaggDecodeEngine(
            self.inner, self.rt_d, namespace=ns, worker_id=wid,
            conf=self.conf, prefill_timeout_s=timeout_s)
        self.srv = d["kt"].BlockTransferServer(
            read_fn=self.inner.export_pages,
            write_fn=self.decode.guarded_import)
        host, xport = await self.srv.start()
        cfg = self.inner.config
        await d["kt"].publish_descriptor(
            self.rt_d.kv, ns, d["kt"].BlocksetDescriptor(
                worker_id=wid, host=host, port=xport,
                layout=d["kt"].KvCacheLayout(
                    cfg.num_layers, cfg.num_kv_heads, PS, cfg.head_dim,
                    "float32")))
        over = ({} if chunk_pages is None
                else {"kv_transfer_chunk_pages": chunk_pages})
        self.pre_eng = p["engine"](weights, pwid, **over)
        self.pworker = await p["disagg"].PrefillWorker(
            self.rt_p, self.pre_eng, namespace=ns, poll_timeout_s=0.2,
        ).start()
        return self

    async def generate(self, prompt, n_new=10):
        return await collect(self.decode,
                             req_for(self.d["proto"], prompt, n_new))

    async def down(self):
        await self.pworker.stop()
        await self.srv.stop()
        await self.conf.stop()
        await self.decode.stop()
        await self.pre_eng.stop()
        await self.rt_p.close()
        await self.rt_d.close()


async def test_disagg_config_watch_and_json():
    server, port = await start_store()
    rt = await DistributedRuntime.connect(port=port)
    try:
        w = await tdisagg.DisaggConfigWatcher(rt.kv, "ns").start()
        assert w.current == tdisagg.DisaggConfig(512, 16)  # the defaults
        await tdisagg.set_disagg_config(rt.kv, "ns", tdisagg.DisaggConfig(
            max_local_prefill_length=99, max_prefill_queue_size=3))
        for _ in range(100):
            if w.current.max_local_prefill_length == 99:
                break
            await asyncio.sleep(0.02)
        assert w.current.max_prefill_queue_size == 3
        # the JAX package's watcher reads the port's put, and the reverse
        jrt = await JRuntime.connect(port=port)
        jw = await jdisagg.DisaggConfigWatcher(jrt.kv, "ns").start()
        assert jw.current == jdisagg.DisaggConfig(99, 3)
        await jdisagg.set_disagg_config(jrt.kv, "ns",
                                        jdisagg.DisaggConfig(7, 2))
        for _ in range(100):
            if w.current.max_local_prefill_length == 7:
                break
            await asyncio.sleep(0.02)
        assert w.current == tdisagg.DisaggConfig(7, 2)
        await jw.stop()
        await w.stop()
        await jrt.close()
        job = dict(request_id="r", token_ids=[1, 2], salt="m",
                   dst_worker_id="w", dst_pages=[3], first_block=0,
                   done_queue="q", expires_at=12.5)
        assert (tdisagg.RemotePrefillRequest(**job).to_json()
                == jdisagg.RemotePrefillRequest(**job).to_json())
        for name in ("disagg_conf_key", "prefill_queue_name"):
            assert getattr(tdisagg, name)("ns") == getattr(jdisagg,
                                                           name)("ns")
        assert (tdisagg.prefill_done_queue("ns", "r")
                == jdisagg.prefill_done_queue("ns", "r"))
    finally:
        await rt.close()
        server.close()


@pytest.mark.asyncio_timeout(180)
async def test_remote_prefill_end_to_end_equals_aggregated(weights):
    ref = await local_tokens(ref_engine, weights, P49, jproto)
    assert await local_tokens(port_engine, weights, P49, tproto) == ref
    server, port = await start_store()
    pair = await Pair.up(weights, port)
    try:
        finishing = None
        out = []
        async for o in pair.decode.generate(req_for(tproto, P49)):
            out.extend(o.token_ids)
            if o.finish_reason is not None:
                finishing = o
        assert out == ref
        assert (pair.decode.remote_prefills, pair.decode.remote_fallbacks,
                pair.pworker.jobs_handled) == (1, 0, 1)
        # every transferred block matched at the engine's admission
        assert pair.decode.last_done["blocks"] == 3
        assert finishing.annotations["cached_blocks"] == 3
        # a short prompt stays local
        assert len(await pair.generate(list(range(1, 10)))) == 10
        assert pair.decode.local_prefills == 1
    finally:
        await pair.down()
        server.close()


@pytest.mark.asyncio_timeout(180)
async def test_fallback_and_stale_job_write_rejected(weights):
    ref = await local_tokens(port_engine, weights, P49, tproto)
    server, port = await start_store()
    rt = await DistributedRuntime.connect(port=port)
    inner = port_engine(weights, "dec2")
    conf = tdisagg.DisaggConfigWatcher(rt.kv, "dynamo", default=(
        tdisagg.DisaggConfig(max_local_prefill_length=PS,
                             max_prefill_queue_size=4)))
    decode = tdisagg.DisaggDecodeEngine(inner, rt, worker_id="dec2",
                                        conf=conf, prefill_timeout_s=0.3)
    srv = tkt.BlockTransferServer(read_fn=inner.export_pages,
                                  write_fn=decode.guarded_import)
    host, xport = await srv.start()
    cfg = inner.config
    await tkt.publish_descriptor(rt.kv, "dynamo", tkt.BlocksetDescriptor(
        "dec2", host, xport, tkt.KvCacheLayout(
            cfg.num_layers, cfg.num_kv_heads, PS, cfg.head_dim, "float32")))
    fallbacks0 = KV_TRANSFER.get("dynamo_disagg_fallback_total")
    pre_eng = None
    pworker = None
    try:
        free0 = inner.allocator.available_pages
        assert await collect(decode, req_for(tproto, P49)) == ref
        assert decode.remote_fallbacks == 1
        assert KV_TRANSFER.get("dynamo_disagg_fallback_total") \
            == fallbacks0 + 1
        # the abandoned job is still on the durable queue
        assert await rt.kv.qlen(tdisagg.prefill_queue_name("dynamo")) == 1
        # a late prefill worker pops the stale job: it is EXPIRED, so it
        # is dropped with no wasted prefill and no done-queue push
        pre_eng = port_engine(weights, "pre2")
        pworker = tdisagg.PrefillWorker(rt, pre_eng, namespace="dynamo",
                                        poll_timeout_s=0.2)
        pworker.expiry_skew_s = 0.0  # one host: no clock skew
        await pworker.start()
        for _ in range(300):
            if (pworker.jobs_expired + pworker.jobs_failed
                    + pworker.jobs_handled) >= 1:
                break
            await asyncio.sleep(0.05)
        assert (pworker.jobs_expired, pworker.jobs_failed,
                pworker.jobs_handled) == (1, 0, 0)
        assert len(await collect(decode, req_for(
            tproto, list(range(200, 220))))) == 10
        # a write for a job no longer pending is refused, before any
        # scatter; the fallback gave every page back
        with pytest.raises(RuntimeError, match="cancelled"):
            decode.guarded_import([1], None, job_id="long-gone")
        data = await asyncio.to_thread(inner.export_pages, [1])
        with pytest.raises(tkt.BlockTransferError, match="cancelled"):
            await tkt.write_remote_pages(host, xport, [1], data,
                                         job_id="stale-job")
        assert inner.allocator.available_pages >= free0
    finally:
        if pworker is not None:
            await pworker.stop()
        if pre_eng is not None:
            await pre_eng.stop()
        await srv.stop()
        await decode.stop()
        await rt.close()
        server.close()


async def test_decision_respects_the_queue_cap(weights):
    server, port = await start_store()
    rt = await DistributedRuntime.connect(port=port)
    q = tdisagg.prefill_queue_name("dynamo")
    await rt.kv.qpush(q, "{}")
    await rt.kv.qpush(q, "{}")
    inner = port_engine(weights, "dec3")
    conf = tdisagg.DisaggConfigWatcher(rt.kv, "dynamo", default=(
        tdisagg.DisaggConfig(max_local_prefill_length=PS,
                             max_prefill_queue_size=2)))
    decode = tdisagg.DisaggDecodeEngine(inner, rt, worker_id="dec3",
                                        conf=conf)
    try:
        assert len(await collect(decode, req_for(tproto, P49))) == 10
        assert (decode.remote_prefills, decode.local_prefills) == (0, 1)
        assert await rt.kv.qlen(q) == 2  # nothing enqueued
        # under the cap, a prompt within max_local_prefill_length is
        # local too
        await rt.kv.qpop(q)
        assert len(await collect(decode, req_for(tproto, P49[:PS]))) == 10
        assert (decode.remote_prefills, decode.local_prefills) == (0, 2)
    finally:
        await decode.stop()
        await rt.close()
        server.close()


@pytest.mark.asyncio_timeout(240)
async def test_disagg_through_the_distributed_stack(weights):
    """Store, launch.run's --role decode worker and --role prefill worker
    and a frontend, over HTTP: the same tokens as an aggregated stack."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher
    from dynamo_tpu_torch.launch import run as launch

    prompt = list(range(3, 52))
    server, port = await start_store()
    params = params_from_jax(weights[1], device="cpu")
    base = ["out=torch", "--model-config", "tiny", "--cache-dtype",
            "float32", "--device", "cpu", "--model-name", "tiny",
            "--page-size", str(PS), "--num-pages", "64",
            "--control-plane", f"127.0.0.1:{port}"]

    def chain_for(role_args):
        args = launch.build_parser().parse_intermixed_args(
            ["in=endpoint"] + base + role_args)
        return args, launch.build_chain(args, params=params)[1]

    async def serve(role_args):
        """A registered worker: (args, chain, served, what to stop)."""
        parts = []
        args, chain = chain_for(role_args)
        rt = await launch.connect_runtime(args)
        served = await launch.serve_worker(args, chain, rt)
        parts += [served.shutdown, chain.engine.stop, rt.close]
        return args, chain, served, parts

    stops = []
    try:
        # the disaggregated stack
        dargs, dchain, dserved, parts = await serve(
            ["--role", "decode", "--max-local-prefill-length", str(PS),
             "--namespace", "dis"])
        stops += parts
        assert dargs.kv_transfer_chunk_pages == 8
        pargs, pchain = chain_for(["--role", "prefill", "--namespace",
                                   "dis"])
        prt = await launch.connect_runtime(pargs)
        pworker = await launch.serve_prefill_worker(pargs, pchain, prt)
        stops += [pworker.stop, pchain.engine.stop, prt.close]
        decode = dserved.engine
        assert isinstance(decode, tdisagg.DisaggDecodeEngine)
        # the descriptor is published under the wrapper's worker id
        desc = await tkt.get_descriptor(prt.kv, "dis", decode.worker_id)
        assert desc is not None and desc.layout.dtype == "float32"

        async def via_frontend(ns):
            frt = await DistributedRuntime.connect(port=port)
            manager = ModelManager()
            watcher = await ModelWatcher(frt, manager, namespace=ns).start()
            svc = HttpService(manager, host="127.0.0.1", port=0)
            await svc.start()
            try:
                for _ in range(200):
                    if "tiny" in manager.list_models():
                        break
                    await asyncio.sleep(0.05)
                async with HttpClient("127.0.0.1", svc.port) as c:
                    r = await c.request(
                        "POST", "/v1/completions", json_body={
                            "model": "tiny", "prompt": prompt,
                            "max_tokens": 10, "temperature": 0,
                            "nvext": {"ignore_eos": True}})
                    assert r.status == 200, r.status
                    return r.json()["choices"][0]["text"]
            finally:
                await svc.stop()
                await watcher.stop()
                await frt.close()

        text_dis = await via_frontend("dis")
        assert (decode.remote_prefills, decode.remote_fallbacks,
                pworker.jobs_handled) == (1, 0, 1)
        # the aggregated stack
        _, _, _, parts = await serve(["--namespace", "agg"])
        stops += parts
        assert await via_frontend("agg") == text_dis
        assert len(text_dis.split()) == 10
    finally:
        for stop in reversed(stops):
            await stop()
        server.close()


@pytest.mark.asyncio_timeout(240)
async def test_chunked_stream_equals_monolithic(weights):
    prompt = list(range(1, 114))      # 7 complete blocks + a tail
    server, port = await start_store()
    streams0 = KV_TRANSFER.get("dynamo_kv_transfer_streams_total")
    chunked = await Pair.up(weights, port, ns="chunked", chunk_pages=2,
                            wid="dec_c", pwid="pre_c")
    mono = await Pair.up(weights, port, ns="mono", chunk_pages=0,
                         wid="dec_m", pwid="pre_m")
    try:
        out_c = await chunked.generate(prompt)
        chunks_113 = chunked.decode.last_transfer_chunks
        out_m = await mono.generate(prompt)
        assert out_c == out_m
        assert chunked.decode.remote_prefills == 1
        assert mono.decode.remote_prefills == 1
        assert chunked.decode.remote_fallbacks == mono.decode.remote_fallbacks \
            == 0
        # the chunked path streamed several frames, the monolithic none
        assert chunked.pworker.chunks_streamed >= 3 and chunks_113 >= 3
        assert chunked.pworker.transfer_overlap_ratio is not None
        assert KV_TRANSFER.get("dynamo_kv_transfer_streams_total") > streams0
        assert mono.pworker.chunks_streamed == 0
        # the commit event woke the stream
        assert chunked.pworker.commit_wakeups > 0
        assert chunked.decode.last_done["blocks"] == 7
    finally:
        await chunked.down()
        await mono.down()
        server.close()


@pytest.fixture(scope="module")
def reference_pair_tokens(weights):
    async def run():
        server, port = await start_store()
        pair = await Pair.up(weights, port, dec="ref", pre="ref",
                             ns="refpair")
        try:
            out = await pair.generate(P49)
            assert pair.decode.remote_prefills == 1
            return out
        finally:
            await pair.down()
            server.close()

    return asyncio.run(run())


@pytest.mark.parametrize("dec,pre", [("port", "port"), ("port", "ref"),
                                     ("ref", "port")])
@pytest.mark.asyncio_timeout(180)
async def test_pairings_across_the_packages(dec, pre, weights,
                                            reference_pair_tokens):
    server, port = await start_store()
    pair = await Pair.up(weights, port, dec=dec, pre=pre, ns=f"{dec}{pre}")
    try:
        assert await pair.generate(P49) == reference_pair_tokens
        assert (pair.decode.remote_prefills,
                pair.decode.remote_fallbacks) == (1, 0)
        assert pair.pworker.jobs_handled == 1
    finally:
        await pair.down()
        server.close()


@pytest.mark.asyncio_timeout(180)
async def test_next_job_prefills_while_the_last_one_streams(weights):
    """The prefill worker runs one prefill at a time (each a group of
    one) and pops the next job once a prefill has ended, while that job's
    pages are still on the wire (slowed here on the decode side)."""
    prompts = [list(range(1, 50)), list(range(60, 109))]
    refs = [await local_tokens(port_engine, weights, p, tproto)
            for p in prompts]
    server, port = await start_store()
    pair = await Pair.up(weights, port, chunk_pages=1)
    live, spans = [0], []
    generate = pair.pre_eng.generate

    async def one_at_a_time(req):
        live[0] += 1
        assert live[0] == 1, "two prefills at once"
        t0 = time.monotonic()
        try:
            async for out in generate(req):
                yield out
        finally:
            live[0] -= 1
            spans.append((t0, time.monotonic()))

    imported = []
    import_pages = pair.inner.import_pages

    def slow_import(pages, data):
        time.sleep(0.2)  # a slow wire: every chunk lands 0.2 s late
        import_pages(pages, data)
        imported.append(time.monotonic())

    pair.pre_eng.generate = one_at_a_time
    pair.inner.import_pages = slow_import
    try:
        outs = await asyncio.gather(*[pair.generate(p) for p in prompts])
        assert outs == refs
        assert pair.decode.remote_prefills == 2
        assert pair.pworker.jobs_handled == 2 and len(spans) == 2
        # the second prefill began before the first job's last chunk
        # landed: its transfer did not hold the queue
        (_, end1), (start2, _) = sorted(spans)
        assert end1 <= start2 < sorted(imported)[2]
    finally:
        await pair.down()
        server.close()


@pytest.mark.asyncio_timeout(240)
async def test_remote_prefill_spans_and_stream_timeline(weights):
    import dynamo_tpu.telemetry.timeline as jtl
    import dynamo_tpu_torch.telemetry.timeline as ttl
    from dynamo_tpu_torch.tools import trace_export

    prompt = list(range(1, 114))      # 7 complete blocks: >= 3 frames
    finishing = {}
    for side, tl in (("port", ttl), ("ref", jtl)):
        tl.STREAM_EVENTS.clear()
        server, port = await start_store()
        pair = await Pair.up(weights, port, dec=side, pre=side,
                             ns=f"spans_{side}", chunk_pages=2,
                             wid=f"dec_{side}", pwid=f"pre_{side}")
        try:
            async for o in pair.decode.generate(req_for(
                    SIDES[side]["proto"], prompt)):
                if o.finish_reason is not None:
                    finishing[side] = o.annotations
            assert pair.decode.remote_prefills == 1
            if side == "port":
                stream = ttl.STREAM_EVENTS.snapshot()
                rounds = [[r[0], r[1], list(r[2])]
                          for r in pair.inner.prof.recent(16)]
                flight = pair.inner.flight.snapshot()
        finally:
            await pair.down()
            server.close()
    pspans = finishing["port"]["trace"]["spans"]
    rspans = finishing["ref"]["trace"]["spans"]
    assert span_shape(pspans[:2]) == span_shape(rspans[:2])
    assert [sp["name"] for sp in pspans[:2]] == ["disagg_kv_transfer",
                                                 "remote_prefill"]
    chunks = pspans[1]["children"]
    assert len(chunks) >= 3 and {c["name"] for c in chunks} == {"kv_chunk"}
    assert sum(c["attrs"]["blocks"] for c in chunks) == \
        pspans[1]["attrs"]["blocks"] == 7
    kinds = [e["kind"] for e in stream]
    assert kinds.count(ttl.FRAME_SEND) == kinds.count(ttl.FRAME_RECV) \
        == len(chunks)
    assert kinds.count(ttl.EOF_ACK_WAIT) == 1
    assert kinds.count(ttl.COMMIT_WAKEUP) >= 1
    chrome = json.loads(json.dumps(trace_export.build({
        "trace": {"trace_id": "req", "spans": pspans}, "flight": flight,
        "stream": stream, "rounds": rounds})))
    names = {e["name"] for e in chrome["traceEvents"]
             if e.get("cat") == "span"}
    assert {"disagg_kv_transfer", "remote_prefill", "kv_chunk"} <= names
    assert any(e.get("cat") == "round_segment" for e in chrome["traceEvents"])
    assert any(e.get("cat") == "kv_stream" for e in chrome["traceEvents"])
    ttl.STREAM_EVENTS.clear()
    jtl.STREAM_EVENTS.clear()
