"""The port's G2/G3 offload tiers (dynamo_tpu_torch/engine/offload.py) and
TorchEngine's offload path against the JAX package's.

Tiers: one sequence of puts, lookups and drops drives the port's tier and
the JAX tier, which must end with equal index order (hash, slot, parent,
crc) and equal gathered bytes: LRU, a gap, the G2 -> G3 spill with runs
across both tiers, persistence, temporary-file cleanup, in f32, bf16 and
int8 with scales. A G3 file and manifest written by either package
attach in the other and gather the same bytes.

Engine: under HBM pressure a prefix's blocks survive in G2 (and G3) and
a re-sent prompt onboards them instead of recomputing; TorchEngine on the
CPU is token-identical to TpuEngine with equal onboard hits, kv_stats,
integrity counters and tier contents, dense and int8 KV, G2 alone and G2
with G3."""
import asyncio
import time
from dataclasses import asdict

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.offload import DiskOffloadTier as JDisk
from dynamo_tpu.engine.offload import HostOffloadTier as JHost
from dynamo_tpu.kv_integrity import KV_INTEGRITY as J_INTEGRITY
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.tokens import TokenBlockSequence
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.offload import DiskOffloadTier, HostOffloadTier
from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto

PS = 16
SHAPE = (2, 2, 1, PS, 4)  # (2, L, kvh, ps, hd)
SCALES = (2, 2)
# name -> (numpy dtype, torch dtype, scale shape)
KINDS = {"float32": (np.float32, torch.float32, ()),
         "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, ()),
         "int8": (np.int8, torch.int8, SCALES)}


def to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def raw(x) -> bytes:
    """The C-order bytes of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _batch(kind, n, seed):
    np_dt, _, scale_shape = KINDS[kind]
    rng = np.random.default_rng(seed)
    shape = SHAPE[:3] + (n,) + SHAPE[3:]
    if np_dt == np.int8:
        data = rng.integers(-127, 128, size=shape).astype(np.int8)
        scales = rng.uniform(0.01, 1.0, size=scale_shape + (n,)).astype(
            np.float32)
        return data, scales
    return rng.standard_normal(shape).astype(np_dt), None


class Pair:
    """A JAX tier and the port's, driven by one sequence of operations."""

    def __init__(self, kind, host_pages, disk_pages=0, tmp=None):
        np_dt, t_dt, sc = KINDS[kind]
        self.kind = kind
        self.jdisk = self.disk = None
        if disk_pages:
            self.jdisk = JDisk(disk_pages, SHAPE, np_dt, scale_shape=sc,
                               path=str(tmp / "j3.mmap") if tmp else None)
            self.disk = DiskOffloadTier(
                disk_pages, SHAPE, t_dt, scale_shape=sc,
                path=str(tmp / "t3.mmap") if tmp else None)
        self.j = JHost(host_pages, SHAPE, np_dt, spill=self.jdisk,
                       scale_shape=sc)
        self.t = HostOffloadTier(host_pages, SHAPE, t_dt, spill=self.disk,
                                 scale_shape=sc)
        self._seed = 0

    def put(self, hashes, parents):
        self._seed += 1
        data, scales = _batch(self.kind, len(hashes), self._seed)
        a = self.j.put_batch(hashes, parents, data, scales)
        b = self.t.put_batch(
            hashes, parents, to_torch(data),
            to_torch(scales) if scales is not None else None)
        assert a == b
        return a

    def lookup(self, hashes):
        a = self.j.lookup_run(hashes)
        assert self.t.lookup_run(hashes) == a
        return a

    def drop(self, h):
        self.j.drop_everywhere(h)
        self.t.drop_everywhere(h)

    def check(self):
        """Equal index order, slots, parents and crcs in every tier, and
        equal gathered bytes (pages and scales) of every held block."""
        tiers = [(self.j, self.t)] + (
            [(self.jdisk, self.disk)] if self.disk is not None else [])
        for jt, tt in tiers:
            assert list(tt._index.items()) == list(jt._index.items())
            assert tt.onboard_hits == jt.onboard_hits
            assert tt.lookups == jt.lookups
        held = list(self.j._index) + (
            list(self.jdisk._index) if self.jdisk is not None else [])
        if held:
            assert raw(self.t.gather(held)) == raw(self.j.gather(held))
            if KINDS[self.kind][2]:
                assert raw(self.t.gather_scales(held)) == raw(
                    self.j.gather_scales(held))
            assert self.t.verify_pages(
                held, self.t.gather(held), self.t.gather_scales(held)) == []
        return held

    def close(self):
        for d in (self.jdisk, self.disk):
            if d is not None:
                d.close()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tier_put_lookup_lru_as_jax(kind):
    p = Pair(kind, 3)
    assert p.put([11, 12], [0, 11]) == 2
    assert 11 in p.t and 12 in p.t
    assert p.lookup([11, 12, 13]) == [(11, 0), (12, 11)]
    p.check()
    p.put([13], [12])
    p.put([14], [13])  # capacity 3: evicts the LRU-oldest (11)
    assert 11 not in p.t and len(p.t) == 3
    # a duplicate put refreshes, does not duplicate
    assert p.put([13], [12]) == 0
    assert len(p.t) == 3
    p.check()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tier_lookup_stops_at_gap_as_jax(kind):
    p = Pair(kind, 4)
    p.put([1], [0])
    p.put([3], [2])
    assert p.lookup([1, 2, 3]) == [(1, 0)]
    assert p.lookup([2, 3]) == []
    p.drop(1)
    assert p.lookup([1]) == []
    p.check()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_g2_eviction_spills_to_disk_and_run_spans_tiers_as_jax(
        tmp_path, kind):
    p = Pair(kind, 2, disk_pages=4, tmp=tmp_path)
    p.put([1], [0])
    p.put([2], [1])
    # capacity 2: inserting 3 evicts hash 1 into G3, not lost
    p.put([3], [2])
    assert 1 not in p.t._index and 1 in p.disk
    # a run assembles across both tiers: 1 (disk), 2, 3 (memory)
    assert p.lookup([1, 2, 3, 99]) == [(1, 0), (2, 1), (3, 2)]
    p.put([4, 5, 6], [3, 4, 5])   # more spill, G3 LRU order
    p.lookup([4, 5])
    p.drop(2)
    assert p.check()
    assert p.t.clear() == p.j.clear() == 5
    assert len(p.t) == 0 and len(p.disk) == 0
    p.close()


def test_disk_tier_lru_and_persistence_within_session(tmp_path):
    disk = DiskOffloadTier(2, SHAPE, torch.float32,
                           path=str(tmp_path / "g3.mmap"))
    a, b, c = (torch.full(SHAPE, v) for v in (7.0, 8.0, 9.0))
    disk.put_one(10, 0, a)
    disk.put_one(11, 10, b)
    disk.put_one(12, 11, c)  # evicts 10 (capacity 2)
    assert 10 not in disk and 11 in disk and 12 in disk
    assert torch.equal(disk.read_page(12), c)
    disk.close()


def test_disk_tier_tempfile_cleanup():
    import os

    disk = DiskOffloadTier(1, SHAPE, torch.float32)
    disk.put_one(5, 0, torch.zeros(SHAPE))
    path = disk.path
    assert path is not None and os.path.exists(path)
    # a temporary tier journals nothing
    assert not os.path.exists(path + ".manifest")
    disk.close()
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# G3 across packages: the file and its manifest attach in the other one


def _corpus(kind, n, seed):
    data, scales = _batch(kind, n, seed)
    return list(range(100, 100 + n)), [0] + list(range(100, 99 + n)), \
        data, scales


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_g3_written_by_jax_attaches_in_port(tmp_path, kind):
    np_dt, t_dt, sc = KINDS[kind]
    path = str(tmp_path / "g3.mmap")
    hashes, parents, data, scales = _corpus(kind, 5, 1)
    jd = JDisk(6, SHAPE, np_dt, path=path, scale_shape=sc)
    jd.put_batch(hashes, parents, data, scales)
    jd.drop(hashes[2])
    want = list(jd._index.items())
    jd.close()
    td = DiskOffloadTier(6, SHAPE, t_dt, path=path, scale_shape=sc,
                         scrub_on_start=True)
    assert td.scrub_recovered == 4 and td.scrub_dropped == 0
    assert list(td._index.items()) == want
    held = [h for h, _ in want]
    keep = [i for i, h in enumerate(hashes) if h in held]
    assert raw(td.gather(held)) == raw(data[:, :, :, keep])
    if sc:
        assert raw(td.gather_scales(held)) == raw(scales[..., keep])
    td.close()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_g3_written_by_port_attaches_in_jax(tmp_path, kind):
    np_dt, t_dt, sc = KINDS[kind]
    path = str(tmp_path / "g3.mmap")
    hashes, parents, data, scales = _corpus(kind, 5, 2)
    td = DiskOffloadTier(6, SHAPE, t_dt, path=path, scale_shape=sc)
    td.put_batch(hashes, parents, to_torch(data),
                 to_torch(scales) if scales is not None else None)
    td.drop(hashes[0])
    td.put_one(hashes[0], parents[0], to_torch(data[:, :, :, 0]),
               to_torch(scales[..., 0]) if scales is not None else None)
    want = list(td._index.items())
    td.close()
    jd = JDisk(6, SHAPE, np_dt, path=path, scale_shape=sc,
               scrub_on_start=True)
    assert jd.scrub_recovered == 5 and jd.scrub_dropped == 0
    assert list(jd._index.items()) == want
    held = [h for h, _ in want]
    order = [hashes.index(h) for h in held]
    assert raw(jd.gather(held)) == raw(data[:, :, :, order])
    if sc:
        assert raw(jd.gather_scales(held)) == raw(scales[..., order])
    jd.close()


# ---------------------------------------------------------------------------
# engine: evict -> onboard, TorchEngine beside TpuEngine

KW = dict(num_pages=13, page_size=PS, max_pages_per_seq=8,
          max_decode_slots=2, prefill_buckets=(32, 64),
          cache_dtype="float32", host_offload_pages=16, offload_batch=8)
PROMPT_A = list(range(1, 50))   # 3 complete blocks + a tail
PRESSURE = [list(range(b, b + 49)) for b in (60, 110, 160, 200)]


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    return jparams, jax.tree.map(np.asarray, jparams)


async def _collect(eng, proto, prompt, n_new=6):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True))
    toks, ann = [], {}
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
        if out.finish_reason is not None:
            ann = out.annotations
    return toks, ann.get("cached_blocks")


def _quiet(eng):
    """(no slot held and no offload queued, in flight or being put, pages
    put into the tiers so far). The port counts its pending offloads
    (``offloads_pending``: its puts run on their own thread); the JAX
    engine's are its queue and its in-flight entries."""
    spill = eng.offload.spill
    if isinstance(eng, TorchEngine):
        idle = eng.offloads_pending() == 0
    else:
        idle = not eng._offload_cands and not any(
            en.kind == "offload" for en in eng._entries)
    return (idle and all(r is None for r in eng._slots),
            eng.offload.pages_offloaded
            + (spill.pages_offloaded if spill is not None else 0))


async def _settle(eng):
    """Wait until the engine is quiet twice 0.1 s apart with no page put
    in between (a candidate batch being gathered has left the queue but
    is not yet in flight), so the tiers' contents do not depend on the
    loop's timing."""
    for _ in range(200):
        first = _quiet(eng)
        await asyncio.sleep(0.1)
        if first[0] and _quiet(eng) == first:
            return
    raise AssertionError("the engine did not settle")


async def _evict_onboard(eng, proto, registry):
    """PROMPT_A, pressure on the 12-page pool, then PROMPT_A again, each
    request after the tiers settled; the run's observables."""
    out = [await _collect(eng, proto, PROMPT_A)]
    await _settle(eng)
    for p in PRESSURE:
        out.append(await _collect(eng, proto, p))
        await _settle(eng)
    hashes = TokenBlockSequence.from_tokens(
        PROMPT_A, PS, salt="").block_hashes()[:3]
    assert eng.allocator.cached_prefix_len(hashes) == 0, \
        "test premise: A's blocks must be evicted from HBM"
    spill = eng.offload.spill
    in_disk = sum(h in spill for h in hashes) if spill is not None else 0
    before = registry.snapshot()
    hits0 = eng.offload.onboard_hits
    out.append(await _collect(eng, proto, PROMPT_A))
    after = registry.snapshot()
    await _settle(eng)
    res = dict(
        out=out, in_disk=in_disk,
        onboard_hits=eng.offload.onboard_hits - hits0,
        integrity={k: after[k] - before[k] for k in after},
        kv_stats=asdict(eng.metrics().kv_stats),
        g2=list(eng.offload._index),
        g3=list(spill._index) if spill is not None else [])
    cleared = await asyncio.to_thread(eng.clear_kv_blocks)
    res["cleared"] = cleared
    res["after_clear"] = (len(eng.offload),
                          len(spill) if spill is not None else 0)
    await eng.stop()
    return res


CASES = {
    "g2-dense": dict(kv_quant="none"),
    "g2-int8": dict(kv_quant="int8"),
    "g3-dense": dict(kv_quant="none", host_offload_pages=2,
                     disk_offload_pages=16),
    "g3-int8": dict(kv_quant="int8", host_offload_pages=2,
                    disk_offload_pages=16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evict_onboard_identical_to_tpu_engine(weights, tmp_path, case):
    kw = dict(CASES[case])
    g3 = "disk_offload_pages" in kw

    def cfg(tag):
        extra = dict(disk_offload_path=str(tmp_path / f"{tag}.mmap")) \
            if g3 else {}
        return {**KW, **kw, **extra}

    jeng = TpuEngine(JConfig.tiny(dtype="float32"),
                     JEngineConfig(**cfg("j")), params=weights[0],
                     mesh_config=MeshConfig(tp=1))
    teng = TorchEngine(TConfig.tiny(dtype="float32"),
                       TEngineConfig(**cfg("t")),
                       params=params_from_jax(weights[1], device="cpu"),
                       device="cpu")
    j = asyncio.run(_evict_onboard(jeng, jproto, J_INTEGRITY))
    t = asyncio.run(_evict_onboard(teng, tproto, KV_INTEGRITY))
    # the port annotates the matched blocks (cached_blocks), the
    # reference does not: the tokens are compared, then the rest
    t_out, j_out = t.pop("out"), j.pop("out")
    assert [x for x, _ in t_out] == [x for x, _ in j_out]
    assert t == j
    # the re-sent prompt matched its 3 blocks from the tiers, identical
    # to its first run (the blocks were onboarded, not recomputed)
    assert t_out[-1] == (t_out[0][0], 3)
    assert t["onboard_hits"] >= 3
    assert t["integrity"]["dynamo_kv_integrity_recomputed_total"] == 0
    assert t["integrity"]["dynamo_kv_integrity_verified_total"] >= 3
    ks = t["kv_stats"]
    if g3:
        assert t["in_disk"] >= 1, "premise: G2 pressure spills A to G3"
        assert ks["disk_total_blocks"] == 16 and ks["disk_blocks"] >= 1
    else:
        assert ks["host_total_blocks"] == 16 and ks["host_blocks"] >= 3
    assert t["cleared"] >= 3 and t["after_clear"] == (0, 0)


def test_offload_disabled_by_default(weights):
    eng = TorchEngine(TConfig.tiny(dtype="float32"),
                      TEngineConfig(**{**KW, "host_offload_pages": 0}),
                      params=params_from_jax(weights[1], device="cpu"),
                      device="cpu")
    assert eng.offload is None and eng.allocator.on_park is None
    toks, _ = asyncio.run(_collect(eng, tproto, list(range(1, 40))))
    assert len(toks) == 6
    m = eng.metrics()
    assert m.kv_stats.host_total_blocks == 0
    assert m.worker_stats.request_total_slots == 2
    assert eng.transfer_stats()["offload_pages"] == 0
    asyncio.run(eng.stop())


def test_engine_requires_g2_for_g3():
    with pytest.raises(ValueError, match="requires host_offload_pages"):
        TEngineConfig(**{**KW, "host_offload_pages": 0,
                         "disk_offload_pages": 4})
    # the reference's knobs and defaults
    ref, port = JEngineConfig(), TEngineConfig()
    for k in ("host_offload_pages", "disk_offload_pages",
              "disk_offload_path", "scrub_on_start", "offload_batch",
              "kv_transfer_chunk_pages", "kv_transfer_inflight_chunks",
              "xfer_op_timeout_s", "kv_transfer_stream_idle_timeout_s"):
        assert getattr(port, k) == getattr(ref, k), k


def test_metrics_round_trip_as_the_reference_wire_form(weights):
    from dynamo_tpu.kv_router.protocols import (
        ForwardPassMetrics as JForwardPassMetrics,
    )
    from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics

    eng = TorchEngine(TConfig.tiny(dtype="float32"), TEngineConfig(**KW),
                      params=params_from_jax(weights[1], device="cpu"),
                      device="cpu")
    d = eng.metrics().to_dict()
    assert JForwardPassMetrics.from_dict(d).to_dict() == d
    assert ForwardPassMetrics.from_dict(d).to_dict() == d
    assert set(d["kv_stats"]) == set(JForwardPassMetrics().to_dict()[
        "kv_stats"])
    assert set(d["worker_stats"]) == set(JForwardPassMetrics().to_dict()[
        "worker_stats"])


def test_clear_drops_puts_in_flight(weights):
    """A clear while offload batches are queued, in flight or on the put
    thread leaves every tier empty: nothing queued before it lands
    after it."""
    eng = TorchEngine(TConfig.tiny(dtype="float32"), TEngineConfig(**KW),
                      params=params_from_jax(weights[1], device="cpu"),
                      device="cpu")

    async def drive():
        await _collect(eng, tproto, PROMPT_A)
        await _collect(eng, tproto, PRESSURE[0])
        n = await asyncio.to_thread(eng.clear_kv_blocks)
        await _settle(eng)
        left = len(eng.offload)
        await eng.stop()
        return n, left

    n, left = asyncio.run(drive())
    assert n >= 6 and left == 0


def test_puts_beside_onboards_under_thread_switch_stress(weights):
    """The put thread and the loop's onboards share the tiers: with the
    interpreter switching threads every microsecond and no settling
    between requests, every request is token-identical to an engine
    without tiers, and afterwards every tier entry holds a distinct slot
    whose bytes verify against its crc."""
    import sys

    kw = {**KW, "host_offload_pages": 2, "disk_offload_pages": 6}
    mk = lambda **k: TorchEngine(  # noqa: E731
        TConfig.tiny(dtype="float32"), TEngineConfig(**{**kw, **k}),
        params=params_from_jax(weights[1], device="cpu"), device="cpu")
    prompts = [PROMPT_A, PRESSURE[0], PROMPT_A, PRESSURE[1], PRESSURE[0],
               PROMPT_A, PRESSURE[2], PRESSURE[1], PROMPT_A]

    async def run(eng):
        out = [(await _collect(eng, tproto, p))[0] for p in prompts]
        if eng.offload is not None:
            await _settle(eng)
            for tier in (eng.offload, eng.offload.spill):
                slots = [s for s, _, _ in tier._index.values()]
                assert len(set(slots)) == len(slots)
                held = list(tier._index)
                if held:
                    assert tier.verify_pages(
                        held, tier.gather(held), tier.gather_scales(held)
                    ) == []
        await eng.stop()
        return out

    want = asyncio.run(run(mk(host_offload_pages=0, disk_offload_pages=0)))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        got = asyncio.run(run(mk()))
        assert time.monotonic() - t0 < 120
    finally:
        sys.setswitchinterval(old)
    assert got == want
