"""The port's KV integrity plane (dynamo_tpu_torch/kv_integrity.py and the
tiers' crcs) against the JAX package's: page checksums equal the JAX
package's for the same bytes (f32, bf16 as raw 2-byte words, int8 with
its scales), the quarantine's TTL and cap, tier verification, the crc
travelling down the spill, the G3 manifest's restart, scrub, truncation
and stale-manifest cases, and, on TorchEngine against TpuEngine, a
byte flipped in a G2-resident page: caught at onboard, quarantined and
recomputed, with identical tokens and integrity counters."""
import asyncio
import json
import os
import shutil
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
from dynamo_tpu.kv_integrity import page_checksum as j_page_checksum
from dynamo_tpu.kv_integrity import page_checksums as j_page_checksums
from dynamo_tpu.kv_quant import QuantizedPages as JQuantizedPages
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import ModelConfig as JConfig
from dynamo_tpu.parallel.mesh import MeshConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.tokens import TokenBlockSequence
from dynamo_tpu_torch.engine.config import EngineConfig as TEngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.offload import DiskOffloadTier, HostOffloadTier
from dynamo_tpu_torch.kv_integrity import (
    KV_INTEGRITY,
    KvIntegrityError,
    KvQuarantine,
    page_checksum,
    page_checksums,
)
from dynamo_tpu_torch.kv_quant import QuantizedPages
from dynamo_tpu_torch.models.config import ModelConfig as TConfig
from dynamo_tpu_torch.models.llama import params_from_jax
from dynamo_tpu_torch.protocols import common as tproto

PS = 16
SHAPE = (2, 2, 1, PS, 4)  # (2, L, kvh, ps, hd)
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 from ml_dtypes included) as a torch tensor with
    the same bytes."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _pages(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(SHAPE[:3] + (n,) + SHAPE[3:]).astype(dtype)


# ---------------------------------------------------------------------------
# checksum primitives


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_page_checksum_equals_jax_layout_invariant_and_sensitive(dt):
    batch = _pages(3, dtype=DTYPES[dt][0])
    tb = to_torch(batch)
    assert tb.dtype == DTYPES[dt][1]
    # a strided slice and its dense copy agree, and equal the JAX crc of
    # the same bytes
    assert page_checksum(tb[:, :, :, 1]) == page_checksum(
        tb[:, :, :, 1].contiguous()) == j_page_checksum(batch[:, :, :, 1])
    crcs = page_checksums(tb)
    assert crcs == j_page_checksums(batch)
    assert len(set(crcs)) == 3
    # one flipped bit anywhere changes the page's checksum
    dirty = tb.clone()
    dirty.view(torch.uint8).reshape(-1)[123] ^= 1
    assert page_checksums(dirty) != crcs


def test_page_checksums_cover_int8_scales_as_jax():
    data = np.arange(2 * 2 * 1 * 2 * PS * 4, dtype=np.int8).reshape(
        2, 2, 1, 2, PS, 4)
    scales = np.linspace(0.5, 2.0, 8, dtype=np.float32).reshape(2, 2, 2)
    q = QuantizedPages(to_torch(data), to_torch(scales))
    crcs = page_checksums(q)
    assert crcs == j_page_checksums(JQuantizedPages(data, scales))
    # a flipped SCALE fails verification exactly like a payload bit
    bad = QuantizedPages(q.data, q.scales.clone())
    bad.scales[0, 0, 1] = 2.5
    crcs2 = page_checksums(bad)
    assert crcs2[0] == crcs[0] and crcs2[1] != crcs[1]


def test_integrity_error_is_typed():
    e = KvIntegrityError("g2: mismatch", bad_pages=(1, 3))
    assert isinstance(e, RuntimeError) and e.bad_pages == (1, 3)


def test_quarantine_ttl_and_cap():
    q = KvQuarantine(ttl_s=0.05, max_entries=4)
    before = KV_INTEGRITY.get("dynamo_kv_integrity_quarantined_total")
    assert q.add(7) is True
    assert q.add(7) is False  # no double count
    assert 7 in q and len(q) == 1
    assert KV_INTEGRITY.get(
        "dynamo_kv_integrity_quarantined_total") == before + 1
    time.sleep(0.06)
    assert 7 not in q and len(q) == 0  # TTL lapsed: readmittable
    # the capacity cap bounds memory under a corruption storm
    assert q.add_all(range(10)) == 10
    assert len(q) <= 4


# ---------------------------------------------------------------------------
# tier verify and quarantine, port beside JAX


def test_tier_verify_detects_corruption_and_quarantine_refuses():
    batch = _pages(3, seed=4)
    jt = JHost(4, SHAPE, np.float32, quarantine=None)
    q = KvQuarantine()
    t = HostOffloadTier(4, SHAPE, torch.float32, quarantine=q)
    assert t.put_batch([1, 2, 3], [0, 1, 2], to_torch(batch)) == 3
    assert jt.put_batch([1, 2, 3], [0, 1, 2], batch) == 3
    assert [t.checksum_of(h) for h in (1, 2, 3)] == [
        jt.checksum_of(h) for h in (1, 2, 3)]
    got = t.gather([1, 2, 3])
    assert t.verify_pages([1, 2, 3], got) == []
    got[:, :, :, 1] += 1.0  # rot on the gathered copy
    jgot = jt.gather([1, 2, 3])
    jgot[:, :, :, 1] += 1.0
    assert t.verify_pages([1, 2, 3], got) == jt.verify_pages(
        [1, 2, 3], jgot) == [1]
    # the tier's own bytes were not touched by the rot of the copy
    assert t.verify_pages([1, 2, 3], t.gather([1, 2, 3])) == []
    # quarantined hashes are refused re-admission and dropped everywhere
    q.add(2)
    t.drop_everywhere(2)
    assert 2 not in t
    assert t.put_one(2, 1, to_torch(batch)[:, :, :, 1]) is False
    assert t.lookup_run([1, 2, 3]) == [(1, 0)]


def test_rot_page_fails_the_next_verify():
    t = HostOffloadTier(4, SHAPE, torch.float32)
    t.put_batch([5, 6], [0, 5], to_torch(_pages(2, seed=9)))
    assert t.rot_page(6) and not t.rot_page(99)
    assert t.verify_pages([5, 6], t.gather([5, 6])) == [1]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_checksum_travels_down_the_spill(tmp_path, dt):
    np_dt, t_dt = DTYPES[dt]
    batch = _pages(2, seed=5, dtype=np_dt)
    disk = DiskOffloadTier(4, SHAPE, t_dt, path=str(tmp_path / "g3.mmap"))
    t = HostOffloadTier(1, SHAPE, t_dt, spill=disk)
    jdisk = JDisk(4, SHAPE, np_dt, path=str(tmp_path / "j3.mmap"))
    jt = JHost(1, SHAPE, np_dt, spill=jdisk)
    for tier, data in ((t, to_torch(batch)), (jt, batch)):
        tier.put_batch([1], [0], data[:, :, :, :1])
    crc = t.checksum_of(1)
    assert crc == jt.checksum_of(1)
    t.put_batch([2], [1], to_torch(batch)[:, :, :, 1:])  # spills 1
    jt.put_batch([2], [1], batch[:, :, :, 1:])
    assert 1 in disk and 1 in jdisk
    # G3 inherits G2's seal-time crc (no re-mint over memory bytes)
    assert disk.checksum_of(1) == crc == jdisk.checksum_of(1)
    assert t.checksum_of(1) == crc  # through the tier walk
    disk.close()
    jdisk.close()
    # byte for byte: the two G3 files and their manifests are equal
    with open(tmp_path / "g3.mmap", "rb") as a, \
            open(tmp_path / "j3.mmap", "rb") as b:
        assert a.read() == b.read()
    with open(tmp_path / "g3.mmap.manifest") as a, \
            open(tmp_path / "j3.mmap.manifest") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# G3 crash consistency: manifest journal and startup scrub


def test_g3_manifest_restart_survival(tmp_path):
    path = str(tmp_path / "g3.mmap")
    disk = DiskOffloadTier(4, SHAPE, torch.float32, path=path)
    batch = _pages(3, seed=6)
    disk.put_batch([11, 12, 13], [0, 11, 12], to_torch(batch))
    crcs = [disk.checksum_of(h) for h in (11, 12, 13)]
    assert crcs == j_page_checksums(batch)
    # crash: abandon the tier without close(); the journal was flushed
    # per record, the pool through the OS page cache
    disk._mm.flush()
    del disk

    disk2 = DiskOffloadTier(4, SHAPE, torch.float32, path=path,
                            scrub_on_start=True)
    assert disk2.scrub_recovered == 3 and disk2.scrub_dropped == 0
    assert disk2.lookup_run([11, 12, 13]) == [(11, 0), (12, 11), (13, 12)]
    np.testing.assert_array_equal(disk2.gather([11, 12, 13]).numpy(), batch)
    assert [disk2.checksum_of(h) for h in (11, 12, 13)] == crcs
    disk2.close()


def test_g3_scrub_drops_torn_and_corrupt_entries(tmp_path):
    path = str(tmp_path / "g3.mmap")
    disk = DiskOffloadTier(4, SHAPE, torch.float32, path=path)
    batch = _pages(3, seed=7)
    disk.put_batch([21, 22, 23], [0, 21, 22], to_torch(batch))
    slot_22 = disk._index[22][0]
    disk._mm.flush()
    del disk

    # journal damage: a torn tail and an out-of-range slot
    with open(path + ".manifest", "a") as f:
        f.write(json.dumps({"put": 99, "parent": 0, "slot": 77,
                            "crc": 1, "scale": None}) + "\n")
        f.write('{"put": 100, "par')
    # rot at rest: one value inside 22's page region
    pool = np.memmap(path, dtype=np.float32, mode="r+",
                     shape=(2, 2, 1, 4, PS, 4))
    pool[0, 0, 0, slot_22, 0, 0] += 1.0
    pool.flush()
    del pool

    before = KV_INTEGRITY.snapshot()
    disk2 = DiskOffloadTier(4, SHAPE, torch.float32, path=path,
                            scrub_on_start=True)
    assert 21 in disk2 and 23 in disk2 and 22 not in disk2
    assert 99 not in disk2
    assert disk2.scrub_recovered == 2 and disk2.scrub_dropped >= 3
    after = KV_INTEGRITY.snapshot()
    assert after["dynamo_kv_integrity_g3_scrub_recovered_total"] == \
        before["dynamo_kv_integrity_g3_scrub_recovered_total"] + 2
    assert after["dynamo_kv_integrity_failed_total"] == \
        before["dynamo_kv_integrity_failed_total"] + 1
    np.testing.assert_array_equal(disk2.read_page(21).numpy(),
                                  batch[:, :, :, 0])
    disk2.close()


def test_g3_truncated_file_extends_and_drops_tail(tmp_path):
    path = str(tmp_path / "g3.mmap")
    disk = DiskOffloadTier(4, SHAPE, torch.float32, path=path)
    batch = _pages(4, seed=8)
    disk.put_batch([1, 2, 3, 4], [0, 1, 2, 3], to_torch(batch))
    disk._mm.flush()
    nbytes = os.path.getsize(path)
    del disk
    os.truncate(path, nbytes - 100)

    disk2 = DiskOffloadTier(4, SHAPE, torch.float32, path=path,
                            scrub_on_start=True)
    assert os.path.getsize(path) == nbytes  # sparse re-extended
    assert 1 <= disk2.scrub_recovered < 4
    for h in (1, 2, 3, 4):
        if h in disk2:
            np.testing.assert_array_equal(disk2.read_page(h).numpy(),
                                          batch[:, :, :, h - 1])
    disk2.close()


def test_stale_manifest_without_pool_starts_clean(tmp_path):
    path = str(tmp_path / "g3.mmap")
    with open(path + ".manifest", "w") as f:
        f.write(json.dumps({"g3_manifest": 1}) + "\n")
    disk = DiskOffloadTier(4, SHAPE, torch.float32, path=path)
    assert len(disk) == 0
    assert not os.path.exists(path + ".manifest")
    disk.close()


def test_g3_geometry_mismatch_drops_every_entry(tmp_path):
    path = str(tmp_path / "g3.mmap")
    jdisk = JDisk(4, SHAPE, np.float32, path=path)
    jdisk.put_batch([1, 2], [0, 1], _pages(2, seed=3))
    jdisk.close()
    # the same file attached as an int8 tier: dtype mismatch
    disk = DiskOffloadTier(4, SHAPE, torch.int8, path=path,
                           scale_shape=(2, 2))
    assert len(disk) == 0 and disk.scrub_dropped == 2
    disk.close()


# ---------------------------------------------------------------------------
# engine: quarantine-and-recompute, TorchEngine beside TpuEngine

KW = dict(num_pages=13, page_size=PS, max_pages_per_seq=8,
          max_decode_slots=2, prefill_buckets=(32, 64),
          cache_dtype="float32", host_offload_pages=16, offload_batch=8)
PROMPT_A = list(range(1, 50))   # 3 complete blocks + a tail
PRESSURE = [list(range(b, b + 49)) for b in (60, 110, 160, 200)]


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(JConfig.tiny(dtype="float32"), 0)
    return jparams, jax.tree.map(np.asarray, jparams)


def _engines(weights, **kw):
    jeng = TpuEngine(JConfig.tiny(dtype="float32"),
                     JEngineConfig(**{**KW, **kw}), params=weights[0],
                     mesh_config=MeshConfig(tp=1))
    teng = TorchEngine(TConfig.tiny(dtype="float32"),
                       TEngineConfig(**{**KW, **kw}),
                       params=params_from_jax(weights[1], device="cpu"),
                       device="cpu")
    return (jeng, jproto, J_INTEGRITY), (teng, tproto, KV_INTEGRITY)


async def _collect(eng, proto, prompt, n_new=6):
    req = proto.PreprocessedRequest(
        token_ids=list(prompt),
        stop_conditions=proto.StopConditions(max_tokens=n_new,
                                             ignore_eos=True))
    toks = []
    async for out in eng.generate(req):
        toks.extend(out.token_ids)
    return toks


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


async def _evict_to_host(eng, proto):
    """Run PROMPT_A, then pressure the 12-page pool until its prefix
    blocks live only in the host tiers; returns the run's tokens and A's
    3 block hashes."""
    toks = [await _collect(eng, proto, PROMPT_A)]
    await _settle(eng)
    for p in PRESSURE:
        toks.append(await _collect(eng, proto, p))
        await _settle(eng)
    hashes = TokenBlockSequence.from_tokens(
        PROMPT_A, PS, salt="").block_hashes()[:3]
    assert eng.allocator.cached_prefix_len(hashes) == 0, \
        "test premise: A's blocks must be evicted from HBM"
    return toks, hashes


async def _bitflip_run(eng, proto, registry):
    toks, hashes = await _evict_to_host(eng, proto)
    assert all(h in eng.offload for h in hashes), \
        "test premise: A's blocks must sit in G2"
    # silent memory rot: one bit of the MIDDLE block's G2 bytes
    assert eng.offload.rot_page(hashes[1])
    before = registry.snapshot()
    toks.append(await _collect(eng, proto, PROMPT_A))
    after = registry.snapshot()
    delta = {k: after[k] - before[k] for k in after}
    await _settle(eng)
    state = (hashes[1] in eng.kv_quarantine, hashes[1] in eng.offload,
             eng.offload.onboard_hits, asdict(eng.metrics().kv_stats),
             list(eng.offload._index))
    await eng.stop()
    return toks, delta, state


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_g2_bitflip_quarantined_and_token_identical_to_tpu_engine(
        weights, kv_quant):
    """A bit flipped in a G2-resident page is caught at onboard, the block
    quarantined, it and the blocks behind it recomputed as prefill, and
    the stream token-identical to the clean run; the port's tokens,
    counter deltas, onboard hits and kv_stats equal TpuEngine's."""
    (je, jp, jr), (te, tp, tr) = _engines(weights, kv_quant=kv_quant)
    j = asyncio.run(_bitflip_run(je, jp, jr))
    t = asyncio.run(_bitflip_run(te, tp, tr))
    assert t[0] == j[0]
    # the clean reference: the same prompt with no tiers
    ref = TorchEngine(TConfig.tiny(dtype="float32"),
                      TEngineConfig(**{**KW, "host_offload_pages": 0,
                                       "kv_quant": kv_quant}),
                      params=params_from_jax(weights[1], device="cpu"),
                      device="cpu")
    clean = asyncio.run(_collect(ref, tproto, PROMPT_A))
    asyncio.run(ref.stop())
    assert t[0][-1] == clean == t[0][0]
    tdelta, jdelta = t[1], j[1]
    assert tdelta["dynamo_kv_integrity_failed_total"] == \
        jdelta["dynamo_kv_integrity_failed_total"] >= 1
    assert tdelta["dynamo_kv_integrity_quarantined_total"] == \
        jdelta["dynamo_kv_integrity_quarantined_total"] == 1
    # block 1 and everything behind it recomputed
    assert tdelta["dynamo_kv_integrity_recomputed_total"] == \
        jdelta["dynamo_kv_integrity_recomputed_total"] >= 2
    assert tdelta["dynamo_kv_integrity_verified_total"] == \
        jdelta["dynamo_kv_integrity_verified_total"]
    assert t[2] == j[2]
    assert t[2][:2] == (True, False)  # quarantined, dropped from G2


async def _crash_restart(eng_factory, proto, path, tmp_path):
    eng = eng_factory(disk_offload_path=path)
    toks, hashes = await _evict_to_host(eng, proto)
    assert sum(h in eng.offload.spill for h in hashes) >= 1, \
        "test premise: G2 pressure must spill A to disk"
    crash = str(tmp_path / f"{os.path.basename(path)}-crash")
    # the crash snapshot: the file as the OS page cache holds it
    shutil.copy(path, crash)
    shutil.copy(path + ".manifest", crash + ".manifest")
    with open(crash + ".manifest", "a") as f:
        f.write('{"put": 424242, "sl')  # torn mid-write record
    await eng.stop()
    eng2 = eng_factory(disk_offload_path=crash, scrub_on_start=True)
    spill = eng2.offload.spill
    got = (spill.scrub_recovered, spill.scrub_dropped, 424242 in spill,
           list(spill._index))
    toks.append(await _collect(eng2, proto, PROMPT_A))
    await eng2.stop()
    return toks, got


def test_g3_crash_restart_scrub_token_identical_to_tpu_engine(
        weights, tmp_path):
    """A G3 snapshot taken mid-life (pool and journal as on disk, a torn
    journal tail) reattaches with the eager scrub: the port recovers and
    drops what TpuEngine does, and the re-sent prompt is token-identical
    to TpuEngine's."""
    kw = dict(host_offload_pages=2, disk_offload_pages=16)

    def jfactory(**k):
        return TpuEngine(JConfig.tiny(dtype="float32"),
                         JEngineConfig(**{**KW, **kw, **k}),
                         params=weights[0], mesh_config=MeshConfig(tp=1))

    def tfactory(**k):
        return TorchEngine(TConfig.tiny(dtype="float32"),
                           TEngineConfig(**{**KW, **kw, **k}),
                           params=params_from_jax(weights[1], device="cpu"),
                           device="cpu")

    j = asyncio.run(_crash_restart(jfactory, jproto,
                                   str(tmp_path / "j3.mmap"), tmp_path))
    t = asyncio.run(_crash_restart(tfactory, tproto,
                                   str(tmp_path / "t3.mmap"), tmp_path))
    assert t == j
    recovered, dropped, torn_in, _ = t[1]
    assert recovered >= 1 and dropped >= 1 and not torn_in
    assert t[0][-1] == t[0][0]
