"""What a KV page costs the host in the PyTorch port's offload tiers, on one
GPU's machine.

    python3 tools/torch_offload_host.py [--pages 8] [--reps 5]

For a Llama-3.1-8B page (2 x 32 layers x 8 KV heads x 64 tokens x 128,
bf16: 8 MiB; int8: 4 MiB plus 256 B of scales) it times on the host
clock, per page, median of ``--reps`` runs over ``--pages`` pages:

- crc32 (``kv_integrity.page_checksum``), one page at a time and the
  batch's pages spread over a thread pool of 2, 4 and 8 workers (zlib
  releases the interpreter lock);
- the copy of a page from one pinned buffer into another (an offload
  put into a G2 slot) and from a G3-layout memory map into a pinned
  stage (an onboard gather from disk, page axis at 3);
- a G3 put carrying its crc (a G2 spill) into a fresh sparse file (one
  run) and into slots already written (median);
- the G2 put of the batch (its crcs, then ``HostOffloadTier.put_batch``
  carrying them) and the onboard ``gather`` + ``verify_pages``, one page
  after another and with a pool of min(8, CPUs) threads (how the engine's
  put thread and onboards run them);

and on the device, with CUDA events, the GB/s of one batch's copy
device->host into pinned memory and host->device from it. The last line
is a JSON object with every number and the card's name and power limit.
Needs a CUDA device (pinned memory and the copies).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dynamo_tpu_torch.engine.offload import (  # noqa: E402
    DiskOffloadTier,
    HostOffloadTier,
)
from dynamo_tpu_torch.kv_integrity import (  # noqa: E402
    page_checksum,
    page_checksums,
)

PAGE = (2, 32, 8, 64, 128)   # Llama-3.1-8B, page_size 64


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def measure(dtype: torch.dtype, n: int, reps: int) -> dict:
    scale_shape = (2, 32) if dtype == torch.int8 else ()
    if dtype == torch.int8:
        src = torch.randint(-127, 128, (n,) + PAGE, dtype=torch.int8)
    else:
        src = torch.randn((n,) + PAGE).to(dtype)
    src = src.pin_memory()
    scales = (torch.rand((n,) + scale_shape) if scale_shape else None)
    out = {}

    def crc_all(pool=None):
        def one(i):
            return page_checksum(src[i], scales[i] if scales is not None
                                 else None)
        if pool is None:
            return [one(i) for i in range(n)]
        return list(pool.map(one, range(n)))

    out["crc_ms"] = median_ms(crc_all, reps) / n
    for w in (2, 4, 8):
        with ThreadPoolExecutor(w) as pool:
            out[f"crc_{w}_threads_ms"] = median_ms(
                lambda: crc_all(pool), reps) / n
    dst = torch.empty_like(src[0]).pin_memory()
    out["copy_pinned_ms"] = median_ms(
        lambda: [dst.copy_(src[i]) for i in range(n)], reps) / n
    data = src.permute(1, 2, 3, 0, 4, 5)
    sc = scales.permute(1, 2, 0) if scales is not None else None
    crcs = [0] * n   # carried crcs, as a G2 spill carries them
    with tempfile.TemporaryDirectory() as tmp:
        disk = DiskOffloadTier(n, PAGE, dtype, path=os.path.join(tmp, "g3"),
                               scale_shape=scale_shape)
        # a put into the fresh (sparse) file, then into written slots
        t0 = time.perf_counter()
        disk.put_batch(list(range(n)), [0] * n, data, sc, crcs)
        out["g3_put_fresh_ms"] = (time.perf_counter() - t0) * 1e3 / n

        def put_again():
            disk.clear()
            disk.put_batch(list(range(n)), [0] * n, data, sc, crcs)

        out["g3_put_again_ms"] = median_ms(put_again, reps) / n
        disk.clear()
        disk.put_batch(list(range(n)), [0] * n, data, sc)
        stage = torch.empty_like(src)
        out["copy_g3_to_pinned_ms"] = median_ms(
            lambda: disk.gather(list(range(n)), out=stage), reps) / n
        disk.close()
    tier = HostOffloadTier(n, PAGE, dtype, scale_shape=scale_shape,
                           pin_memory=True)

    def put():
        # as the engine's put thread: the batch's crcs first (on the pool
        # when there is one), then the puts carrying them
        tier.clear()
        crcs = page_checksums(data, sc, tier.crc_pool)
        tier.put_batch(list(range(n)), [0] * n, data, sc, crcs)

    stage = torch.empty_like(src)

    def onboard():
        hs = list(range(n))
        got = tier.gather(hs, out=stage)
        assert tier.verify_pages(hs, got, tier.gather_scales(hs)) == []

    out["g2_put_ms"] = median_ms(put, reps) / n
    out["g2_gather_verify_ms"] = median_ms(onboard, reps) / n
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        tier.crc_pool = pool   # as the engine runs its tiers
        out["g2_put_pool_ms"] = median_ms(put, reps) / n
        out["g2_gather_verify_pool_ms"] = median_ms(onboard, reps) / n
        tier.crc_pool = None
    dev = src.to("cuda")
    host = torch.empty_like(src).pin_memory()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(2):
        ev[0].record()
        host.copy_(dev, non_blocking=True)
        ev[1].record()
        dev.copy_(host, non_blocking=True)
        ev[2].record()
        torch.cuda.synchronize()
    nbytes = src.numel() * src.element_size()
    out["d2h_gb_s"] = nbytes / (ev[0].elapsed_time(ev[1]) / 1e3) / 1e9
    out["h2d_gb_s"] = nbytes / (ev[1].elapsed_time(ev[2]) / 1e3) / 1e9
    out["page_mib"] = src[0].numel() * src.element_size() / 2**20
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pages", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_offload_host: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; host: {os.cpu_count()} CPUs; torch "
          f"{torch.__version__}, {torch.get_num_threads()} intra-op threads")
    res = {"card": card, "cpus": os.cpu_count()}
    for name, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        r = measure(dtype, a.pages, a.reps)
        res[name] = r
        print(f"{name} page ({r['page_mib']:.0f} MiB), ms a page: " + ", ".join(
            f"{k[:-3]} {v:.3f}" for k, v in r.items() if k.endswith("_ms"))
            + f"; D2H {r['d2h_gb_s']:.2f} GB/s, H2D {r['h2d_gb_s']:.2f} GB/s")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
