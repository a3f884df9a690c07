"""Time the w8a16 wgmma kernel over its tile plans, on one GPU.

    python3 tools/torch_w8a16_sweep.py [--m 32,48,64,128,200,512,1024,2048] [--timeline]

For each Llama-3.1-8B layer weight shape (wq/wo, wk/wv, wg/wu, wd) and
each M, runs the wgmma kernel of ``dynamo_tpu_torch/ops/w8a16.py`` (bf16
x, layout "kn", bf16 out) at every plan (BR = 128 or 256 activation rows
a block, K split over 1..8 blocks of a cluster), checks each result
against the plain version (chip_smoke.w8a16_want, the same tolerance as
the card check) and times it over weights too large for L2, beside the
plan that ``w8a16.route`` picks, the mma kernel at the same M and cuBLAS
over a bf16 weight of the shape. First it prints how many clusters of
each size the card runs at once (cudaOccupancyMaxActiveClusters). With
``--timeline`` it instead runs each shape once at the routed plan with
the kernel's %globaltimer stamps on and prints where a block's time goes.
The last line is a JSON object with every figure. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SPLITS = (1, 2, 3, 4, 6, 8)


def timeline(w8a16, x, q, s, kernel) -> dict:
    """One call with the kernel's %globaltimer stamps on: per block (median
    and max over the blocks, microseconds) the first stage's arrival, the
    main loop, the partial tile and the epilogue; for block (0, 0, 0) per
    k tile (medians) the time from the producer's issue to the data's
    arrival in consumer 0, consumer 0's wait for it, its step period, and
    the wait_group 1 of its step (from the stamp before the stage's wait)."""
    import ctypes

    import numpy as np

    lib = w8a16._fn("w8a16_gemm_set_trace", [ctypes.c_void_p])
    slots = lib(None)
    K, N = q.shape
    M = x.shape[0]
    br, splits = kernel[1]
    blocks = -(-M // br) * -(-N // 128) * splits
    buf = torch.zeros(blocks * slots + 4 * 256, dtype=torch.int64,
                      device="cuda")
    w8a16._launch(x, q, s, torch.bfloat16, "kn", kernel)
    torch.cuda.synchronize()
    lib(buf.data_ptr())
    try:
        w8a16._launch(x, q, s, torch.bfloat16, "kn", kernel)
        torch.cuda.synchronize()
    finally:
        lib(None)
    t = buf[:blocks * slots].view(blocks, slots).cpu().numpy().astype(np.float64)
    t0 = t[:, 0].min()
    us = (t[:, :5] - t0) / 1e3
    nkt = int(t[0, 6])
    tl = buf[blocks * slots:].view(256, 4)[:min(nkt, 256)].cpu().numpy()
    tl = (tl.astype(np.float64) - t0) / 1e3

    def stat(v):
        v = np.asarray(v, np.float64).ravel()
        return [round(float(np.median(v)), 3), round(float(v.max()), 3)]

    return {
        "blocks": blocks, "k tiles a block": nkt,
        "SMs used": int(len(np.unique(t[:, 5]))),
        "block start": stat(us[:, 0]),
        "first stage landed": stat(us[:, 1] - us[:, 0]),
        "main loop": stat(us[:, 2] - us[:, 1]),
        "partial tile (+ cluster barrier)": stat(us[:, 3] - us[:, 2]),
        "epilogue": stat(us[:, 4] - us[:, 3]),
        "block end": stat(us[:, 4]),
        "block 0 issue -> data in consumer": stat(tl[:, 2] - tl[:, 0]),
        "block 0 consumer wait for data": stat(tl[1:, 2] - tl[1:, 1]),
        "block 0 step period": stat(np.diff(tl[:, 1])),
        "block 0 wait_group 1 (from stage wait)": stat(tl[:, 3] - tl[:, 2]),
        "block 0 producer issue period": stat(np.diff(tl[:, 0])),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", default="32,48,64,128,200,512,1024,2048",
                    help="comma-separated activation rows")
    ap.add_argument("--timeline", action="store_true",
                    help="instead of the sweep, one call of each shape at "
                         "each M with the routed plan, read from the "
                         "kernel's %%globaltimer stamps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_w8a16_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from dynamo_tpu_torch.ops import cuda_build, w8a16

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.build("w8a16_gemm")
    capacity = {f"{br}x{sp}": w8a16.max_clusters(br, sp)
                for br in (128, 256) for sp in SPLITS}
    print("max active clusters (BR x splits): " + ", ".join(
        f"{k} {v}" for k, v in capacity.items()), flush=True)
    clusters = w8a16.card_clusters(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(c.SEED)
    rows = []
    for M in (int(m) for m in args.m.split(",")):
        for name, K, N in c.W8A16_8B_LAYERS:
            x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
            q = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                              dtype=torch.int8)
            s = (torch.rand(N, generator=g, device="cuda") + 0.5) / (73.3 * K ** 0.5)
            if args.timeline:
                routed = w8a16.route(M, N, K, "kn", torch.bfloat16,
                                     torch.bfloat16, clusters)
                tl = timeline(w8a16, x, q, s, routed)
                print(f"{name} M={M} {routed}: " + json.dumps(tl),
                      flush=True)
                rows.append(dict(shape=name, M=M, plan=list(routed[1]), **tl))
                continue
            want = c.w8a16_want(x, q, s, torch.bfloat16, "kn")
            copies = max(1, -(-c.COLD_BYTES // (K * N)))
            qs = [q] + [q.clone() for _ in range(copies - 1)]

            def timed(kernel):
                got = w8a16._launch(x, q, s, torch.bfloat16, "kn", kernel)
                excess = c.w8a16_excess(got, want)
                if not excess <= 1.0:
                    raise AssertionError(f"{name} M={M} {kernel}: exceeds the "
                                         f"tolerance by {excess:.3f}")
                return c.cuda_time_ms(lambda i: w8a16._launch(
                    x, qs[i % copies], s, torch.bfloat16, "kn", kernel),
                    iters=50)

            k_tiles = -(-K // 64)
            plans = {}
            for br in (128, 256):
                for sp in SPLITS:
                    if sp <= k_tiles:
                        plans[f"{br}x{sp}"] = timed(("wgmma", (br, sp)))
            routed = w8a16.route(M, N, K, "kn", torch.bfloat16, torch.bfloat16,
                                 clusters)
            mma_ms = timed(("mma", w8a16.plan(M, N, K)))
            wb = (q.float() * s).to(torch.bfloat16)
            copies_b = max(1, -(-c.COLD_BYTES // (2 * K * N)))
            wbs = [wb] + [wb.clone() for _ in range(copies_b - 1)]
            lib_ms = c.cuda_time_ms(lambda i: torch.matmul(
                x, wbs[i % copies_b]), iters=50)
            best = min(plans, key=plans.get)
            tc_ms = 2.0 * M * N * K / c.H100_BF16_FLOPS * 1e3
            row = dict(shape=name, M=M, K=K, N=N, plans=plans, best=best,
                       routed=f"{routed[0]} {routed[1]}", mma_ms=mma_ms,
                       cublas_ms=lib_ms, tc_bound_ms=tc_ms)
            rows.append(row)
            print(f"{name} M={M}: best {best} {plans[best]:.4f} ms "
                  f"({lib_ms / plans[best]:.2f} of cuBLAS's speed, "
                  f"{tc_ms / plans[best]:.2f} of the tensor-core bound); "
                  f"routed {routed}; mma {mma_ms:.4f} ms; cuBLAS bf16 "
                  f"{lib_ms:.4f} ms; all: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in plans.items()), flush=True)
            del x, q, s, want, qs, wb, wbs
            torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "max_clusters": capacity, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
