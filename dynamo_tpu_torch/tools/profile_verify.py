"""Where one speculative verify's time goes on the card.

One call of the verify's scorer (llama.batch_score) at Llama-3.1-8B
(random bf16 weights from seed 0): one row of K+1 = 5 tokens for each
of CONTEXTS (chip_smoke.py's serve prompts' lengths) over a zeroed
region of 4096 positions, the span bounded as the engine bounds it
(llama.spec_span), under no_grad as the engine runs it. Prints the call's host wall and device ms (CUDA events, after a
warm-up call), then, from one more call under torch.profiler, the
kernels it launched and their device ms in matmuls (cuBLAS and CUTLASS
kernels by name) and in the rest.

The profile holds tens of thousands of kernels. It runs in a process of
its own: after a profile that large, torch.profiler may lose device
events of later profiles in the same process
(``python -m dynamo_tpu_torch.tools.profiler_window``).

Run on the card:

  python -m dynamo_tpu_torch.tools.profile_verify [--json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig

MATMUL_NAMES = ("gemm", "nvjet", "cutlass", "xmma")
CONTEXTS = (812, 687, 757, 320, 963, 891, 835, 487)
K = 4


def profile_verify(cfg: ModelConfig, params, contexts: list[int], k: int,
                   region: int = 4096, seed: int = 0) -> dict:
    dev = params["norm_f"].device
    B, T = len(contexts), k + 1
    toks = torch.randint(0, cfg.vocab_size, (B, T), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed))
    q_starts = [n - 1 for n in contexts]
    seq_lens = [q + T for q in q_starts]
    span = llama.spec_span(max(q_starts), region)
    ctx = llama.init_ctx(cfg, B, region, params["norm_f"].dtype, dev)

    def call():
        with torch.no_grad():
            return llama.batch_score(cfg, params, ctx, toks, list(range(B)),
                                     q_starts, seq_lens, span)

    call()  # warm-up
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    call()
    e1.record()
    wall = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    device = e0.elapsed_time(e1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    n, mm, rest = 0, 0.0, 0.0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.name.lower()
        if name.startswith(("memcpy", "memset")):
            continue
        n += 1
        ms = evt.device_time_total / 1e3
        if any(m in name for m in MATMUL_NAMES):
            mm += ms
        else:
            rest += ms
    return dict(rows=B, tokens_a_row=T, contexts=contexts, span=span,
                wall_ms=wall, device_ms=device, kernels=n,
                matmul_device_ms=mm, other_device_ms=rest)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_verify: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.llama3_8b()
    params = llama.init_params(cfg, 0, device="cuda")
    report = profile_verify(cfg, params, list(CONTEXTS), K)
    if a.json:
        print(json.dumps(report))
    else:
        print("; ".join(f"{k} {v}" for k, v in report.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
