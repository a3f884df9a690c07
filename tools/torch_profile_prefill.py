"""Where a batched prefill's time goes in the PyTorch port, on one GPU.

    python3 tools/torch_profile_prefill.py [--quant none,int8,int8,none]

Runs ``dynamo_tpu_torch.models.llama.batch_prefill`` at the full width
and depth of Llama-3.1-8B (32 layers, random weights from seed 0: bf16,
or with ``int8`` w8a16 weights drawn as ``init_params`` draws them) into
the default EngineConfig's context region (8 slots, S = 4096, bf16 KV),
at the serve's widths: K = 2 chunks of T = 1024 (prompts of 963 and 891
tokens, chip_smoke.py's fourth prefill group) and K = 1 of T = 512 (487
tokens). Each call is fresh (no prior context). The weight modes run in
the order given (by default each twice, in turns). For each mode and
shape it prints the host-clock time per call around synchronized calls
(and the host time spent inside each group below), the device time per
call that torch.profiler attributes to CUDA kernels, the device's idle
share (1 - device / wall), and the device time by group: the layer products (every ``_mm``: cuBLAS for bf16 weights, the
w8a16 kernels for int8), attention (``flash_prefill_attention``: plain
PyTorch, its einsums run cuBLAS), the logits (``_logits``) and the rest
(norms, RoPE, embedding, the KV write), read from record_function ranges
the script puts around those functions (the w8a16 kernels, launched
through ctypes, by their names); then the kernels by name. The
last line is a JSON object with the same numbers. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STEPS = 10
# profiled calls: a prefill launches some 10^4 kernels, and the profiler's
# bookkeeping of them takes longer than the calls
PROFILE_STEPS = 3
SHAPES = ((2, 1024, (963, 891)), (1, 512, (487,)))
GROUPS = ("matmul", "attention", "logits")


# host seconds spent inside each group's functions (the annotate wrappers)
HOST_S: dict[str, float] = defaultdict(float)


def annotate(llama):
    """Wrap the layer products, attention and the logits of ``llama`` in
    record_function ranges named prefill::<group>, and add the host time
    spent inside them to HOST_S."""
    def wrap(fn, group):
        def inner(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"prefill::{group}"):
                out = fn(*a, **kw)
            HOST_S[group] += time.perf_counter() - t0
            return out
        return inner

    llama._mm = wrap(llama._mm, "matmul")
    llama.flash_prefill_attention = wrap(llama.flash_prefill_attention,
                                         "attention")
    llama._logits = wrap(llama._logits, "logits")


def measure(fn):
    """Host-clock ms per call around synchronized calls, with the host ms
    per call inside each group; device ms per call by kernel name and by
    group from torch.profiler (3 warm-up calls)."""
    with torch.no_grad():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        HOST_S.clear()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        host = {g: s * 1e3 / STEPS for g, s in HOST_S.items()}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILE_STEPS):
                fn()
            torch.cuda.synchronize()
    by_name: dict[str, float] = defaultdict(float)
    groups: dict[str, float] = defaultdict(float)
    for evt in prof.key_averages():
        if evt.key.startswith("prefill::"):
            # the CPU range's device time: the kernels of the aten ops
            # inside it (its CUDA-side twin spans the gaps between them)
            if evt.device_type == torch.autograd.DeviceType.CPU:
                groups[evt.key.split("::")[1]] += (evt.device_time_total
                                                   / 1e3 / PROFILE_STEPS)
        elif evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] += (evt.self_device_time_total / 1e3
                                 / PROFILE_STEPS)
    # a kernel launched through ctypes has no aten op to hang from, so the
    # w8a16 kernels go by name: the wgmma kernel runs the layer products
    # (every _mm at these widths), the mma kernel the logits
    for name, ms in by_name.items():
        if "w8a16_gemm_wgmma" in name:
            groups["matmul"] += ms
        elif "w8a16_gemm_mma" in name:
            groups["logits"] += ms
    return wall_ms, host, dict(by_name), dict(groups)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", default="none,int8,int8,none",
                    help="comma-separated weight modes in the order run: "
                         "none (bf16), int8 (w8a16); the default runs each "
                         "twice, in turns, so a drift of the host shows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_prefill: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    annotate(llama)
    ecfg = EngineConfig()
    B, dev = ecfg.max_decode_slots, "cuda"
    rng = np.random.RandomState(0)
    results = []
    modes = args.quant.split(",")
    weights = {}
    for quant in dict.fromkeys(modes):
        cfg = (ModelConfig.llama3_8b_int8() if quant == "int8"
               else ModelConfig.llama3_8b())
        weights[quant] = (cfg, llama.init_params(cfg, 0, dev))
    ctx = llama.init_ctx(ModelConfig.llama3_8b(), B, ecfg.max_context,
                         torch.bfloat16, dev)
    for quant in modes:
        cfg, params = weights[quant]
        for K, T, lens in SHAPES:
            toks = torch.from_numpy(rng.randint(3, cfg.vocab_size,
                                                size=(K, T))).to(dev)

            def call():
                llama.batch_prefill(cfg, params, ctx, toks, list(range(K)),
                                    [0] * K, list(lens), 0)

            wall_ms, host, by_name, groups = measure(call)
            device_ms = sum(by_name.values())
            groups["other"] = device_ms - sum(groups.get(g, 0.0)
                                              for g in GROUPS)
            row = dict(quant=quant, K=K, T=T, seq_lens=list(lens),
                       wall_ms=wall_ms, device_ms=device_ms,
                       idle_share=1 - device_ms / wall_ms, groups=groups,
                       host_ms=host)
            results.append(row)
            print(f"batch_prefill (weights {'w8a16' if quant == 'int8' else 'bf16'}"
                  f", K={K}, T={T}, prompts {list(lens)}) at Llama-3.1-8B: "
                  f"wall {wall_ms:.3f} ms/call, device {device_ms:.3f} "
                  f"ms/call, device idle {1 - device_ms / wall_ms:.3f} of "
                  f"wall; groups " + ", ".join(
                      f"{g} {groups.get(g, 0.0):.3f}"
                      for g in (*GROUPS, "other")) + " ms/call; host "
                  "inside them " + ", ".join(
                      f"{g} {host.get(g, 0.0):.3f}" for g in GROUPS)
                  + " ms/call", flush=True)
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
                print(f"  kernel {ms:.4f} ms/call  {name[:110]}")
    print(json.dumps({"card": smi, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
