"""Where a decode step's time goes in the PyTorch port, on one GPU.

    python3 tools/torch_profile_decode.py [--kv-quant int8] [--quant int8]
                                          [--sample]

Runs ``dynamo_tpu_torch.models.llama.decode_step`` at the full width of
Llama-3.1-8B (32 layers, random bf16 weights from seed 0; with ``--quant
int8`` w8a16 weights, int8 with per-channel scales drawn on the card as
``init_params`` draws them, every weight product a ``w8a16_gemm`` kernel,
which the "gemm" in its name puts in the matmul group) for the default
EngineConfig's 8 slots, with the serve phase's contexts of chip_smoke.py
(prompts of 128..1024 tokens from seed 0, 17 tokens into decode), over a
dense bf16 region or, with ``--kv-quant int8``, an int8 one (random bytes
and scales). ``--sample`` adds the sampler of a round at temperature 0.8
(``sampling.sample_step``: penalties, top-k, threefry split and Gumbel
draw) to each step. It
prints the host-clock time per step around synchronized steps, the
device time per step that torch.profiler attributes to CUDA kernels,
the device's idle share (1 - device / wall; one under IDLE_RESOLUTION
is printed as unresolved), and the device time by kernel group (matmul,
the flash-decode kernel, the rest) and by kernel name; then the same
wall and device time for one ring->ctx flush (``flush_ctx``, once per
round of ``flush_every`` steps; the int8 region requantizes a window per
lane there). Then a whole engine round (``engine/graphs.py``:
``flush_every`` steps, sampling or argmax, and the flush) replayed from
its CUDA graph, as the engine runs it, beside the same round run
eagerly: wall and device ms and the idle share per step. The last line
is a JSON object with the same numbers. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STEPS = 10
# the idle share is 1 - device / wall with the wall from an unprofiled
# window and the device time from a profiled one (the profiler's own host
# cost would inflate a profiled wall); a share smaller than this is below
# the two windows' noise and is printed as unresolved
IDLE_RESOLUTION = 0.02


def group_of(name: str) -> str:
    low = name.lower()
    if "flash_decode" in low:
        return "flash_decode"
    if any(s in low for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                              "cublas", "splitk")):
        return "matmul"
    return "other"


def idle_text(share: float) -> str:
    if abs(share) < IDLE_RESOLUTION:
        return f"unresolved (|{share:.3f}| < {IDLE_RESOLUTION})"
    return f"{share:.3f}"


def measure(fn) -> tuple[float, dict[str, float]]:
    """Host-clock ms per call around synchronized calls, and the device
    ms per call by kernel name from torch.profiler (3 warm-up calls)."""
    with torch.no_grad():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(STEPS):
                fn()
            torch.cuda.synchronize()
    by_name: dict[str, float] = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] += evt.self_device_time_total / 1e3 / STEPS
    if not by_name:  # some builds attribute kernels to their CPU launchers
        for evt in prof.key_averages():
            if evt.self_device_time_total > 0 and not evt.key.startswith("aten::"):
                by_name[evt.key] += evt.self_device_time_total / 1e3 / STEPS
    return wall_ms, by_name


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv-quant", choices=("none", "int8"), default="none")
    ap.add_argument("--quant", choices=("none", "int8"), default="none",
                    help="weights: bf16, or w8a16 int8")
    ap.add_argument("--sample", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_decode: no CUDA device", file=sys.stderr)
        return 1
    from dynamo_tpu_torch.engine import graphs, sampling
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cfg = (ModelConfig.llama3_8b_int8() if args.quant == "int8"
           else ModelConfig.llama3_8b())
    ecfg = EngineConfig()
    B, dev = ecfg.max_decode_slots, "cuda"
    params = llama.init_params(cfg, 0, dev)
    ctx = llama.init_ctx(cfg, B, ecfg.max_context, torch.bfloat16, dev,
                         kv_quant=args.kv_quant, group=ecfg.page_size)
    ring = llama.init_ring(cfg, B, ecfg.flush_every, torch.bfloat16, dev)
    for name, t in (*ctx.items(), *ring.items()):
        if t.dtype == torch.int8:
            t.random_(-127, 128)
        elif name.endswith("_scale"):
            t.uniform_(0.01, 0.02)
        else:
            t.normal_(0.0, 0.5)
    lens = np.random.RandomState(0).randint(128, 1025, size=B) + 17
    ctx_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    ring_base = ctx_lens - 2
    tokens = torch.zeros(B, dtype=torch.int32, device=dev)
    sp = sampling.default_params(B, dev)
    sp.temperature.fill_(0.8)
    counts = torch.zeros(B, cfg.vocab_size, dtype=torch.int32, device=dev)
    keys = torch.zeros(B, 2, dtype=torch.int64, device=dev)

    def step():
        logits = llama.decode_step(cfg, params, ctx, ring, tokens, ctx_lens,
                                   ring_base, 1)
        if args.sample:
            sampling.sample_step(logits, counts, sp, ecfg.max_top_k, keys)

    dest = torch.arange(B, dtype=torch.int32, device=dev)
    valid = torch.full((B,), ecfg.flush_every, dtype=torch.int32, device=dev)

    def flush():
        llama.flush_ctx(ctx, ring, dest, ring_base, valid)

    # a whole round on an engine's state: the slots' own lanes, the
    # sampler's knobs as above, no seal (the pool is one scratch page)
    state = {"tokens": tokens.clone(), "ctx": ctx_lens.clone(),
             "dest": dest.clone(), "counts": counts.clone(),
             "keys": keys.clone(), "temp": sp.temperature.clone(),
             "top_k": sp.top_k.clone(), "top_p": sp.top_p.clone(),
             "freq": sp.frequency_penalty.clone(),
             "pres": sp.presence_penalty.clone(),
             "rep": sp.repetition_penalty.clone()}
    if not args.sample:
        state["temp"].zero_()
    cache = llama.init_cache(cfg, 1, ecfg.page_size, torch.bfloat16, dev,
                             kv_quant=args.kv_quant)
    programs = graphs.DeviceGraphs(cfg, ecfg, params, ctx, ring, cache,
                                   state, seal_width=ecfg.max_decode_slots)
    programs.prepare()

    def graph_round():
        programs.round(args.sample, False, None)

    def eager_round():
        graphs.run_round(cfg, ecfg, params, ctx, ring, cache, state,
                         programs.out, args.sample, False)

    wall_ms, by_name = measure(step)
    flush_wall_ms, flush_by_name = measure(flush)
    F = ecfg.flush_every
    rounds = {}
    for label, fn in (("graph", graph_round), ("eager", eager_round)):
        r_wall, r_by = measure(fn)
        r_dev = sum(r_by.values())
        r_groups: dict[str, float] = defaultdict(float)
        for name, ms in r_by.items():
            r_groups[group_of(name)] += ms / F
        rounds[label] = {"wall_ms_per_step": r_wall / F,
                         "device_ms_per_step": r_dev / F,
                         "idle_share": 1 - r_dev / r_wall,
                         "groups_ms_per_step": dict(r_groups)}
    device_ms = sum(by_name.values())
    flush_device_ms = sum(flush_by_name.values())
    groups: dict[str, float] = defaultdict(float)
    for name, ms in by_name.items():
        groups[group_of(name)] += ms
    print(f"card: {smi}; torch {torch.__version__}")
    mode = (f"kv_quant={args.kv_quant}"
            + (", w8a16 weights" if args.quant == "int8" else "")
            + (", sampled" if args.sample else ""))
    print(f"decode_step ({mode}) at Llama-3.1-8B, B={B}, contexts "
          f"{lens.tolist()}: "
          f"wall {wall_ms:.3f} ms/step, device {device_ms:.3f} ms/step, "
          f"device idle {idle_text(1 - device_ms / wall_ms)} of wall")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {g}: {ms:.3f} ms/step")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  kernel {ms:.4f} ms/step  {name[:110]}")
    print(f"flush_ctx ({mode.split(',')[0]}, once per round of "
          f"{ecfg.flush_every} steps): wall {flush_wall_ms:.3f} ms, device "
          f"{flush_device_ms:.3f} ms")
    for label, r in rounds.items():
        how = ("replayed from its CUDA graph" if label == "graph"
               else "run eagerly")
        print(f"round ({mode}, {F} steps + flush, {how}): wall "
              f"{r['wall_ms_per_step']:.3f} ms/step, device "
              f"{r['device_ms_per_step']:.3f} ms/step, device idle "
              f"{idle_text(r['idle_share'])} of wall; groups " + ", ".join(
                  f"{g} {ms:.3f}" for g, ms in sorted(
                      r["groups_ms_per_step"].items(), key=lambda kv: -kv[1]))
              + " ms/step")
    print("round graph captures: " + ", ".join(
        f"{k} {t:.3f} s" for k, t in programs.capture_s.items())
        + f"; graph pool {programs.pool_bytes / 2**20:.1f} MiB")
    print(json.dumps({
        "card": smi, "kv_quant": args.kv_quant, "quant": args.quant,
        "sample": args.sample,
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "idle_share": 1 - device_ms / wall_ms,
        "groups_ms_per_step": dict(groups),
        "flush_wall_ms": flush_wall_ms, "flush_device_ms": flush_device_ms,
        "graph_round": rounds["graph"], "eager_round": rounds["eager"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
