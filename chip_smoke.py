"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line (any failure raises and exits non-zero):
  1. card: name and power limit (nvidia-smi);
  2. build: the serving path's CUDA kernels (the dense and int8 modes of
     flash decode), compiled with nvcc from
     dynamo_tpu_torch/csrc/flash_decode.cu, with ptxas's register,
     shared-memory and spill counts;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes serving gives it (Llama-3.1-8B and Llama-3.2-1B decode
     shapes, several context/ring patterns; the plain version runs in f32
     on the same inputs, rounding P to bf16 before P.V where the kernel
     does (the bf16 kernels, as the TPU kernel), and per element
     |kernel - plain| <= atol + rtol * |plain|; controls that must fail
     the check: a dropped row, and K scales off by 5% in int8 mode, V rows
     off by 5% in dense mode), with the kernel's, the plain version's and
     one library call's times and the kernel's least time (its byte or
     operation bound); each mode's check also times the other mode's
     kernel over the same K/V in the same call (dense over the region
     before quantization, int8 over it quantized);
  4. tiny: TorchEngine on ModelConfig.tiny (f32) on the card, its rounds
     replayed CUDA graphs, must be greedy token-identical to the same
     engine on the CPU, whose rounds run eagerly (the CPU tests hold it
     against the JAX TpuEngine); with int8 KV too, where a
     greedy token may differ only at a CPU near-tie (top-2 logprob gap
     <= 0.05), and a seeded request at temperature 0.8 must draw the same
     stream on both devices;
  5. round_graph: for the tiny model (f32) and Llama-3.1-8B with dense
     and with int8 KV, an engine admits the prompts, then one decode
     round replayed from its CUDA graph and the same round run eagerly
     (engine/graphs.py ``run_round``) on a clone of the same device state
     must give identical tokens, greedy and with logprobs (the largest
     logprob difference is printed); torch.profiler then counts the CUDA
     runtime calls of one steady pipelined round (one graph launch, the
     fetch copies, no kernel launched from the host) and the flash-decode
     kernels inside the replay (one a layer a step; the kernel's own
     count on the card must agree); each graph's capture
     time and the graph pool's memory are printed;
  6. serve: TorchEngine at the full width of Llama-3.1-8B (32 layers,
     random bf16 weights from a seed, made once, default EngineConfig:
     rounds pipelined, each round a replayed CUDA graph) answers 8
     concurrent greedy requests and a prefix-cache hit through
     generate(), first with dense KV, then with int8 KV; launch counts
     are zeroed just before each and read just after: every round and
     patch must have been a graph replay, the wrapper must have issued
     no launch, and the count the kernel keeps on the card (block
     (0, 0, 0) of each launch adds one, graph replays included) must show
     the kernel of that mode ran on every layer of every decode step (and
     the other mode's never), as the engine's count (the launches its
     graphs recorded at capture, once a replay) does. The burst is held
     at the engine's intake until all 8 requests wait, so its prefill
     groups do not depend on arrival timing;
  7. http: the port's entry point on the same weights: launch.run's
     build_chain (dense KV, default EngineConfig) behind the port's
     HttpService on 127.0.0.1, driven by the port's HTTP client: the
     serve phase's 8 prompts as streamed greedy /v1/completions requests
     (token ids, 32 tokens, nvext.ignore_eos), sent in prompt order and
     gated as in the serve phase. Every stream ends in [DONE] with
     finish_reason length, its text (the test tokenizer with one word per
     id) maps back to the serve phase's tokens, the kernel's own count on
     the card rises by layers x decode steps (the kernels line's
     launches_http), a unary chat completion returns 200 and /metrics
     carries the TTFT, ITL and E2E series; TTFT, gaps and tok/s are
     printed beside the serve phase's, with the event loop thread's CPU
     time per streamed token and DecodeStream's cost per token;
  8. cli: ``python -m dynamo_tpu_torch.launch.run in=text out=torch
     --model-config tiny --cache-dtype float32 --prompt "w1 w2 w3"
     --max-tokens 8`` in a subprocess, with no --device: it must run its
     engine on cuda and exit 0.
The card line (nvidia-smi's name and power limit) comes third from last,
the second-to-last line is a JSON object describing every kernel, and the
last is {"ok": true, "device": {...}}. Without a CUDA device, or without
the rest of the repository beside it, the script fails.
"""
from __future__ import annotations

import asyncio
import faulthandler
import gc
import json
import re
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense tensor-core bf16
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
# kernel vs plain, per element: |got - want| <= atol + rtol * |want|; the
# plain version runs in f32 on the same inputs, so in f32 the two differ
# by the order of the sums
F32_TOL = (1e-5, 1e-4)
# bf16: kernel and plain both round P to bf16 before P.V as the TPU
# kernel does (plain_f32 with p_round), and the output to bf16 (one bf16
# step, 2**-7 of |want|). A split rounds exp(s - m_split) and its cluster
# merge rescales by exp(m_split - m) in f32, where the plain version
# rounds exp(s - m). Each probability's rounding then differs by up to
# one bf16 step, and what that does to an output is absolute (set by the
# V rows it averages, ~2**-9 of their weighted |v|), not relative to the
# output: hence the atol. A context that one block holds (ring only)
# rounds exactly as the plain version. A dropped row, K scales off by 5%
# (int8) and V rows off by 5% (dense) still fail it.
BF16_P_TOL = (5e-4, 1e-2)
SEED = 0
# a greedy token of the int8 engine may differ between devices only where
# the CPU's top-2 logprob gap is this small (tests/test_kv_quant.py)
NEAR_TIE = 0.05


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call. The calls are queued behind a kernel that
    spins, so the host's cost of issuing them (the wrapper's checks, the
    ctypes call) stays out of the time; the spin is doubled until it
    outlasts the queuing (a call that synchronises never lets it: after
    6 doublings the time is returned as it is, an upper bound)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    for _ in range(7):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        h0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        queued_ms = (time.perf_counter() - h0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > queued_ms:
            break
        cycles *= 2
    return ev[1].elapsed_time(ev[2]) / iters


def serve_prompts(vocab: int):
    """The serve phase's 8 prompts (lengths 128..1024), from the seed."""
    rng = np.random.RandomState(SEED)
    lens = rng.randint(128, 1025, size=8)
    return [rng.randint(0, vocab, size=int(n)).tolist() for n in lens]


# ---------------------------------------------------------------------------
# kernels

def decode_inputs(dtype, L, nkv, nh, hd, B, S, R):
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def mk(*shape):
        return (torch.randn(shape, generator=g, device="cuda")
                * 0.5).to(dtype)

    return (mk(B, nh, hd), mk(L, nkv, B + 1, S, hd), mk(L, nkv, B + 1, S, hd),
            mk(L, nkv, B, R, hd), mk(L, nkv, B, R, hd))


def decode_patterns(S, R, serve_lens):
    """(ctx_lens, ring_base) per slot: the serve phase's contexts in mid
    round, and an edge-case mix — ring only, a single token, contexts that
    straddle split boundaries, a full region and freed lanes."""
    serve_ctx = [n + 17 for n in serve_lens]
    return {
        "serve": (serve_ctx, [c - 2 for c in serve_ctx]),
        "edges": ([3, 1, 1003, S, 1, 2050, 128, S - 1],
                  [0, 0, 1000, S - 2, 0, 2047, 127, S - 1 - R + 2]),
    }


def decode_bound_ms(ctx, base, nkv, nh, hd, R, elem, group=None):
    """Least time for one call: each live K/V row read once, q read and
    out written once; 4 flops per (head, live row, dim). With ``group``
    (int8 mode) the ctx rows are 1 byte per element, plus one f32 K and V
    scale per group they touch and one dequantizing product per element."""
    live_ctx = sum(min(b, c) for c, b in zip(ctx, base))
    live_ring = sum(max(0, min(c - b, R)) for c, b in zip(ctx, base))
    B = len(ctx)
    ctx_elem = elem if group is None else 1
    nbytes = ((live_ctx * ctx_elem + live_ring * elem) * nkv * hd * 2
              + 2 * B * nh * hd * elem + 2 * B * 4)
    flops = 4 * (live_ctx + live_ring) * nh * hd
    if group is not None:
        nbytes += sum(-(-min(b, c) // group) for c, b in zip(ctx, base)) * 8
        flops += 2 * live_ctx * nkv * hd
    peak = H100_BF16_FLOPS if elem == 2 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tol_excess(got, want, tol):
    """Largest |got - want| / (atol + rtol * |want|) over the elements:
    the check passes while this is at most 1."""
    atol, rtol = tol
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def quantize_groups(x, group):
    """Symmetric int8 with absmax scales per (layer, lane, position group),
    as the int8 region holds them: ([L, nkv, lanes, S, hd] int8,
    [L, lanes, S/group] f32)."""
    L, nkv, lanes, S, hd = x.shape
    amax = x.float().abs().reshape(L, nkv, lanes, S // group, group,
                                   hd).amax(dim=(1, 4, 5))
    sc = torch.clamp(amax / 127.0, min=1e-8)
    per_pos = sc.repeat_interleave(group, dim=2)[:, None, :, :, None]
    q = torch.clamp(torch.round(x.float() / per_pos), -127, 127)
    return q.to(torch.int8), sc


def dense_layer(c, sc, layer, dtype):
    """One layer [1, nkv, lanes, S, hd] of a region in the compute dtype:
    a dense region as it is; an int8 one (scales ``sc``) as the int8 mode
    defines it, the f32 product with the row's scale rounded to dtype."""
    if sc is None:
        return c[layer:layer + 1]
    g = c.shape[3] // sc.shape[2]
    per_pos = sc[layer].repeat_interleave(g, dim=1)[None, None, :, :, None]
    return (c[layer:layer + 1].float() * per_pos).to(dtype)


def plain_f32(fd, q, ck, cv, rk, rv, layer, ctx, base, ksc=None, vsc=None,
              p_round=None):
    """The plain version on the same inputs (an int8 region dequantized
    as above) computed in f32, in q's dtype. With ``p_round`` the
    unnormalized probabilities exp(s - max) are rounded to it before P.V,
    as the TPU kernel rounds them (dynamo_tpu/ops/flash_decode.py:159);
    without, they stay in f32. The f32 kernels keep P in f32, the bf16
    kernels of both modes round it to bf16. At a 3-row context whose
    terms cancel, that rounding alone moves an output by ~2e-3, so each
    kernel is held against the plain version with its own rounding."""
    f = [t.float() for t in (dense_layer(ck, ksc, layer, q.dtype),
                             dense_layer(cv, vsc, layer, q.dtype),
                             rk[layer:layer + 1], rv[layer:layer + 1])]
    return fd.flash_decode_attention_plain(
        q.float(), *f, 0, ctx, base, p_round=p_round).to(q.dtype)


def sdpa_call(q, ck, cv, rk, rv, layer, ctx, base):
    """The same function as one library call (timed as a yardstick only;
    the port never calls it): SDPA over the region up to the longest live
    context, plus the ring, with a mask."""
    B, nh, hd = q.shape
    R = rk.shape[3]
    S = int(torch.minimum(base, ctx).max().item())
    k = torch.cat([ck[layer][:, :B, :S], rk[layer]], dim=2).transpose(0, 1)
    v = torch.cat([cv[layer][:, :B, :S], rv[layer]], dim=2).transpose(0, 1)
    pos = torch.arange(S + R, device="cuda")[None, :]
    ring_pos = base[:, None] + pos - S
    mask = torch.where(pos < S, pos < torch.minimum(base, ctx)[:, None],
                       ring_pos < ctx[:, None])
    k, v, mask = k.contiguous(), v.contiguous(), mask[:, None, None, :]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]

    return call


def check_flash_decode(serve_lens, quant):
    """The kernel in dense mode, or in int8 mode with ``quant`` (inputs
    quantized with per-(layer, lane, group) absmax scales), against its
    plain version; returns the kernels-line figures at the 8B shape. At
    the bf16 serve shapes it also times the other mode's kernel over the
    same K/V in the same call."""
    from dynamo_tpu_torch.ops import flash_decode as fd

    name = "flash_decode_int8" if quant else "flash_decode"
    cases = [  # (label, dtype, L, nkv, nh, hd, B, S, R, int8 group, tol)
        ("llama3_8b", torch.bfloat16, 32, 8, 32, 128, 8, 4096, 4, 64,
         BF16_P_TOL),
        ("llama3_1b", torch.bfloat16, 16, 8, 32, 64, 8, 4096, 4, 64,
         BF16_P_TOL),
        # f32: a ring of 40 rows spans two of the kernel's 32-row f32
        # tiles; the tiny engine's int8 group (page size 16)
        ("llama3_8b_f32", torch.float32, 2, 8, 32, 128, 8, 4096, 40, 16,
         F32_TOL),
    ]
    report = None
    max_err = 0.0  # bf16, every case and pattern
    for label, dtype, L, nkv, nh, hd, B, S, R, group, tol in cases:
        q, ck, cv, rk, rv = decode_inputs(dtype, L, nkv, nh, hd, B, S, R)
        ksc = vsc = dense_kv = None
        if quant:
            dense_kv = (ck, cv)  # the region before quantization
            ck, ksc = quantize_groups(ck, group)
            cv, vsc = quantize_groups(cv, group)
        # the bf16 kernels round P to bf16 before P.V, as the TPU kernel
        # does, and so does their plain version here
        p_round = torch.bfloat16 if dtype == torch.bfloat16 else None
        what = f"{name} {label}" + (f" (group {group})" if quant else "")
        for pname, (ctx_l, base_l) in decode_patterns(S, R, serve_lens).items():
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
            base = torch.tensor(base_l, dtype=torch.int32, device="cuda")
            args = (q, ck, cv, rk, rv)
            err = excess = 0.0
            for layer in (0, L - 1):
                got = fd.flash_decode_attention(*args, layer, ctx, base,
                                                ksc, vsc)
                torch.cuda.synchronize()
                want = plain_f32(fd, *args, layer, ctx, base, ksc, vsc,
                                 p_round)
                err = max(err, (got.float() - want.float()).abs().max().item())
                excess = max(excess, tol_excess(got, want, tol))
                if not excess <= 1.0:
                    raise AssertionError(
                        f"{what} {pname} layer {layer}: |kernel - plain| "
                        f"exceeds atol {tol[0]} + rtol {tol[1]} * |plain| "
                        f"by a factor {excess}")
                if pname != "serve":
                    continue
                # the check must see one dropped row (the plain output
                # without each slot's current token), and K scales (int8)
                # or ctx V rows (dense) 5% off
                controls = {"a dropped row": plain_f32(
                    fd, *args, layer, ctx - 1, base, ksc, vsc, p_round)}
                if quant:
                    controls["K scales x1.05"] = plain_f32(
                        fd, *args, layer, ctx, base, ksc * 1.05, vsc,
                        p_round)
                else:
                    one = [t[layer:layer + 1] for t in (ck, cv, rk, rv)]
                    one[1] = one[1] * 1.05
                    controls["V rows x1.05"] = plain_f32(
                        fd, q, *one, 0, ctx, base, p_round=p_round)
                for bad, out in controls.items():
                    if tol_excess(out, want, tol) <= 1.0:
                        raise AssertionError(
                            f"{what}: tolerance {tol} cannot tell {bad}")
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
            log(f"kernel {what} {pname}: agrees with plain, max |kernel - "
                f"plain| {err:.3e}, at {excess:.3f} of the tolerance (atol "
                f"{tol[0]} + rtol {tol[1]} * |plain|)"
                + ("; the controls (" + ", ".join(controls) + ") fail it"
                   if pname == "serve" else ""))
            if pname != "serve" or dtype != torch.bfloat16:
                continue
            ms = cuda_time_ms(lambda i: fd.flash_decode_attention(
                *args, i % L, ctx, base, ksc, vsc), iters=100)
            # the other mode in the same call, over the same K/V: dense
            # over the region before quantization, int8 over it quantized
            if quant:
                other, o_args, o_sc = "dense", (q, *dense_kv, rk, rv), ()
            else:
                (kq, ks8), (vq, vs8) = (quantize_groups(ck, group),
                                        quantize_groups(cv, group))
                other, o_args, o_sc = "int8", (q, kq, vq, rk, rv), (ks8, vs8)
            other_ms = cuda_time_ms(lambda i: fd.flash_decode_attention(
                *o_args, i % L, ctx, base, *o_sc), iters=100)
            other_note = (f", {other} kernel over the same K/V "
                          f"{other_ms:.4f} ms, {name}/{other} "
                          f"{ms / other_ms:.3f}")
            del o_args, o_sc
            plain_ms = cuda_time_ms(lambda i: fd.flash_decode_attention_plain(
                *args, i % L, ctx, base, ksc, vsc), iters=5, warmup=1)
            # yardstick: one SDPA call; in int8 mode over the ALREADY
            # dequantized bf16 live K/V (no PyTorch call takes int8 K/V
            # with group scales; the dequantization is not timed)
            lib = sdpa_call(q, dense_layer(ck, ksc, 1, dtype),
                            dense_layer(cv, vsc, 1, dtype), rk[1:2], rv[1:2],
                            0, ctx, base)
            library_ms = cuda_time_ms(lambda i: lib(), iters=20)
            del lib
            bound_ms, bound_by = decode_bound_ms(
                ctx_l, base_l, nkv, nh, hd, R, 2, group if quant else None)
            log(f"kernel {name} {label} serve shape: {ms:.4f} ms/call (plain "
                f"{plain_ms:.4f} ms, sdpa"
                + (" over the dequantized bf16 K/V" if quant else "")
                + f" {library_ms:.4f} ms, {bound_by} bound {bound_ms:.4f} ms"
                + other_note + ")")
            if label == "llama3_8b":
                report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
        del q, ck, cv, rk, rv, ksc, vsc, args, dense_kv
        torch.cuda.empty_cache()
    report["max_abs_err"] = max_err
    return report


# ---------------------------------------------------------------------------
# engine

async def generate_all(engine, prompts, max_tokens, logprobs=None,
                       **sampling):
    """Each prompt as a request, all at once; per request (tokens, finish
    reason, final annotations, inter-token gaps, top logprobs)."""
    from dynamo_tpu_torch.protocols.common import (
        OutputOptions,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    async def one(p):
        req = PreprocessedRequest(
            token_ids=list(p),
            stop_conditions=StopConditions(max_tokens=max_tokens,
                                           ignore_eos=True),
            sampling_options=SamplingOptions(**sampling),
            output_options=OutputOptions(logprobs=logprobs))
        toks, ann, finish, gaps, top = [], {}, None, [], []
        last = None
        async for out in engine.generate(req):
            now = time.monotonic()
            if last is not None and out.token_ids:
                # a round's tokens arrive together: spread the gap over them
                gaps += [(now - last) / len(out.token_ids)] * len(out.token_ids)
            if out.token_ids:
                last = now
            toks.extend(out.token_ids)
            top.extend(out.top_logprobs or [])
            if out.finish_reason is not None:
                finish, ann = out.finish_reason.value, out.annotations
        return toks, finish, ann, gaps, top

    return await asyncio.gather(*[one(p) for p in prompts])


def check_replayed(eng, what):
    """Every decode round and state patch ``eng`` ran on the card was a
    CUDA graph replay (the engine issues no eager round there)."""
    dc = eng.dispatch_counts
    programs = dc["round"] + dc["round_seal"] + dc["patch"]
    if not programs or eng.graphs.replays != programs:
        raise AssertionError(
            f"{what}: {eng.graphs.replays} graph replays for {programs} "
            f"rounds and patches")


def check_tiny_engine():
    """Greedy tokens of the tiny model on the card (flash-decode kernel,
    hd 16 f32) vs on the CPU (plain version)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd

    cfg = ModelConfig.tiny(dtype="float32")
    ecfg = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                max_decode_slots=4, prefill_buckets=(32, 64),
                cache_dtype="float32")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)]
    params = llama.init_params(cfg, SEED, device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in params.items()}
        eng = TorchEngine(cfg, EngineConfig(**ecfg), params=p, device=dev)
        if dev == "cuda":
            fd.executed(eng.device, reset=True)

        async def drive():
            res = await generate_all(eng, prompts, 12)
            res.append((await generate_all(eng, prompts[:1], 12))[0])
            await eng.stop()
            return res

        outs[dev] = [(t, f) for t, f, *_ in asyncio.run(drive())]
        if dev == "cuda":
            dense, int8 = fd.executed(eng.device)
            if not dense or int8 or eng.kernel_launches != dense:
                raise AssertionError(
                    f"tiny engine on cuda: the kernel ran {dense} times, "
                    f"int8 {int8}, graphs recorded {eng.kernel_launches}")
            check_replayed(eng, "tiny")
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(
            f"tiny engine: cuda {outs['cuda']} != cpu {outs['cpu']}")
    log(f"tiny: cuda engine greedy-identical to cpu engine over "
        f"{len(outs['cpu'])} requests")


def check_tiny_int8():
    """The tiny model with int8 KV (page 16, the int8 kernel at hd 16,
    group 16) on the card vs on the CPU: greedy tokens equal except at a
    CPU near-tie, and a seeded temperature-0.8 stream drawn identically
    (threefry on both devices)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd

    cfg = ModelConfig.tiny(dtype="float32")
    ecfg = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                max_decode_slots=4, prefill_buckets=(32, 64),
                cache_dtype="float32", kv_quant="int8")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)]
    params = llama.init_params(cfg, SEED, device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in params.items()}
        eng = TorchEngine(cfg, EngineConfig(**ecfg), params=p, device=dev)
        if dev == "cuda":
            fd.executed(eng.device, reset=True)

        async def drive():
            greedy = await generate_all(eng, prompts, 12, logprobs=2)
            greedy.append((await generate_all(eng, prompts[:1], 12,
                                              logprobs=2))[0])
            seeded = (await generate_all(eng, prompts[1:2], 24,
                                         temperature=0.8, seed=7))[0]
            await eng.stop()
            return greedy, seeded

        outs[dev] = asyncio.run(drive())
        if dev == "cuda":
            # the kernel's own count on the card: the rounds are replays
            dense, int8 = fd.executed(eng.device)
            if not int8 or dense or eng.kernel_launches != int8:
                raise AssertionError(
                    f"tiny int8 engine on cuda: int8 kernel ran {int8} "
                    f"times, dense {dense}, graphs recorded "
                    f"{eng.kernel_launches}")
            check_replayed(eng, "tiny int8")
    compared = ties = 0
    for (tc, *_), (tg, fg, _, _, top) in zip(outs["cuda"][0], outs["cpu"][0]):
        if fg != "length" or len(tg) != 12 or len(tc) != 12:
            raise AssertionError(f"tiny int8: {len(tc)}/{len(tg)} tokens, "
                                 f"finish {fg}")
        for j, (a, b) in enumerate(zip(tc, tg)):
            if a != b:
                gap = top[j][0][1] - top[j][1][1]
                if gap > NEAR_TIE:
                    raise AssertionError(
                        f"tiny int8: cuda token {a} != cpu token {b} at "
                        f"step {j}, cpu top-2 gap {gap:.4f} > {NEAR_TIE}")
                ties += 1
                break  # past a divergence the streams are not comparable
            compared += 1
    seeded = {dev: o[1][0] for dev, o in outs.items()}
    if seeded["cuda"] != seeded["cpu"] or len(seeded["cpu"]) != 24:
        raise AssertionError(f"tiny int8 seeded stream: cuda "
                             f"{seeded['cuda']} != cpu {seeded['cpu']}")
    log(f"tiny int8: cuda engine agrees with cpu engine on {compared} greedy "
        f"positions ({ties} streams stop at a cpu near-tie, gap <= "
        f"{NEAR_TIE}); the seeded temperature-0.8 stream of 24 tokens is "
        f"identical on both devices")


def check_round_graph(label, cfg, ecfg, params, prompts):
    """An engine on the card admits ``prompts``; then one decode round
    replayed from its CUDA graph must give the tokens (and the state) of
    the same round run eagerly on a clone of the same device state,
    greedy and with logprobs; then torch.profiler counts the CUDA runtime
    calls of one steady pipelined round and the flash-decode kernels
    inside its replay."""
    from dynamo_tpu_torch.engine import graphs as eg
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )

    eng = TorchEngine(cfg, ecfg, params=params, device="cuda")
    # no engine loop: this thread runs the engine's steps one at a time
    # (every graph was captured with the engine)
    eng._started = True
    g = eng.graphs
    B, F = ecfg.max_decode_slots, ecfg.flush_every
    ran = [0, 0]  # the kernel's own count over the profiled round

    async def consume(p):
        req = PreprocessedRequest(
            token_ids=list(p),
            stop_conditions=StopConditions(max_tokens=64, ignore_eos=True))
        async for _ in eng.generate(req):
            pass

    def compare(want_lp):
        ctx = {k: v.clone() for k, v in eng.ctx.items()}
        ring = {k: v.clone() for k, v in eng.ring.items()}
        dev = {k: v.clone() for k, v in eng._dev.items()}
        out = {k: v.clone() for k, v in g.out.items()}
        eg.run_round(cfg, ecfg, params, ctx, ring, eng.cache, dev, out,
                     False, want_lp)
        g.round(False, want_lp, None)
        torch.cuda.synchronize()
        if not torch.equal(out["toks"], g.out["toks"]):
            raise AssertionError(
                f"round_graph {label}: replayed tokens {g.out['toks']} != "
                f"eager {out['toks']}")
        def live(t):  # the slots' own lanes, not the scratch lane
            return t[:, :, :B] if t.dim() == 5 else t[:, :B]

        same = all(torch.equal(dev[k], eng._dev[k]) for k in dev) and all(
            torch.equal(live(ctx[k]), live(eng.ctx[k])) for k in ctx)
        if not same:
            raise AssertionError(f"round_graph {label}: the replayed round "
                                 f"left another state than the eager one")
        return ((out["lp"] - g.out["lp"]).abs().max().item()
                if want_lp else None)

    async def drive():
        tasks = [asyncio.ensure_future(consume(p)) for p in prompts]
        while eng._intake.qsize() < len(prompts):
            await asyncio.sleep(0)
        eng._drain_intake()
        for _ in range(200):
            if not (eng._waiting or eng._prefilling):
                break
            eng._admit()
        eng._flush_seals()
        if int(eng._slot_active.sum()) != len(prompts):
            raise AssertionError(f"round_graph {label}: prompts not admitted")
        compare(False)
        lp_diff = compare(True)
        # steady pipelined rounds through the engine's own round
        for _ in range(3):
            eng._round()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        dispatched = eng.pipeline_stats()["pipelined_dispatches"]
        fd.executed(eng.device, reset=True)
        with torch.profiler.profile(activities=acts) as prof:
            eng._round()
            torch.cuda.synchronize()
        ran[:] = fd.executed(eng.device)
        if eng.pipeline_stats()["pipelined_dispatches"] != dispatched + 1:
            raise AssertionError(f"round_graph {label}: the profiled round "
                                 f"was not dispatched early")
        for t in tasks:
            t.cancel()
        return lp_diff, prof

    lp_diff, prof = asyncio.run(drive())
    runtime: dict[str, int] = defaultdict(int)
    kernels = 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if "flash_decode" in evt.key and "combine" not in evt.key:
                kernels += evt.count
        elif evt.key.startswith("cuda"):
            runtime[evt.key] += evt.count
    graph_launches = sum(n for k, n in runtime.items() if "GraphLaunch" in k)
    host_kernels = sum(n for k, n in runtime.items() if "LaunchKernel" in k)
    copies = sum(n for k, n in runtime.items() if "Memcpy" in k)
    want_kernels = cfg.num_layers * F
    log(f"round_graph {label}: replayed round == eager round (tokens and "
        f"state, greedy and with logprobs; largest logprob difference "
        f"{lp_diff:.3e}); one steady pipelined round: {graph_launches} graph "
        f"launch, {host_kernels} kernels launched from the host, {copies} "
        f"copies, {kernels} flash-decode kernels in the replay "
        f"({cfg.num_layers} layers x {F} steps = {want_kernels}; the "
        f"kernel's own count on the card {sum(ran)}); runtime calls "
        f"{dict(sorted(runtime.items()))}")
    log(f"round_graph {label}: captures " + ", ".join(
        f"{k} {t:.3f} s ({g.recorded[k]} flash-decode launches recorded)"
        for k, t in g.capture_s.items())
        + f"; graph pool {g.pool_bytes / 2**20:.1f} MiB")
    if (graph_launches != 1 or host_kernels or kernels != want_kernels
            or sum(ran) != want_kernels):
        raise AssertionError(
            f"round_graph {label}: a steady round must be one graph launch "
            f"with {want_kernels} flash-decode kernels inside and no kernel "
            f"launched from the host")
    del eng, g
    gc.collect()
    torch.cuda.empty_cache()


def time_block_hashes(prompts, page):
    """The router's block hashing (the port's own XXH3-64) on this
    machine's host: microseconds per block of ``page`` tokens."""
    from dynamo_tpu_torch.tokens import compute_block_hashes

    reps = 20
    n = reps * sum(len(p) // page for p in prompts)
    t0 = time.perf_counter()
    for _ in range(reps):
        for p in prompts:
            compute_block_hashes(p, page, "meta-llama/Llama-3.1-8B")
    us = (time.perf_counter() - t0) / n * 1e6
    log(f"host: block hash (xxh3_64, page {page} = {8 + 4 * page} bytes) "
        f"{us:.1f} us per block over {n} blocks")


class IntakeGate:
    """Holds an engine's intake until ``n`` requests wait in it. A burst's
    prefill groups (and with them the prefill numerics: a group of one
    takes another path than a batch) then do not depend on when each
    request arrived, so the serve and http phases admit the same prompts
    in the same order and groups, and their greedy tokens can be held
    equal."""

    def __init__(self, eng, n):
        self.eng, self.n, self.open = eng, n, False
        self._drain = eng._drain_intake
        eng._drain_intake = self.drain

    def drain(self):
        if not self.open:
            if self.eng._intake.qsize() < self.n:
                return
            self.open = True
        self._drain()


def serve_llama3_8b(counts, params, kv_quant, dense_tokens=None):
    """The serve burst on Llama-3.1-8B with the given weights and KV mode;
    returns each request's tokens (the burst's 8, then the repeat) and the
    burst's figures (TTFT and gaps in s, decode tok/s)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd

    cfg = ModelConfig.llama3_8b()
    quant = kv_quant == "int8"
    name = "flash_decode_int8" if quant else "flash_decode"
    t0 = time.monotonic()
    eng = TorchEngine(cfg, EngineConfig(kv_quant=kv_quant), params=params,
                      device="cuda")
    torch.cuda.synchronize()
    if quant and not (eng.ctx["k"].dtype == eng.cache["k"].dtype
                      == torch.int8):
        raise AssertionError("int8 engine: ctx or pool is not int8")
    log(f"serve {kv_quant}: Llama-3.1-8B engine built in "
        f"{time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated "
        f"(ctx {eng.ctx['k'].dtype}, pool {eng.cache['k'].dtype})")
    prompts = serve_prompts(cfg.vocab_size)
    n_new = 32

    async def drive():
        t_start = time.monotonic()
        res = await generate_all(eng, prompts, n_new)
        t_batch = time.monotonic() - t_start
        repeat = (await generate_all(eng, prompts[:1], n_new))[0]
        await eng.stop()
        return res, repeat, t_batch

    steps0 = eng.step_count
    # every kernel count to 0 just before the main path
    fd.launches = fd.launches_int8 = 0
    eng.kernel_launches = 0
    fd.executed(eng.device, reset=True)
    IntakeGate(eng, len(prompts))
    res, repeat, t_batch = asyncio.run(drive())
    # every round replays a graph captured with the engine, so the
    # wrapper issues nothing here: the kernel counts its executions on the
    # card, and the engine the launches its graphs recorded at capture
    # once a replay (the cross-check)
    ran = fd.executed(eng.device)
    launched, other = (ran[1], ran[0]) if quant else ran
    issued = fd.launches + fd.launches_int8
    counts[name] = launched
    steps = eng.step_count - steps0
    for toks, finish, *_ in res + [repeat]:
        if len(toks) != n_new or finish != "length":
            raise AssertionError(f"request ended with {len(toks)} tokens, "
                                 f"finish {finish}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError("token out of the vocabulary")
    cached = repeat[2]["cached_blocks"]
    want_cached = (len(prompts[0]) - 1) // eng.ecfg.page_size
    if cached != want_cached:
        raise AssertionError(f"prefix repeat hit {cached} blocks, "
                             f"expected {want_cached}")
    check_replayed(eng, f"serve {kv_quant}")
    if launched != cfg.num_layers * steps:
        raise AssertionError(
            f"{name} ran {launched} times on the card over {steps} decode "
            f"steps of {cfg.num_layers} layers")
    if eng.kernel_launches != launched or issued:
        raise AssertionError(
            f"serve {kv_quant}: the graphs recorded {eng.kernel_launches} "
            f"launches and the wrapper issued {issued}, the card ran "
            f"{launched}")
    if other:
        raise AssertionError(f"serve {kv_quant}: the other mode's kernel "
                             f"launched {other} times")
    ttft = [a["timing"]["ttft_s"] for _, _, a, *_ in res]
    e2e = [a["timing"]["e2e_s"] for _, _, a, *_ in res]
    gaps = [g for _, _, _, gs, _ in res for g in gs]
    decode_tokens = sum(len(t) - 1 for t, *_ in res)
    decode_tps = decode_tokens / (max(e2e) - min(ttft))
    log(f"serve {kv_quant}: 8 requests x {n_new} tokens (prompts "
        f"{min(map(len, prompts))}..{max(map(len, prompts))}) in "
        f"{t_batch:.3f} s; TTFT median {np.median(ttft):.4f} s max "
        f"{max(ttft):.4f} s; inter-token gap median "
        f"{np.median(gaps) * 1e3:.2f} ms max {max(gaps) * 1e3:.2f} ms (a "
        f"round's gap spread over its tokens); decode {decode_tps:.1f} "
        f"tok/s over the batch (tokens after the first / span from first "
        f"first-token to last finish); {steps} decode steps, {name} "
        f"launches {launched} (counted by the kernel on the card) in "
        f"{eng.graphs.replays} graph replays, {eng.kernel_launches} by the "
        f"graphs' records at capture, {issued} issued eagerly")
    log(f"serve {kv_quant}: pipeline {eng.pipeline_stats()}; dispatches "
        f"{eng.dispatch_counts}; captures " + ", ".join(
            f"{k} {t:.3f} s" for k, t in eng.graphs.capture_s.items())
        + f"; graph pool {eng.graphs.pool_bytes / 2**20:.1f} MiB")
    log(f"serve {kv_quant}: prefix repeat hit {cached} cached blocks, TTFT "
        f"{repeat[2]['timing']['ttft_s']:.4f} s")
    tokens = [t for t, *_ in res + [repeat]]
    figures = dict(ttft=ttft, gaps=gaps, tps=decode_tps)
    if dense_tokens is not None:
        same = sum(a == b for x, y in zip(tokens, dense_tokens)
                   for a, b in zip(x, y))
        total = sum(len(x) for x in tokens)
        # the step at which each stream first leaves the dense one
        split = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                      len(x)) for x, y in zip(tokens, dense_tokens)]
        log(f"serve {kv_quant}: {same}/{total} = {same / total:.4f} of the "
            f"token positions agree with the dense run (greedy, random "
            f"weights: a stream that leaves the dense one at a near-tie "
            f"stays apart); first differing step per request {split} "
            f"({n_new} = never)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, figures


def frontend_us_per_token(chain, prompts, streams, stream, reps=3):
    """The frontend's host time per streamed token: ``streams`` (each
    prompt's tokens) replayed through ``chain``'s preprocessor and backend
    behind an HttpService and the port's client, from an engine that only
    yields them (the first token alone, then 4 a round, as the engine
    emits them); the whole burst's wall time over its tokens, median of
    ``reps``. ``stream(client, prompt, model)`` sends one request."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelChain, ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.protocols.common import FinishReason, LLMEngineOutput

    by_prompt = {tuple(p): s for p, s in zip(prompts, streams)}

    class Replay:
        async def generate(self, req):
            toks = by_prompt[tuple(req.token_ids)]
            for chunk in [toks[:1]] + [toks[i:i + 4]
                                       for i in range(1, len(toks), 4)]:
                await asyncio.sleep(0)
                yield LLMEngineOutput(token_ids=chunk)
            yield LLMEngineOutput(finish_reason=FinishReason.LENGTH)

    manager = ModelManager()
    manager.register(ModelChain(name="replay",
                                preprocessor=chain.preprocessor,
                                engine=Replay(), backend=chain.backend))

    async def burst():
        svc = HttpService(manager, host="127.0.0.1", port=0)
        await svc.start()
        try:
            walls = []
            for _ in range(reps):
                clients = [HttpClient("127.0.0.1", svc.port) for _ in prompts]
                t0 = time.perf_counter()
                await asyncio.gather(*[stream(c, p, "replay")
                                       for c, p in zip(clients, prompts)])
                walls.append(time.perf_counter() - t0)
                for c in clients:
                    await c.close()
            return float(np.median(walls))
        finally:
            await svc.stop()

    return asyncio.run(burst()) / sum(map(len, streams)) * 1e6


def check_http(params, direct_tokens, direct):
    """The port's entry point at Llama-3.1-8B: launch.run's chain (dense
    KV, default EngineConfig, the serve phase's weights) behind the
    port's HttpService on 127.0.0.1, driven by the port's HTTP client:
    the serve phase's 8 prompts as streamed greedy /v1/completions
    requests (token ids, 32 tokens, nvext.ignore_eos), sent in prompt
    order behind an intake gate as the serve phase admitted them. Every
    stream must end in [DONE] with finish_reason length, its text must
    map back to the serve phase's tokens, and the kernel's own count on
    the card must rise by layers x decode steps (returned as the
    launches of the http path). A unary chat request runs before the
    burst, /metrics after it. Prints TTFT, gaps and tok/s beside the
    serve phase's, each request's TTFT split at the engine's intake and
    its first output, the frontend's host time per streamed token (the
    same streams replayed through the service from an engine that only
    yields them) and DecodeStream's cost per token."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.protocols.sse import SseDecoder
    from dynamo_tpu_torch.tokenizer import DecodeStream, make_test_tokenizer

    cfg = ModelConfig.llama3_8b()
    # one word per id: a text maps back to its ids (0-2 decode to nothing)
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    args = launch.build_parser().parse_intermixed_args(
        ["in=http", "out=torch", "--model-config", "llama3_8b",
         "--model-name", "llama3_8b"])
    t0 = time.monotonic()
    _, chain = launch.build_chain(args, params=params, tokenizer=tok)
    eng = chain.engine
    log(f"http: launch.run chain built in {time.monotonic() - t0:.1f} s "
        f"(TorchEngine on {eng.device}, kv_quant {eng.ecfg.kv_quant}, "
        f"{eng.ecfg.max_decode_slots} slots)")
    manager = ModelManager()
    manager.register(chain)
    prompts = serve_prompts(cfg.vocab_size)
    n_new = 32
    # when each request reaches the engine and its first output reaches
    # the event loop, and the engine's own timing annotation
    marks: dict[tuple, dict] = {}
    engine_generate = eng.generate

    async def recording_generate(req):
        m = marks[tuple(req.token_ids)] = {"in": time.monotonic()}
        async for out in engine_generate(req):
            if out.token_ids and "first" not in m:
                m["first"] = time.monotonic()
            if out.finish_reason is not None:
                m["timing"] = out.annotations.get("timing", {})
            yield out

    eng.generate = recording_generate

    async def stream(client, prompt, model="llama3_8b"):
        t_send = time.monotonic()
        r = await client.request("POST", "/v1/completions", json_body={
            "model": model, "prompt": prompt, "max_tokens": n_new,
            "temperature": 0, "stream": True,
            "nvext": {"ignore_eos": True}}, stream=True)
        if r.status != 200:
            raise AssertionError(f"http: status {r.status}")
        dec, events, arrivals = SseDecoder(), [], []
        async for chunk in r.chunks():
            for ev in dec.feed(chunk):
                events.append(ev)
                arrivals.append(time.monotonic())
        return t_send, events, arrivals

    async def drive():
        svc = HttpService(manager, host="127.0.0.1", port=0)
        await svc.start()
        clients = [HttpClient("127.0.0.1", svc.port) for _ in prompts]
        try:
            # a unary chat request first: it ends before the counts are
            # zeroed (no round is dispatched once its slot is released)
            async with HttpClient("127.0.0.1", svc.port) as c:
                chat = await c.request("POST", "/v1/chat/completions",
                                       json_body={
                    "model": "llama3_8b", "max_tokens": 4,
                    "messages": [{"role": "user", "content": "t5 t6 t7"}]})
            # every kernel count to 0 just before the main path
            fd.launches = fd.launches_int8 = 0
            eng.kernel_launches = 0
            fd.executed(eng.device, reset=True)
            steps0 = eng.step_count
            gate = IntakeGate(eng, len(prompts))
            tasks = []
            for i, (c, p) in enumerate(zip(clients, prompts)):
                tasks.append(asyncio.ensure_future(stream(c, p)))
                # in prompt order, as the serve phase's burst arrived (the
                # last arrival opens the gate, and the engine may drain
                # the intake before this loop looks at it)
                t_wait = time.monotonic()
                while not gate.open and eng._intake.qsize() < i + 1:
                    if tasks[-1].done():
                        tasks[-1].result()  # its failure, if it failed
                        raise AssertionError(f"http: request {i} ended "
                                             f"before reaching the engine")
                    if time.monotonic() - t_wait > 60:
                        raise AssertionError(f"http: request {i} did not "
                                             f"reach the engine in 60 s")
                    await asyncio.sleep(0.0005)
            res = await asyncio.wait_for(asyncio.gather(*tasks), 120)
            # the counts once the engine's thread has stopped, as in serve
            await eng.stop()
            ran = fd.executed(eng.device)
            steps = eng.step_count - steps0
            async with HttpClient("127.0.0.1", svc.port) as c:
                metrics = (await c.request("GET", "/metrics")).body.decode()
            return res, ran, steps, chat, metrics
        finally:
            for c in clients:
                await c.close()
            await svc.stop()
            await eng.stop()

    eng.start()
    # a hang here prints every thread's stack and exits, within the
    # script's time limit
    faulthandler.dump_traceback_later(300, exit=True)
    try:
        res, (dense, int8), steps, chat, metrics = asyncio.run(drive())
    finally:
        faulthandler.cancel_dump_traceback_later()
    issued = fd.launches + fd.launches_int8
    ttft, gaps, firsts, ends, texts = [], [], [], [], []
    for t_send, events, arrivals in res:
        if not events or not events[-1].is_done:
            raise AssertionError("http: a stream did not end in [DONE]")
        text, last, finish = "", None, None
        for ev, t in zip(events[:-1], arrivals):
            choice = ev.json()["choices"][0]
            finish = choice["finish_reason"] or finish
            piece = choice["text"]
            if not piece:
                continue
            n = len(piece.split())  # one word per token
            if last is None:
                ttft.append(t - t_send)
                firsts.append(t)
            else:
                gaps += [(t - last) / n] * n
            last = t
            text += piece
        if finish != "length":
            raise AssertionError(f"http: finish_reason {finish!r}")
        ends.append(arrivals[-1])
        texts.append(text)
    for i, (text, want) in enumerate(zip(texts, direct_tokens)):
        got = [int(w[1:]) for w in text.split()]
        if got != [t for t in want if t > 2]:
            raise AssertionError(
                f"http: request {i} streamed {got}, the serve phase's "
                f"generate() gave {want}")
    check_replayed(eng, "http")
    if dense != cfg.num_layers * steps or int8 or issued \
            or eng.kernel_launches != dense:
        raise AssertionError(
            f"http: flash_decode ran {dense} times on the card (int8 "
            f"{int8}, {issued} issued eagerly, graphs recorded "
            f"{eng.kernel_launches}) over {steps} decode steps of "
            f"{cfg.num_layers} layers")
    if chat.status != 200 or not chat.json()["choices"]:
        raise AssertionError(f"http: chat completion status {chat.status}")
    for name in ("ttft", "itl", "e2e"):
        m = re.search(rf"^dynamo_request_{name}_seconds_count (\d+)$",
                      metrics, re.M)
        if not m or int(m.group(1)) == 0:
            raise AssertionError(f"http: /metrics has no {name} series")
    tokens = n_new * len(prompts)
    tps = (tokens - len(prompts)) / (max(ends) - min(firsts))
    # each request's TTFT split: client send -> the engine's generate()
    # (HTTP, JSON, validation, preprocessing), the engine's own TTFT
    # (intake -> first token, on its thread), and its first output -> the
    # client's first text (backend, SSE, socket, the loop's turn)
    before, engine_ttft, after = [], [], []
    for p, (t_send, _, _), t_first in zip(prompts, res, firsts):
        m = marks[tuple(p)]
        before.append(m["in"] - t_send)
        engine_ttft.append(m["timing"]["ttft_s"])
        after.append(t_first - m["first"])
    replay_us = frontend_us_per_token(chain, prompts, direct_tokens, stream)
    # DecodeStream's cost per token on these streams, this host
    reps, n = 5, 0
    t0 = time.perf_counter()
    for _ in range(reps):
        for p, want in zip(prompts, direct_tokens):
            ds = DecodeStream(tok, p)
            for t in want:
                ds.step(t)
                n += 1
    ds_us = (time.perf_counter() - t0) / n * 1e6
    log(f"http: 8 streamed /v1/completions requests x {n_new} tokens, "
        f"token-identical to the serve phase's generate() run; TTFT "
        f"median {np.median(ttft):.4f} s max {max(ttft):.4f} s (client: "
        f"send to first text; generate(): intake to first token "
        f"{np.median(direct['ttft']):.4f} s max {max(direct['ttft']):.4f} "
        f"s); inter-token gap median {np.median(gaps) * 1e3:.2f} ms max "
        f"{max(gaps) * 1e3:.2f} ms (generate(): "
        f"{np.median(direct['gaps']) * 1e3:.2f} ms, max "
        f"{max(direct['gaps']) * 1e3:.2f} ms); decode {tps:.1f} tok/s over "
        f"the batch (generate(): {direct['tps']:.1f} tok/s)")
    log(f"http: TTFT split, median (max) over the 8: send to the engine "
        f"{np.median(before) * 1e3:.2f} ({max(before) * 1e3:.2f}) ms, the "
        f"engine's intake to first token {np.median(engine_ttft):.4f} "
        f"({max(engine_ttft):.4f}) s, first output to the client's first "
        f"text {np.median(after) * 1e3:.2f} ({max(after) * 1e3:.2f}) ms")
    log(f"http: frontend host time {replay_us:.1f} us per streamed token "
        f"(the same 8 streams replayed through the service and client, "
        f"no engine; median of 3); DecodeStream.step {ds_us:.1f} us per "
        f"token; {steps} decode steps, flash_decode launches {dense} "
        f"(counted by the kernel on the card) in {eng.graphs.replays} "
        f"graph replays; unary chat 200")
    del eng, chain, manager
    gc.collect()
    torch.cuda.empty_cache()
    return dense


def check_cli():
    """The launcher as a user runs it, with no --device: it must serve a
    prompt on the card (cuda) and exit 0."""
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=text",
           "out=torch", "--model-config", "tiny", "--cache-dtype", "float32",
           "--prompt", "w1 w2 w3", "--max-tokens", "8"]
    t0 = time.monotonic()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or "on cuda" not in out.stderr:
        raise AssertionError(f"cli: exit {out.returncode}\n{out.stderr}")
    log(f"cli: {' '.join(cmd[1:])} exited 0 in "
        f"{time.monotonic() - t0:.1f} s ({out.stderr.strip().splitlines()[0]}"
        f"); printed {out.stdout.strip()!r}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dynamo_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.monotonic()
    ptxas = cuda_build.build("flash_decode")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    smem = [int(b) for b in re.findall(r"(\d+) bytes smem", ptxas)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", ptxas))
    log(f"build: flash_decode in {time.monotonic() - t0:.1f} s; " + (
        f"{len(regs)} kernels, {min(regs)}..{max(regs)} registers, up to "
        f"{max(smem)} bytes of shared memory, {spills} bytes of spills"
        if regs else "built before this run"))
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.llama3_8b()
    serve_lens = [len(p) for p in serve_prompts(cfg.vocab_size)]
    fd_report = check_flash_decode(serve_lens, quant=False)
    fd8_report = check_flash_decode(serve_lens, quant=True)
    check_tiny_engine()
    check_tiny_int8()
    from dynamo_tpu_torch.engine.config import EngineConfig

    tiny = ModelConfig.tiny(dtype="float32")
    rng = np.random.RandomState(SEED)
    check_round_graph(
        "tiny f32", tiny, EngineConfig(
            num_pages=64, page_size=16, max_pages_per_seq=8,
            max_decode_slots=4, prefill_buckets=(32, 64),
            cache_dtype="float32"),
        llama.init_params(tiny, SEED, device="cuda"),
        [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)])
    time_block_hashes(serve_prompts(cfg.vocab_size), 64)
    counts: dict[str, int] = {}
    # the 8B weights are made once and serve every 8B phase
    t0 = time.monotonic()
    params = llama.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: Llama-3.1-8B bf16 weights made on the card in "
        f"{time.monotonic() - t0:.1f} s")
    for kv_quant in ("none", "int8"):
        check_round_graph(f"Llama-3.1-8B kv_quant={kv_quant}", cfg,
                          EngineConfig(kv_quant=kv_quant), params,
                          serve_prompts(cfg.vocab_size))
    dense_tokens, direct = serve_llama3_8b(counts, params, "none")
    serve_llama3_8b(counts, params, "int8", dense_tokens)
    http_launches = check_http(params, dense_tokens[:8], direct)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    check_cli()
    print(smi)
    source = "dynamo_tpu_torch/csrc/flash_decode.cu"
    kernels = [
        dict(name="flash_decode", route="cuda", source=source,
             replaces="dynamo_tpu/ops/flash_decode.py:210",
             launches=counts["flash_decode"], launches_http=http_launches,
             **fd_report),
        dict(name="flash_decode_int8", route="cuda", source=source,
             replaces="dynamo_tpu/ops/flash_decode.py:176",
             launches=counts["flash_decode_int8"], **fd8_report),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
