"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line (any failure raises and exits non-zero):
  1. card: name and power limit (nvidia-smi);
  2. build: the serving path's CUDA kernels (the dense and int8 modes of
     flash decode; the w8a16 GEMM), compiled with nvcc from
     dynamo_tpu_torch/csrc/flash_decode.cu and w8a16_gemm.cu, one nvcc
     each, started together, with ptxas's register, shared-memory and
     spill counts;
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
     before quantization, int8 over it quantized); the w8a16 GEMM in its
     four uses (bf16 layer products, untied and tied bf16 logits, f32)
     at every Llama-3.1-8B layer weight shape at M = 1, 8, 32 (the mma
     kernel) and 64, 128, 200, 512, 1024, 2048, 4096 (the wgmma kernel of
     prefill), the lm_head at M = 1, 8, 32, 1024, the Llama-3.2-1B tied
     logits and the tiny shapes, against its plain version in f32 with the
     reference's rounding emulated (controls: one channel's scale off by
     5%, one k row zeroed), timed over weights too large for L2 beside its
     byte and tensor-core bounds, cuBLAS over a bf16 weight of the same
     shape and torch._weight_int8pack_mm where it runs on CUDA (timed
     only); and the dense logits' f32 product (aten::mm.dtype);
  4. tiny: TorchEngine on ModelConfig.tiny (f32) on the card, its rounds
     replayed CUDA graphs, must be greedy token-identical to the same
     engine on the CPU, whose rounds run eagerly (the CPU tests hold it
     against the JAX TpuEngine); with int8 KV too, where a
     greedy token may differ only at a CPU near-tie (top-2 logprob gap
     <= 0.05), and a seeded request at temperature 0.8 must draw the same
     stream on both devices; and with w8a16 weights, where every step
     must run the w8a16 kernel 7 times a layer and once for the logits;
  5. round_graph: for the tiny model (f32) and Llama-3.1-8B with dense
     and with int8 KV, and (after the http phase) with w8a16 weights, an
     engine admits the prompts, then one decode
     round replayed from its CUDA graph and the same round run eagerly
     (engine/graphs.py ``run_round``) on a clone of the same device state
     must give identical tokens, greedy and with logprobs (the largest
     logprob difference is printed); torch.profiler then counts the CUDA
     runtime calls of one steady pipelined round (one graph launch, the
     fetch copies, no kernel launched from the host) and the flash-decode
     kernels inside the replay (one a layer a step; the kernel's own
     count on the card must agree; w8a16: (7 x 32 + 1) x 4 = 900
     w8a16_gemm kernels too); each graph's capture
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
     printed beside the serve phase's, with the event loop's host time
     per streamed token (LoopMeter: its busy time at perf_counter's
     resolution and its thread's CPU clock, whose step on the host is
     printed too) and DecodeStream's cost per token;
  7b. distributed: the same burst through the distributed runtime on
     the same weights: the port's store (serve_store on 127.0.0.1, port
     0), a worker (launch.run's build_chain, registered through
     launch.run.serve_worker, the function in=endpoint runs, with
     --router-mode round_robin) and a frontend (ModelWatcher +
     HttpService), each on an event loop of its own thread, the client
     on the main thread; streamed greedy /v1/completions gated at the
     worker's intake as in the http phase. Every stream ends in [DONE]
     and maps back to the serve phase's tokens, the kernel's own count
     rises by layers x decode steps (the kernels line's
     launches_distributed), the frontend's /clear_kv_blocks fan-out
     returns the pages the worker's engine held, and a chat with tools
     and a streamed chat with nvext.annotations ["llm_metrics"] answer
     200 in the JAX package's shapes; TTFT, gaps and tok/s are printed
     beside the http and serve phases', with each loop's host time per
     streamed token (LoopMeter: frontend, worker, client);
  7c. kv router: the KV router on the same weights: the port's store, two
     workers (launch.run's build_chain sharing the one weight copy, each
     registered through launch.run.serve_worker with the launcher's
     default --router-mode kv, each on its own loop thread beside its
     engine's thread) and a frontend (ModelWatcher with
     KvRouterConfig(router_temperature=0.0) + HttpService); every request
     asks top-2 logprobs. Wave A: the serve prompts gated at both
     workers' intakes; wave C, once the frontend's indexer holds every
     sealed prompt block under its worker's lease id: the 8 one at a
     time, each to the worker that served it in wave A, the router's
     overlap the prompt's full blocks and the engine's matched blocks
     that overlap (less a last block the prefill needs); wave C': the 8
     one at a time straight to the other worker's endpoint (recomputed);
     failover: one worker shut down, a prompt it held served by the
     survivor, its blocks out of the indexer. Every stream maps back to
     the engine's tokens, which must be identical to generate() on one
     engine along the same prefill paths (each worker's wave A share as
     one gated burst, then its wave C prompts one at a time; each wave C'
     prompt alone on a cold cache; the failover prompt cold, then as a
     prefix hit), and may leave the serve phase's generate() stream (where
     pairs prefilled together) only where their top-2 swap (part_ways: a
     prompt prefilled alone, or a prefix hit that prefills only its tail,
     sums in another order; the gaps are printed); the kernel's own count
     rises by layers x the decode steps of both engines over the waves
     (the kernels line's launches_kv_router). Printed: memory
     with both workers up, wave A's TTFT, gaps and tok/s beside the http
     phase's, the matched blocks, and each prompt's TTFT in wave C
     against C' (the engine's own, intake to first token, and the
     client's);
  8. offload: the KV offload plane on Llama-3.1-8B with the same bf16
     weights, a 96-page pool (768 MiB), a 128-page G2 in pinned host
     memory and a 128-page G3 file in a temporary directory, in dense
     and in int8 KV: wave A (the serve prompts), wave B (8 prompts of
     the same lengths from seed 1, evicting most of A from HBM and A's
     oldest blocks from G2 into G3), wave C (A again), 32 greedy tokens
     a request, each wave held at the intake until all 8 wait, and G2
     and G3 must hold every block sealed so far before the next wave.
     Wave C must be token-identical to an engine whose 512-page pool
     holds everything (the G1 reference, built after the last engine is
     freed), every matchable block of C must be a G1 hit or onboarded
     with no block failing verification or recomputed, and G3 must serve
     a block of C; export_pages of 16 committed pages imported into 16
     fresh pages and exported again must be byte-equal, and
     clear_kv_blocks must return the G1 + G2 + G3 sizes before it. The
     flash-decode kernel of the mode must run on every layer of every
     decode step (the kernels line's launches_offload). A dense engine
     without tiers at 96 pages recomputes what was evicted (the
     baseline). Printed: wave C's TTFT onboarded, as G1 hits and
     recomputed, wave B's decode gap with offload on and off, host ms a
     page offloaded (on the engine's put thread: crc + copy + spill) and
     onboarded (gather + verify + H2D issue), and the D2H and H2D copies'
     GB/s;
  9. serve w8a16: the same weights quantized on the card
     (quantize_params), the serve burst and repeat again at full width
     and depth; every decode step must run both kernels on every layer
     (and the w8a16 kernel for the logits), the prefill the w8a16 kernels
     eagerly (its 7 layer products a layer on the wgmma kernel, its
     logits on the mma kernel); TTFT, gaps, tok/s and the weights' GiB
     are printed beside the dense serve's, with the share of greedy tokens equal to the
     dense run's and the first step's largest logprob difference
     (information: random weights have near-ties);
  10. cli: ``python -m dynamo_tpu_torch.launch.run in=text out=torch
     --model-config tiny --cache-dtype float32 --prompt "w1 w2 w3"
     --max-tokens 8`` in a subprocess, with no --device, and again with
     ``--quantize int8``: each must run its engine on cuda and exit 0;
     between the two, the distributed entry points in subprocesses:
     ``python -m dynamo_tpu_torch.cli cp --port 0``, two ``launch.run
     in=endpoint out=torch --model-config tiny --cache-dtype float32
     --router-mode round_robin`` workers with no --device (each must run
     on cuda) and a ``launch.run in=http --control-plane`` frontend; four
     greedy chat completions must each equal in=text's output, both
     workers must have served (each prints its count when SIGTERM stops
     it), and every process must exit 0.
Each phase prints its seconds.
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
import os
import re
import subprocess
import sys
import threading
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
# w8a16 GEMM

# kernel vs plain (f32 product with the reference's rounding emulated), per
# element: |got - want| <= atol_rel * rms(want) + rtol * |want|. bf16
# outputs: the f32 sums of kernel and plain (another order) can round to
# neighbouring bf16 values, and the product with the bf16 scale rounds
# again: two bf16 steps, 2**-6 of |want|. f32 outputs: the two summation
# orders differ by ~1e-6 of the output's scale. A scale off by 5% on one
# channel and one zeroed k row of the weight must fail both.
W8A16_BF16_TOL = (1e-4, 2.0 ** -6)
W8A16_F32_TOL = (1e-4, 1e-4)
# L2 is 50 MB: timed calls cycle over copies of the weight summing to
# at least this, so each call streams its weight from device memory as a
# layer's weight does in a decode step
COLD_BYTES = 200 * 2**20


def w8a16_want(x, q, s, out_dtype, layout):
    """The plain version on the card, in f32 with the reference's
    rounding: the f32-accumulated product (no TF32), then for a bf16
    layer product bf16(bf16(acc) * bf16(s)), else acc * s."""
    w = q.float() if layout == "kn" else q.float().t()
    acc = x.float() @ w
    if out_dtype == torch.bfloat16:
        return (acc.to(torch.bfloat16).float()
                * s.to(torch.bfloat16).float()).to(torch.bfloat16)
    return acc * s


def w8a16_excess(got, want):
    atol_rel, rtol = (W8A16_BF16_TOL if want.dtype == torch.bfloat16
                      else W8A16_F32_TOL)
    want = want.float()
    rms = want.pow(2).mean().sqrt().item()
    return ((got.float() - want).abs()
            / (atol_rel * rms + rtol * want.abs())).max().item()


def w8a16_bound_ms(M, N, K, x_bytes, out_bytes):
    """Least time of one call: the int8 weight, x and s read once and y
    written once over HBM3's rate, against 2MNK operations at the bf16
    tensor-core rate (f32 x: the f32 rate)."""
    nbytes = K * N + M * K * x_bytes + 4 * N + M * N * out_bytes
    peak = H100_BF16_FLOPS if x_bytes == 2 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 2.0 * M * N * K / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# the 8B layer products' widths: a decode step (1, 8, 32) and prefill
# rows (the serve's groups run 128..2048; 200 is ragged; 4096 a chunk at
# the largest bucket)
W8A16_LAYER_M = (1, 8, 32, 64, 128, 200, 512, 1024, 2048, 4096)
W8A16_8B_LAYERS = (("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024),
                   ("wg/wu", 4096, 14336), ("wd", 14336, 4096))
# products a layer of each shape
W8A16_PER_LAYER = {"8b wq/wo": 2, "8b wk/wv": 2, "8b wg/wu": 2, "8b wd": 1}


def w8a16_cases():
    """(label, M, K, N, layout, x dtype, out dtype): every Llama-3.1-8B
    layer weight shape at each M of ``W8A16_LAYER_M`` in bf16 (M >=
    w8a16.WGMMA_MIN_M runs the wgmma kernel, below it the mma kernel); the
    lm_head's f32 logits at M = 1, 8, 32 and 1024; the Llama-3.2-1B tied
    logits (the embedding [V, H] read as "nk") at M = 8; the tiny model's
    shapes in f32 (both layouts) and in bf16 (tails narrower than a
    128-channel tile)."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for M in W8A16_LAYER_M:
        for name, K, N in W8A16_8B_LAYERS:
            cases.append((f"8b {name}", M, K, N, "kn", bf, bf))
        if M in (1, 8, 32, 1024):
            cases.append(("8b lm_head", M, 4096, 128256, "kn", bf, f32))
    cases.append(("1b tied logits", 8, 2048, 128256, "nk", bf, f32))
    for M in (4, 37):
        for name, K, N in (("wq", 64, 64), ("wk", 64, 32), ("wg", 64, 128),
                           ("wd", 128, 64), ("lm_head", 64, 256)):
            cases.append((f"tiny {name}", M, K, N, "kn", f32, f32))
        cases.append(("tiny tied logits", M, 64, 256, "nk", f32, f32))
        cases.append(("tiny wk bf16", M, 64, 32, "kn", bf, bf))
        cases.append(("tiny lm_head bf16", M, 64, 256, "kn", bf, f32))
    return cases


def int8pack_ms(x, q, s, odt, layout):
    """One PyTorch call of the same function (``torch._weight_int8pack_mm``:
    x @ (q * s) with q as [N, K]) timed over cold weights, or None where
    it does not run on CUDA for these inputs. Timed only: the port never
    calls it."""
    if layout != "kn" or odt != torch.bfloat16:
        return None
    qt = q.t().contiguous()
    sb = s.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, qt, sb)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"kernel w8a16_gemm: torch._weight_int8pack_mm does not run on "
            f"CUDA here ({type(e).__name__}: {str(e).splitlines()[0][:120]})")
        return None
    copies = max(1, -(-COLD_BYTES // qt.numel()))
    qts = [qt] + [qt.clone() for _ in range(copies - 1)]
    # a few calls: it runs 10-1000x the kernel's time
    return cuda_time_ms(lambda i: torch._weight_int8pack_mm(
        x, qts[i % copies], sb), iters=5, warmup=1)


def check_w8a16():
    """The w8a16 kernels against their plain version on the card at every
    case of ``w8a16_cases``, with both controls failing; at the bf16
    8B/1B cases the time (over cold weights) beside the bound, the plain
    version's and cuBLAS's over a bf16 weight of the same shape (what
    dense serving pays), and ``torch._weight_int8pack_mm``'s where it
    runs on CUDA.
    Returns the kernels-line figures: sums over the 225 products of one
    Llama-3.1-8B decode step (M = 8: 32 layers x 7 + the lm_head), one
    layer's 7 products at each M of the wgmma route, and every timed
    shape."""
    from dynamo_tpu_torch.ops import w8a16

    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes, max_err = [], 0.0
    tiny = [0, 0.0]  # tiny cases checked, their largest excess
    pack_runs = True  # torch._weight_int8pack_mm, until it fails once
    # no fallback: a dtype the kernel lacks raises on the card
    try:
        w8a16.w8a16_matmul(torch.ones(8, 64, dtype=torch.float16,
                                      device="cuda"),
                           {"q": torch.ones(64, 64, dtype=torch.int8,
                                            device="cuda"),
                            "s": torch.ones(64, device="cuda")},
                           torch.float16)
        raise AssertionError("w8a16: an fp16 x did not raise")
    except ValueError:
        pass
    for br in (128, 256):
        if w8a16.kernel_smem(br) != w8a16.wgmma_smem_bytes(br):
            raise AssertionError(
                f"w8a16 wgmma BR={br}: the library's shared memory "
                f"{w8a16.kernel_smem(br)} != the wrapper's "
                f"{w8a16.wgmma_smem_bytes(br)}")
    for label, M, K, N, layout, xdt, odt in w8a16_cases():
        x = torch.randn(M, K, generator=g, device="cuda").to(xdt)
        qshape = (K, N) if layout == "kn" else (N, K)
        q = torch.randint(-127, 128, qshape, generator=g, device="cuda",
                          dtype=torch.int8)
        s = (torch.rand(N, generator=g, device="cuda") + 0.5) / (73.3 * K ** 0.5)
        w = {"q": q, "s": s}
        kind, kplan = w8a16.route(M, N, K, layout, xdt, odt,
                                  w8a16.card_clusters(x.device))
        wg0 = w8a16.launches_wgmma
        got = w8a16.w8a16_matmul(x, w, odt, layout)
        torch.cuda.synchronize()
        if w8a16.launches_wgmma - wg0 != (kind == "wgmma"):
            raise AssertionError(f"w8a16 {label} M={M}: routed {kind}, the "
                                 f"wgmma count moved by "
                                 f"{w8a16.launches_wgmma - wg0}")
        want = w8a16_want(x, q, s, odt, layout)
        if got.dtype != odt or got.shape != (M, N) or not torch.isfinite(
                got).all():
            raise AssertionError(f"w8a16 {label} M={M}: {got.dtype} "
                                 f"{tuple(got.shape)}, finite "
                                 f"{bool(torch.isfinite(got).all())}")
        excess = w8a16_excess(got, want)
        err = (got.float() - want.float()).abs().max().item()
        if not excess <= 1.0:
            raise AssertionError(
                f"w8a16 {label} M={M} ({kind} {kplan}, {layout}, x {xdt}, "
                f"out {odt}): |kernel - plain| {err:.3e} exceeds the "
                f"tolerance by a factor {excess:.3f}")
        s_bad = s.clone()
        s_bad[N // 3] *= 1.05
        q_bad = q.clone()
        if layout == "kn":
            q_bad[K // 2] = 0
        else:
            q_bad[:, K // 2] = 0
        controls = {"one channel's scale x1.05": (q, s_bad),
                    "one k row zeroed": (q_bad, s)}
        for bad, (qc, sc) in controls.items():
            if w8a16_excess(w8a16_want(x, qc, sc, odt, layout), want) <= 1.0:
                raise AssertionError(f"w8a16 {label} M={M}: the tolerance "
                                     f"cannot tell {bad}")
        del q_bad, s_bad, controls
        if xdt == torch.bfloat16:
            max_err = max(max_err, err)
        if label.startswith("tiny"):
            tiny = [tiny[0] + 1, max(tiny[1], excess)]
            del x, q, s, w, got, want
            continue
        # the 8B and 1B cases (bf16): timed
        copies = max(1, -(-COLD_BYTES // (K * N)))
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        ms = cuda_time_ms(lambda i: w8a16.w8a16_matmul(
            x, {"q": qs[i % copies], "s": s}, odt, layout), iters=50)
        del qs
        plain_ms = cuda_time_ms(lambda i: w8a16.w8a16_matmul_plain(
            x, q, s, odt, layout), iters=5, warmup=1)
        wb = (q.float() * s[:, None] if layout == "nk"
              else q.float() * s).to(torch.bfloat16)
        copies_b = max(1, -(-COLD_BYTES // (2 * K * N)))
        wbs = [wb] + [wb.clone() for _ in range(copies_b - 1)]
        # cuBLAS over a bf16 weight of this shape, the same layout
        # (the tied logits read the [V, H] table transposed)
        lib_ms = cuda_time_ms(lambda i: torch.matmul(
            x, wbs[i % copies_b] if layout == "kn"
            else wbs[i % copies_b].t()), iters=50)
        del wb, wbs
        pack_ms = int8pack_ms(x, q, s, odt, layout) if pack_runs else None
        if pack_ms is None and layout == "kn" and odt == torch.bfloat16:
            pack_runs = False
        bound, by = w8a16_bound_ms(M, N, K, 2, odt.itemsize)
        tc_ms = 2.0 * M * N * K / H100_BF16_FLOPS * 1e3
        shapes.append(dict(shape=label, M=M, K=K, N=N, kernel=kind,
                           plan=list(kplan), ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=by, tc_bound_ms=tc_ms,
                           library_ms=lib_ms, int8pack_ms=pack_ms))
        extra = (f"; _weight_int8pack_mm {pack_ms:.4f} ms"
                 if pack_ms is not None else "")
        log(f"kernel w8a16_gemm {label} M={M} K={K} N={N} ({layout}, out "
            f"{str(odt)[6:]}, {kind} {kplan}): agrees with plain, at "
            f"{excess:.3f} of the tolerance; the controls fail it; "
            f"{ms:.4f} ms/call (plain {plain_ms:.4f} ms, cuBLAS bf16 "
            f"{lib_ms:.4f} ms = {ms / lib_ms:.2f}x, {by} bound "
            f"{bound:.4f} ms, {bound / ms:.2f} of it; tensor-core bound "
            f"{tc_ms:.4f} ms, {tc_ms / ms:.2f} of it){extra}")
        del x, q, s, w, got, want
    torch.cuda.empty_cache()
    log(f"kernel w8a16_gemm tiny shapes: {tiny[0]} cases (M = 4 and 37; "
        f"f32 in both layouts, bf16 narrower than a tile) agree with plain, "
        f"at most {tiny[1]:.3f} of the tolerance; the controls fail each")
    # one 8B decode step's 225 products at M = 8
    per_step = {k: 32 * v for k, v in W8A16_PER_LAYER.items()}
    per_step["8b lm_head"] = 1
    step = {k: sum(r[k] * per_step[r["shape"]] for r in shapes
                   if r["M"] == 8 and r["shape"] in per_step)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"kernel w8a16_gemm: one Llama-3.1-8B decode step's 225 products at "
        f"M = 8: {step['ms']:.4f} ms (bytes bound {step['bound_ms']:.4f} ms; "
        f"cuBLAS over bf16 weights {step['library_ms']:.4f} ms; plain "
        f"{step['plain_ms']:.4f} ms)")
    # one layer's 7 prefill products at each M of the wgmma route
    prefill = {}
    for M in W8A16_LAYER_M:
        rows = [r for r in shapes if r["M"] == M
                and r["shape"] in W8A16_PER_LAYER]
        if not rows or rows[0]["kernel"] != "wgmma":
            continue
        layer = {k: sum(r[k] * W8A16_PER_LAYER[r["shape"]] for r in rows)
                 for k in ("ms", "tc_bound_ms", "library_ms")}
        prefill[M] = layer
        log(f"kernel w8a16_gemm: one Llama-3.1-8B layer's 7 products at "
            f"M = {M}: {layer['ms']:.4f} ms (tensor-core bound "
            f"{layer['tc_bound_ms']:.4f} ms, {layer['tc_bound_ms'] / layer['ms']:.2f} "
            f"of it; cuBLAS over bf16 weights {layer['library_ms']:.4f} ms, "
            f"{layer['ms'] / layer['library_ms']:.2f}x)")
    return dict(step, bound_by="bytes", max_abs_err=max_err,
                prefill_layer=prefill, shapes=shapes)


def check_logits_f32():
    """A dense bf16 model's logits product (llama.matmul_f32, the f32
    cuBLAS product of bf16 operands: the reference's
    preferred_element_type=f32) at the 8B lm_head shape, untied and tied
    (the table transposed): against the f32 product of the widened
    operands, per element 1e-5 of the logits' scale."""
    from dynamo_tpu_torch.models import llama

    g = torch.Generator(device="cuda").manual_seed(SEED)
    h = torch.randn(8, 4096, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(4096, 128256, generator=g, device="cuda")
         * 0.02).to(torch.bfloat16)
    for label, wt in (("untied", w), ("tied", w.t().contiguous().t())):
        got = llama.matmul_f32(h, wt)
        want = h.float() @ wt.float()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if got.dtype != torch.float32 or not err <= 1e-5 * scale:
            raise AssertionError(f"logits f32 {label}: {got.dtype}, |got - "
                                 f"want| {err:.3e} against {scale:.3e}")
        ms = cuda_time_ms(lambda i: llama.matmul_f32(h, wt), iters=20)
        log(f"logits f32 ({label}, 8B lm_head, aten::mm.dtype): equals the "
            f"f32 product within {err / scale:.2e} of max |logit|; "
            f"{ms:.4f} ms/call")


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
        eng = TorchEngine(cfg, EngineConfig(**ecfg),
                          params=to_device(params, dev), device=dev)
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
        eng = TorchEngine(cfg, EngineConfig(**ecfg),
                          params=to_device(params, dev), device=dev)
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
    compared, ties = compare_near_tie("tiny int8", outs["cuda"][0],
                                      outs["cpu"][0], 12)
    seeded = {dev: o[1][0] for dev, o in outs.items()}
    if seeded["cuda"] != seeded["cpu"] or len(seeded["cpu"]) != 24:
        raise AssertionError(f"tiny int8 seeded stream: cuda "
                             f"{seeded['cuda']} != cpu {seeded['cpu']}")
    log(f"tiny int8: cuda engine agrees with cpu engine on {compared} greedy "
        f"positions ({ties} streams stop at a cpu near-tie, gap <= "
        f"{NEAR_TIE}); the seeded temperature-0.8 stream of 24 tokens is "
        f"identical on both devices")


def compare_near_tie(what, cuda_res, cpu_res, n_new):
    """Greedy streams of the card's engine against the CPU engine's (each
    request's ``generate_all`` result with 2 top logprobs): equal, except
    that a stream may leave the CPU one where the CPU's top-2 logprob gap
    is at most NEAR_TIE. Returns (positions compared, streams stopped at
    a near-tie)."""
    compared = ties = 0
    for (tc, *_), (tg, fg, _, _, top) in zip(cuda_res, cpu_res):
        if fg != "length" or len(tg) != n_new or len(tc) != n_new:
            raise AssertionError(f"{what}: {len(tc)}/{len(tg)} tokens, "
                                 f"finish {fg}")
        for j, (a, b) in enumerate(zip(tc, tg)):
            if a != b:
                gap = top[j][0][1] - top[j][1][1]
                if gap > NEAR_TIE:
                    raise AssertionError(
                        f"{what}: cuda token {a} != cpu token {b} at "
                        f"step {j}, cpu top-2 gap {gap:.4f} > {NEAR_TIE}")
                ties += 1
                break  # past a divergence the streams are not comparable
            compared += 1
    return compared, ties


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def check_tiny_w8a16():
    """The tiny model with w8a16 weights (f32: the FMA instantiation of
    the w8a16 kernel, both of its uses: the layer products and the
    logits) on the card vs on the CPU (the plain version): greedy tokens
    equal except at a CPU near-tie. On the card every decode step runs
    the w8a16 kernel 7 times a layer and once for the logits inside the
    replayed rounds, and the prefill launches it eagerly; the kernel's
    own count must equal the two."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import w8a16

    cfg = ModelConfig.tiny(quant="int8", dtype="float32")
    ecfg = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                max_decode_slots=4, prefill_buckets=(32, 64),
                cache_dtype="float32")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)]
    params = llama.init_params(cfg, SEED, device="cpu")
    outs, note = {}, ""
    for dev in ("cpu", "cuda"):
        eng = TorchEngine(cfg, EngineConfig(**ecfg),
                          params=to_device(params, dev), device=dev)
        if dev == "cuda":
            w8a16.launches = 0
            w8a16.executed(eng.device, reset=True)

        async def drive():
            res = await generate_all(eng, prompts, 12, logprobs=2)
            res.append((await generate_all(eng, prompts[:1], 12,
                                           logprobs=2))[0])
            await eng.stop()
            return res

        outs[dev] = asyncio.run(drive())
        if dev == "cuda":
            ran = w8a16.executed(eng.device)
            replayed, eager = eng.graphs.w8a16_replayed, w8a16.launches
            want = (7 * cfg.num_layers + 1) * eng.step_count
            if replayed != want or not eager or ran != replayed + eager:
                raise AssertionError(
                    f"tiny w8a16 on cuda: the kernel ran {ran} times, the "
                    f"graphs recorded {replayed} over {eng.step_count} steps "
                    f"(want {want}), the prefill launched {eager}")
            check_replayed(eng, "tiny w8a16")
            note = (f"; on the card w8a16_gemm ran {ran} times ({replayed} "
                    f"in replayed rounds, {eager} in the eager prefill)")
    compared, ties = compare_near_tie("tiny w8a16", outs["cuda"],
                                      outs["cpu"], 12)
    log(f"tiny w8a16: cuda engine agrees with cpu engine on {compared} "
        f"greedy positions ({ties} streams stop at a cpu near-tie, gap <= "
        f"{NEAR_TIE}){note}")


def check_round_graph(label, cfg, ecfg, params, prompts):
    """An engine on the card admits ``prompts``; then one decode round
    replayed from its CUDA graph must give the tokens (and the state) of
    the same round run eagerly on a clone of the same device state,
    greedy and with logprobs; then torch.profiler counts the CUDA runtime
    calls of one steady pipelined round and the flash-decode kernels
    inside its replay (and, for w8a16 weights, the w8a16 GEMM kernels:
    7 a layer and the logits, a step)."""
    from dynamo_tpu_torch.engine import graphs as eg
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.ops import w8a16
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
    ran_w8 = [0]  # the w8a16 kernel's own count over it
    quant_w = cfg.quant == "int8"

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
        if quant_w:
            w8a16.executed(eng.device, reset=True)
        with torch.profiler.profile(activities=acts) as prof:
            eng._round()
            torch.cuda.synchronize()
        ran[:] = fd.executed(eng.device)
        if quant_w:
            ran_w8[0] = w8a16.executed(eng.device)
        if eng.pipeline_stats()["pipelined_dispatches"] != dispatched + 1:
            raise AssertionError(f"round_graph {label}: the profiled round "
                                 f"was not dispatched early")
        for t in tasks:
            t.cancel()
        return lp_diff, prof

    lp_diff, prof = asyncio.run(drive())
    runtime: dict[str, int] = defaultdict(int)
    kernels = gemms = 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if "flash_decode" in evt.key and "combine" not in evt.key:
                kernels += evt.count
            if "w8a16_gemm" in evt.key:
                gemms += evt.count
        elif evt.key.startswith("cuda"):
            runtime[evt.key] += evt.count
    graph_launches = sum(n for k, n in runtime.items() if "GraphLaunch" in k)
    host_kernels = sum(n for k, n in runtime.items() if "LaunchKernel" in k)
    copies = sum(n for k, n in runtime.items() if "Memcpy" in k)
    want_kernels = cfg.num_layers * F
    want_gemms = (7 * cfg.num_layers + 1) * F if quant_w else 0
    log(f"round_graph {label}: replayed round == eager round (tokens and "
        f"state, greedy and with logprobs; largest logprob difference "
        f"{lp_diff:.3e}); one steady pipelined round: {graph_launches} graph "
        f"launch, {host_kernels} kernels launched from the host, {copies} "
        f"copies, {kernels} flash-decode kernels in the replay "
        f"({cfg.num_layers} layers x {F} steps = {want_kernels}; the "
        f"kernel's own count on the card {sum(ran)})"
        + (f", {gemms} w8a16_gemm kernels in the replay ((7 x "
           f"{cfg.num_layers} + 1) x {F} = {want_gemms}; the kernel's own "
           f"count {ran_w8[0]})" if quant_w else "")
        + f"; runtime calls {dict(sorted(runtime.items()))}")
    log(f"round_graph {label}: captures " + ", ".join(
        f"{k} {t:.3f} s ({g.recorded[k]} flash-decode"
        + (f", {g.recorded_w8a16[k]} w8a16_gemm" if quant_w else "")
        + " launches recorded)" for k, t in g.capture_s.items())
        + f"; graph pool {g.pool_bytes / 2**20:.1f} MiB")
    if (graph_launches != 1 or host_kernels or kernels != want_kernels
            or sum(ran) != want_kernels or gemms != want_gemms
            or ran_w8[0] != want_gemms):
        raise AssertionError(
            f"round_graph {label}: a steady round must be one graph launch "
            f"with {want_kernels} flash-decode and {want_gemms} w8a16_gemm "
            f"kernels inside and no kernel launched from the host")
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
    """Holds an engine's intake (or the intakes of several engines, as
    one) until ``n`` requests wait in it. A burst's prefill groups (and
    with them the prefill numerics: a group of one takes another path
    than a batch) then do not depend on when each request arrived, so the
    serve and http phases admit the same prompts in the same order and
    groups, and their greedy tokens can be held equal."""

    def __init__(self, engines, n):
        self.engines = (list(engines) if isinstance(engines, (list, tuple))
                        else [engines])
        self.n, self.open = n, False
        for eng in self.engines:
            eng._drain_intake = self._gated(eng._drain_intake)

    def waiting(self) -> int:
        return sum(e._intake.qsize() for e in self.engines)

    def _gated(self, drain):
        def gated():
            if not self.open:
                if self.waiting() < self.n:
                    return
                self.open = True
            drain()
        return gated


def weights_gib(params) -> float:
    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        return t.numel() * t.element_size()
    return nbytes(params) / 2**30


def serve_llama3_8b(counts, params, kv_quant, dense_tokens=None, cfg=None):
    """The serve burst on Llama-3.1-8B with the given weights and KV mode
    (``cfg``: Llama-3.1-8B, or its w8a16 variant for quantized weights);
    returns each request's tokens (the burst's 8, then the repeat) and the
    burst's figures (TTFT and gaps in s, decode tok/s, weights GiB)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.ops import w8a16

    cfg = cfg or ModelConfig.llama3_8b()
    quant = kv_quant == "int8"
    quant_w = cfg.quant == "int8"
    tag = "w8a16" if quant_w else kv_quant
    name = "flash_decode_int8" if quant else "flash_decode"
    t0 = time.monotonic()
    eng = TorchEngine(cfg, EngineConfig(kv_quant=kv_quant), params=params,
                      device="cuda")
    torch.cuda.synchronize()
    if quant and not (eng.ctx["k"].dtype == eng.cache["k"].dtype
                      == torch.int8):
        raise AssertionError("int8 engine: ctx or pool is not int8")
    gib = weights_gib(params)
    log(f"serve {tag}: Llama-3.1-8B engine built in "
        f"{time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, weights "
        f"{gib:.2f} GiB (ctx {eng.ctx['k'].dtype}, pool "
        f"{eng.cache['k'].dtype})")
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
    if quant_w:
        w8a16.launches = w8a16.launches_wgmma = 0
        eng.graphs.w8a16_replayed = 0
        w8a16.executed(eng.device, reset=True)
    IntakeGate(eng, len(prompts))
    res, repeat, t_batch = asyncio.run(drive())
    # every round replays a graph captured with the engine, so the
    # wrapper issues nothing here: the kernel counts its executions on the
    # card, and the engine the launches its graphs recorded at capture
    # once a replay (the cross-check)
    ran = fd.executed(eng.device)
    gemms = w8a16.executed(eng.device) if quant_w else 0
    launched, other = (ran[1], ran[0]) if quant else ran
    issued = fd.launches + fd.launches_int8
    if not quant_w:  # the kernels line's launches: the dense-weight runs
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
    check_replayed(eng, f"serve {tag}")
    if launched != cfg.num_layers * steps:
        raise AssertionError(
            f"{name} ran {launched} times on the card over {steps} decode "
            f"steps of {cfg.num_layers} layers")
    if eng.kernel_launches != launched or issued:
        raise AssertionError(
            f"serve {tag}: the graphs recorded {eng.kernel_launches} "
            f"launches and the wrapper issued {issued}, the card ran "
            f"{launched}")
    if other:
        raise AssertionError(f"serve {tag}: the other mode's kernel "
                             f"launched {other} times")
    gemm_note = ""
    if quant_w:
        # decode: 7 products a layer and the logits a step, all inside
        # replayed graphs; prefill: the wrapper's eager launches, every
        # layer product of which (every prefill group has >= WGMMA_MIN_M
        # rows) takes the wgmma kernel and each call's logits the mma one
        replayed, eager = eng.graphs.w8a16_replayed, w8a16.launches
        wg = w8a16.launches_wgmma
        calls = eager - wg
        want = (7 * cfg.num_layers + 1) * steps
        if replayed != want or not eager or gemms != replayed + eager:
            raise AssertionError(
                f"serve {tag}: w8a16_gemm ran {gemms} times on the card; the "
                f"graphs recorded {replayed} over {steps} decode steps (want "
                f"{want}), the prefill launched {eager}")
        if not calls or wg != 7 * cfg.num_layers * calls:
            raise AssertionError(
                f"serve {tag}: the prefill launched {eager} w8a16 products, "
                f"{wg} of them on the wgmma kernel (want 7 x "
                f"{cfg.num_layers} for each of {calls} calls)")
        counts["w8a16_gemm"] = gemms
        counts["w8a16_gemm_prefill_wgmma"] = wg
        gemm_note = (f"; w8a16_gemm {gemms} (counted by the kernels on the "
                     f"card): {replayed} in the replays = (7 x "
                     f"{cfg.num_layers} + 1) x {steps} steps, {eager} in "
                     f"the eager prefill = {wg} on the wgmma kernel (7 x "
                     f"{cfg.num_layers} x {calls} calls) + {calls} logits")
    ttft = [a["timing"]["ttft_s"] for _, _, a, *_ in res]
    e2e = [a["timing"]["e2e_s"] for _, _, a, *_ in res]
    gaps = [g for _, _, _, gs, _ in res for g in gs]
    decode_tokens = sum(len(t) - 1 for t, *_ in res)
    decode_tps = decode_tokens / (max(e2e) - min(ttft))
    log(f"serve {tag}: 8 requests x {n_new} tokens (prompts "
        f"{min(map(len, prompts))}..{max(map(len, prompts))}) in "
        f"{t_batch:.3f} s; TTFT median {np.median(ttft):.4f} s max "
        f"{max(ttft):.4f} s (sorted: "
        f"{', '.join(f'{t:.3f}' for t in sorted(ttft))}); inter-token gap median "
        f"{np.median(gaps) * 1e3:.2f} ms max {max(gaps) * 1e3:.2f} ms (a "
        f"round's gap spread over its tokens); decode {decode_tps:.1f} "
        f"tok/s over the batch (tokens after the first / span from first "
        f"first-token to last finish); {steps} decode steps, {name} "
        f"launches {launched} (counted by the kernel on the card) in "
        f"{eng.graphs.replays} graph replays, {eng.kernel_launches} by the "
        f"graphs' records at capture, {issued} issued eagerly{gemm_note}")
    log(f"serve {tag}: pipeline {eng.pipeline_stats()}; dispatches "
        f"{eng.dispatch_counts}; captures " + ", ".join(
            f"{k} {t:.3f} s" for k, t in eng.graphs.capture_s.items())
        + f"; graph pool {eng.graphs.pool_bytes / 2**20:.1f} MiB")
    log(f"serve {tag}: prefix repeat hit {cached} cached blocks, TTFT "
        f"{repeat[2]['timing']['ttft_s']:.4f} s")
    tokens = [t for t, *_ in res + [repeat]]
    figures = dict(ttft=ttft, gaps=gaps, tps=decode_tps, gib=gib)
    if dense_tokens is not None:
        same = sum(a == b for x, y in zip(tokens, dense_tokens)
                   for a, b in zip(x, y))
        total = sum(len(x) for x in tokens)
        # the step at which each stream first leaves the dense one
        split = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                      len(x)) for x, y in zip(tokens, dense_tokens)]
        log(f"serve {tag}: {same}/{total} = {same / total:.4f} of the "
            f"token positions agree with the dense run (greedy, random "
            f"weights: a stream that leaves the dense one at a near-tie "
            f"stays apart); first differing step per request {split} "
            f"({n_new} = never)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, figures


N_NEW = 32  # tokens a streamed request of the http and distributed phases


async def stream_completion(client, prompt, model, label, **extra):
    """One streamed greedy /v1/completions request of the http,
    distributed and kv router phases (token ids, N_NEW tokens,
    nvext.ignore_eos, and any ``extra`` body fields): its send time, its
    SSE events and each event's arrival time."""
    from dynamo_tpu_torch.protocols.sse import SseDecoder

    t_send = time.monotonic()
    r = await client.request("POST", "/v1/completions", json_body={
        "model": model, "prompt": prompt, "max_tokens": N_NEW,
        "temperature": 0, "stream": True,
        "nvext": {"ignore_eos": True}, **extra}, stream=True)
    if r.status != 200:
        raise AssertionError(f"{label}: status {r.status}")
    dec, events, arrivals = SseDecoder(), [], []
    async for chunk in r.chunks():
        for ev in dec.feed(chunk):
            events.append(ev)
            arrivals.append(time.monotonic())
    return t_send, events, arrivals


async def gated_burst(eng, port, prompts, model, label, **extra):
    """The serve prompts as streamed requests to the HttpService on
    ``port``, sent in prompt order behind an IntakeGate on ``eng`` (an
    engine, or the list of engines a router spreads them over), as the
    serve phase's burst arrived (the last arrival opens the gate, and the
    engine may drain the intake before this loop looks at it); each
    request reaches an intake before the next is sent. Returns each
    request's (send time, events, arrivals)."""
    from dynamo_tpu_torch.frontend.http import HttpClient

    gate = IntakeGate(eng, len(prompts))
    clients = [HttpClient("127.0.0.1", port) for _ in prompts]
    try:
        tasks = []
        for i, (c, p) in enumerate(zip(clients, prompts)):
            tasks.append(asyncio.ensure_future(
                stream_completion(c, p, model, label, **extra)))
            t_wait = time.monotonic()
            while not gate.open and gate.waiting() < i + 1:
                if tasks[-1].done():
                    tasks[-1].result()  # its failure, if it failed
                    raise AssertionError(f"{label}: request {i} ended "
                                         f"before reaching the engine")
                if time.monotonic() - t_wait > 60:
                    raise AssertionError(f"{label}: request {i} did not "
                                         f"reach the engine in 60 s")
                await asyncio.sleep(0.0005)
        return await asyncio.wait_for(asyncio.gather(*tasks), 120)
    finally:
        for c in clients:
            await c.close()


def parse_streams(res, direct_tokens, label):
    """Checks and times a burst's streams: each ends in [DONE] with
    finish_reason length, and its text (one word per token id; ids 0-2
    decode to nothing) maps back to the serve phase's tokens. Returns the
    TTFTs (send to first text), the gaps (between text events, spread
    evenly over the tokens an event carries) and each stream's first and
    last arrival."""
    ttft, gaps, firsts, ends = [], [], [], []
    for i, ((t_send, events, arrivals), want) in enumerate(
            zip(res, direct_tokens)):
        if not events or not events[-1].is_done:
            raise AssertionError(f"{label}: a stream did not end in [DONE]")
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
            raise AssertionError(f"{label}: finish_reason {finish!r}")
        ends.append(arrivals[-1])
        got = [int(w[1:]) for w in text.split()]
        if got != [t for t in want if t > 2]:
            raise AssertionError(
                f"{label}: request {i} streamed {got}, the serve phase's "
                f"generate() gave {want}")
    return ttft, gaps, firsts, ends


class LoopMeter:
    """An event loop thread's host time. ``busy``: the wall time the loop
    spends outside its wait for I/O (each turn of the loop less its time
    in select; waits for the GIL count), at perf_counter's resolution.
    ``cpu``: its thread's CPU clock, whose step on this host
    cpu_clock_step_ms() gives. Made by a coroutine on the loop it
    measures; read() from any thread sees whole turns only."""

    def __init__(self):
        loop = asyncio.get_running_loop()
        self.clock = time.pthread_getcpuclockid(threading.get_ident())
        self.busy = self._wait = 0.0
        selector, run_once = loop._selector, loop._run_once
        select = selector.select

        def timed_select(timeout=None):
            t = time.perf_counter()
            try:
                return select(timeout)
            finally:
                self._wait += time.perf_counter() - t

        def timed_run_once():
            t, self._wait = time.perf_counter(), 0.0
            try:
                run_once()
            finally:
                self.busy += time.perf_counter() - t - self._wait

        selector.select = timed_select
        loop._run_once = timed_run_once

    def read(self):
        """(busy s, CPU s) so far."""
        return self.busy, time.clock_gettime(self.clock)


def cpu_clock_step_ms() -> float:
    """The step of this host's thread CPU clock: spin until it has moved
    twice and return the second move (the first may be partial)."""
    t0 = time.thread_time()
    while (t1 := time.thread_time()) == t0:
        pass
    while (t2 := time.thread_time()) == t1:
        pass
    return (t2 - t1) * 1e3


def record_marks(eng):
    """Wraps ``eng.generate`` to note, by prompt, when each request
    reaches the engine, when its first output reaches the loop that
    called generate(), the engine's own timing annotation and the blocks
    it matched at admission, the router's prefix-hit hint the request
    carried, and the tokens and top logprobs the engine gave."""
    marks: dict[tuple, dict] = {}
    engine_generate = eng.generate

    async def recording_generate(req):
        m = marks[tuple(req.token_ids)] = {
            "in": time.monotonic(), "tokens": [], "top": [],
            "hint": req.estimated_prefix_hit_num_blocks}
        async for out in engine_generate(req):
            if out.token_ids and "first" not in m:
                m["first"] = time.monotonic()
            m["tokens"].extend(out.token_ids)
            m["top"].extend(out.top_logprobs or [])
            if out.finish_reason is not None:
                m["timing"] = out.annotations.get("timing", {})
                m["cached"] = out.annotations.get("cached_blocks")
            yield out

    eng.generate = recording_generate
    return marks


def ttft_split(prompts, res, firsts, marks):
    """Each request's TTFT in three: the client's send to the engine's
    generate() (HTTP, JSON, validation, preprocessing, and any hop), the
    engine's own TTFT (intake to first token, on its thread), and its
    first output to the client's first text (backend, SSE, sockets, the
    loops' turns). Returns a line of medians and maxima."""
    before, engine_ttft, after = [], [], []
    for p, (t_send, _, _), t_first in zip(prompts, res, firsts):
        m = marks[tuple(p)]
        before.append(m["in"] - t_send)
        engine_ttft.append(m["timing"]["ttft_s"])
        after.append(t_first - m["first"])
    return (f"TTFT split, median (max) over the {len(prompts)}: send to "
            f"the engine {np.median(before) * 1e3:.2f} "
            f"({max(before) * 1e3:.2f}) ms, the engine's intake to first "
            f"token {np.median(engine_ttft):.4f} ({max(engine_ttft):.4f}) "
            f"s, first output to the client's first text "
            f"{np.median(after) * 1e3:.2f} ({max(after) * 1e3:.2f}) ms")


def frontend_us_per_token(chain, prompts, streams, reps=3):
    """The frontend's host time per streamed token: ``streams`` (each
    prompt's tokens) replayed through ``chain``'s preprocessor and backend
    behind an HttpService and the port's client, from an engine that only
    yields them (the first token alone, then 4 a round, as the engine
    emits them); the whole burst's wall time over its tokens, median of
    ``reps``."""
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
                await asyncio.gather(*[
                    stream_completion(c, p, "replay", "http replay")
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
    requests (gated_burst, checked by parse_streams: [DONE], finish_reason
    length, the serve phase's tokens), and the kernel's own count on the
    card must rise by layers x decode steps (returned as the launches of
    the http path). A unary chat request runs before the burst, /metrics
    after it. Prints TTFT, gaps and tok/s beside the serve phase's, each
    request's TTFT split at the engine's intake and its first output,
    the event loop's host time per streamed token (LoopMeter: busy and
    CPU; the loop runs service and client), the frontend's host time per
    streamed token (the same streams replayed through the service from
    an engine that only yields them) and DecodeStream's cost per token."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
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
    marks = record_marks(eng)

    async def drive():
        svc = HttpService(manager, host="127.0.0.1", port=0)
        await svc.start()
        meter = LoopMeter()
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
            host0 = meter.read()
            res = await gated_burst(eng, svc.port, prompts, "llama3_8b",
                                    "http")
            host = [b - a for a, b in zip(host0, meter.read())]
            # the counts once the engine's thread has stopped, as in serve
            await eng.stop()
            ran = fd.executed(eng.device)
            steps = eng.step_count - steps0
            async with HttpClient("127.0.0.1", svc.port) as c:
                metrics = (await c.request("GET", "/metrics")).body.decode()
            return res, ran, steps, chat, metrics, host
        finally:
            await svc.stop()
            await eng.stop()

    eng.start()
    # a hang here prints every thread's stack and exits, within the
    # script's time limit
    faulthandler.dump_traceback_later(300, exit=True)
    try:
        res, (dense, int8), steps, chat, metrics, host = asyncio.run(drive())
    finally:
        faulthandler.cancel_dump_traceback_later()
    issued = fd.launches + fd.launches_int8
    ttft, gaps, firsts, ends = parse_streams(res, direct_tokens, "http")
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
    tokens = N_NEW * len(prompts)
    tps = (tokens - len(prompts)) / (max(ends) - min(firsts))
    replay_us = frontend_us_per_token(chain, prompts, direct_tokens)
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
    log(f"http: 8 streamed /v1/completions requests x {N_NEW} tokens, "
        f"token-identical to the serve phase's generate() run; TTFT "
        f"median {np.median(ttft):.4f} s max {max(ttft):.4f} s (client: "
        f"send to first text; generate(): intake to first token "
        f"{np.median(direct['ttft']):.4f} s max {max(direct['ttft']):.4f} "
        f"s); inter-token gap median {np.median(gaps) * 1e3:.2f} ms max "
        f"{max(gaps) * 1e3:.2f} ms (generate(): "
        f"{np.median(direct['gaps']) * 1e3:.2f} ms, max "
        f"{max(direct['gaps']) * 1e3:.2f} ms); decode {tps:.1f} tok/s over "
        f"the batch (generate(): {direct['tps']:.1f} tok/s)")
    log(f"http: {ttft_split(prompts, res, firsts, marks)}")
    step_ms = cpu_clock_step_ms()
    busy_us, cpu_us = (v / tokens * 1e6 for v in host)
    log(f"http: the event loop (service and client) over the burst, per "
        f"streamed token: busy {busy_us:.2f} us (LoopMeter), CPU "
        f"{cpu_us:.2f} us (thread CPU clock, step {step_ms:.4g} ms on "
        f"this host: +-{step_ms * 1e3 / tokens:.2f} us a token); frontend "
        f"host time {replay_us:.1f} us per streamed token (the same 8 "
        f"streams replayed through the service and client, no engine; "
        f"median of 3); DecodeStream.step {ds_us:.1f} us per token; "
        f"{steps} decode steps, flash_decode launches {dense} (counted by "
        f"the kernel on the card) in {eng.graphs.replays} graph replays; "
        f"unary chat 200")
    del eng, chain, manager
    gc.collect()
    torch.cuda.empty_cache()
    return dense, dict(ttft=ttft, gaps=gaps, tps=tps, replay_us=replay_us,
                       busy_us=busy_us, cpu_us=cpu_us)


async def settle_engines(*engines):
    """Waits until every engine is idle: once the last stream ended a
    pipelined round may still be in flight; after it the kernel counts
    are final."""
    quiet = 0
    while quiet < 20:
        busy = any(eng._slot_active.any() or eng._entries or eng._waiting
                   or eng._prefilling or eng._intake.qsize()
                   for eng in engines)
        quiet = 0 if busy else quiet + 1
        await asyncio.sleep(0.01)


class LoopThread:
    """An asyncio event loop running on a thread of its own."""

    def __init__(self, name):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name=name, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        async def cancel_rest():
            rest = [t for t in asyncio.all_tasks()
                    if t is not asyncio.current_task()]
            for t in rest:
                t.cancel()
            await asyncio.gather(*rest, return_exceptions=True)

        if self.loop.is_running():
            self.run(cancel_rest(), timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def check_distributed(params, direct_tokens, direct, http):
    """The distributed runtime at Llama-3.1-8B: the port's store
    (serve_store on 127.0.0.1, port 0), a worker (launch.run's
    build_chain with the serve phase's weights, registered through
    launch.run.serve_worker, the function in=endpoint runs, on
    launch.run.connect_runtime's resyncing connection, with
    --router-mode round_robin) and a frontend (ModelWatcher +
    HttpService), each on an event loop of its own thread; the client on
    the main thread. The serve phase's 8 prompts go out as in the http
    phase (gated_burst at the worker's intake, checked by parse_streams),
    and the kernel's own count on the card must rise by layers x decode
    steps (returned as the distributed path's launches, with the
    figures); /clear_kv_blocks
    through the frontend must clear what the worker's engine held; a chat
    request with tools and a streamed one with nvext.annotations
    ["llm_metrics"] must return 200 in the JAX package's shapes. Prints
    TTFT, gaps and tok/s beside the http and serve phases', each
    request's TTFT split at the worker engine's intake and first output,
    and each loop's host time per streamed token (LoopMeter: frontend,
    worker, client)."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.protocols.sse import SseDecoder
    from dynamo_tpu_torch.runtime.store import serve_store
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    cfg = ModelConfig.llama3_8b()
    name = "llama3_8b"
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    loops = {k: LoopThread(f"{k}-loop")
             for k in ("store", "worker", "frontend")}
    faulthandler.dump_traceback_later(600, exit=True)
    try:
        server, _ = loops["store"].run(serve_store("127.0.0.1", 0))
        cp_port = server.sockets[0].getsockname()[1]
        args = launch.build_parser().parse_intermixed_args(
            ["in=endpoint", "out=torch", "--model-config", name,
             "--model-name", name, "--router-mode", "round_robin",
             "--control-plane", f"127.0.0.1:{cp_port}"])
        t0 = time.monotonic()
        _, chain = launch.build_chain(args, params=params, tokenizer=tok)
        eng = chain.engine
        marks = record_marks(eng)
        worker_rt = loops["worker"].run(launch.connect_runtime(args))
        served = loops["worker"].run(
            launch.serve_worker(args, chain, worker_rt, lease_ttl_s=10.0))
        t_worker = time.monotonic() - t0

        async def frontend_up():
            rt = await launch.connect_runtime(args)
            manager = ModelManager()
            watcher = await ModelWatcher(rt, manager, tokenizer=tok).start()
            svc = HttpService(manager, host="127.0.0.1", port=0)
            await svc.start()
            for _ in range(600):
                if manager.list_models() == [name]:
                    break
                await asyncio.sleep(0.05)
            return rt, manager, watcher, svc

        rt, manager, watcher, svc = loops["frontend"].run(frontend_up())
        if manager.list_models() != [name]:
            raise AssertionError(f"distributed: the frontend discovered "
                                 f"{manager.list_models()}")
        log(f"distributed: store on 127.0.0.1:{cp_port}, worker instance "
            f"{served.lease_id} (TorchEngine on {eng.device}) built and "
            f"registered in {t_worker:.1f} s, frontend on "
            f"127.0.0.1:{svc.port} discovered {manager.list_models()}")
        prompts = serve_prompts(cfg.vocab_size)

        async def install_meter():
            return LoopMeter()

        meters = {k: loops[k].run(install_meter())
                  for k in ("frontend", "worker")}

        async def chats():
            async with HttpClient("127.0.0.1", svc.port) as c:
                tools = await c.request("POST", "/v1/chat/completions",
                                        json_body={
                    "model": name, "max_tokens": 4,
                    "tools": [{"type": "function", "function": {
                        "name": "get_w", "parameters": {}}}],
                    "messages": [{"role": "user", "content": "t5 t6 t7"}]})
                r = await c.request("POST", "/v1/chat/completions",
                                    json_body={
                    "model": name, "max_tokens": 4, "stream": True,
                    "nvext": {"annotations": ["llm_metrics"]},
                    "messages": [{"role": "user", "content": "t8 t9"}]},
                    stream=True)
                dec, events = SseDecoder(), []
                async for chunk in r.chunks():
                    events.extend(dec.feed(chunk))
                return tools, r.status, events

        async def burst():
            meters["client"] = LoopMeter()
            # every kernel count to 0 just before the main path
            fd.launches = fd.launches_int8 = 0
            eng.kernel_launches = 0
            fd.executed(eng.device, reset=True)
            steps0 = eng.step_count
            host0 = {k: m.read() for k, m in meters.items()}
            res = await gated_burst(eng, svc.port, prompts, name,
                                    "distributed")
            host = {k: [b - a for a, b in zip(host0[k], m.read())]
                    for k, m in meters.items()}
            await settle_engines(eng)
            torch.cuda.synchronize()
            return res, fd.executed(eng.device), eng.step_count - steps0, host

        tools, llm_status, llm_events = asyncio.run(chats())
        res, (dense, int8), steps, host = asyncio.run(burst())
        issued = fd.launches + fd.launches_int8
        # /clear_kv_blocks: the frontend's remote engine fans the clear
        # out to the worker, which returns what its engine held
        held = len(eng.allocator._lru)
        remote = manager.get(name).engine
        cleared = loops["frontend"].run(remote.clear_kv_blocks())

        async def clear_http():
            async with HttpClient("127.0.0.1", svc.port) as c:
                return await c.request("POST", "/clear_kv_blocks")

        cleared_http = asyncio.run(clear_http())
        left = len(eng.allocator._lru)

        async def frontend_down():
            await svc.stop()
            await watcher.stop()
            await rt.close()

        loops["frontend"].run(frontend_down())
        loops["worker"].run(served.shutdown())
        loops["worker"].run(worker_rt.close())
        loops["worker"].run(eng.stop())

        async def store_down():
            server.close()
            await server.wait_closed()

        loops["store"].run(store_down())
    finally:
        faulthandler.cancel_dump_traceback_later()
        for lt in loops.values():
            lt.close()
    # the tool and llm_metrics requests, in the JAX package's shapes
    if tools.status != 200:
        raise AssertionError(f"distributed: tools chat status "
                             f"{tools.status}")
    tchoice = tools.json()["choices"][0]
    msg = tchoice["message"]
    if msg.get("role") != "assistant" or tchoice["finish_reason"] not in (
            "length", "stop", "tool_calls"):
        raise AssertionError(f"distributed: tools chat answered {tchoice}")
    for call in msg.get("tool_calls") or []:
        if call["type"] != "function" or not call["id"].startswith("call_") \
                or set(call["function"]) != {"name", "arguments"}:
            raise AssertionError(f"distributed: tool call {call}")
    if (tchoice["finish_reason"] == "tool_calls") != bool(
            msg.get("tool_calls")):
        raise AssertionError(f"distributed: tools chat answered {tchoice}")
    if llm_status != 200 or not llm_events or not llm_events[-1].is_done:
        raise AssertionError(f"distributed: llm_metrics stream status "
                             f"{llm_status}")
    ann = llm_events[-2].json().get("nvext", {})
    want_keys = {"prompt_tokens", "completion_tokens", "ttft_s",
                 "itl_avg_s", "itl_p50_s", "itl_p95_s"}
    if ann.get("annotation") != "llm_metrics" \
            or set(ann.get("metrics", {})) != want_keys \
            or ann["metrics"]["completion_tokens"] != 4:
        raise AssertionError(f"distributed: llm_metrics event {ann}")
    # the burst
    ttft, gaps, firsts, ends = parse_streams(res, direct_tokens,
                                             "distributed")
    check_replayed(eng, "distributed")
    if dense != cfg.num_layers * steps or int8 or issued \
            or eng.kernel_launches != dense:
        raise AssertionError(
            f"distributed: flash_decode ran {dense} times on the card (int8 "
            f"{int8}, {issued} issued eagerly, graphs recorded "
            f"{eng.kernel_launches}) over {steps} decode steps of "
            f"{cfg.num_layers} layers")
    if not held or cleared != held or left \
            or cleared_http.status != 200 \
            or cleared_http.json() != {"cleared": [name]}:
        raise AssertionError(
            f"distributed: the worker held {held} cached pages, the "
            f"frontend's clear returned {cleared} and left {left}; "
            f"/clear_kv_blocks answered {cleared_http.status} "
            f"{cleared_http.body!r}")
    tokens = N_NEW * len(prompts)
    tps = (tokens - len(prompts)) / (max(ends) - min(firsts))
    log(f"distributed: 8 streamed /v1/completions requests x {N_NEW} "
        f"tokens through store, worker and frontend, token-identical to "
        f"the serve phase's generate() run; TTFT median "
        f"{np.median(ttft):.4f} s max {max(ttft):.4f} s (http "
        f"{np.median(http['ttft']):.4f}, {max(http['ttft']):.4f}; "
        f"generate() {np.median(direct['ttft']):.4f}, "
        f"{max(direct['ttft']):.4f}); inter-token gap median "
        f"{np.median(gaps) * 1e3:.2f} ms max {max(gaps) * 1e3:.2f} ms "
        f"(http {np.median(http['gaps']) * 1e3:.2f}, "
        f"{max(http['gaps']) * 1e3:.2f}; generate() "
        f"{np.median(direct['gaps']) * 1e3:.2f}, "
        f"{max(direct['gaps']) * 1e3:.2f}); decode {tps:.1f} tok/s over "
        f"the batch (http {http['tps']:.1f}, generate() "
        f"{direct['tps']:.1f})")
    log(f"distributed: {ttft_split(prompts, res, firsts, marks)}")
    step_ms = cpu_clock_step_ms()
    us = {k: [v / tokens * 1e6 for v in h] for k, h in host.items()}
    each = "; ".join(f"{k} loop busy {b:.2f} us, CPU {c:.2f} us"
                     for k, (b, c) in us.items())
    log(f"distributed: host time per streamed token over the burst: "
        f"{each} (LoopMeter; thread CPU clock step {step_ms:.4g} ms on "
        f"this host: +-{step_ms * 1e3 / tokens:.2f} us a token); frontend "
        f"+ client busy {us['frontend'][0] + us['client'][0]:.2f} us "
        f"beside the http phase's one loop (service and client) "
        f"{http['busy_us']:.2f} us (CPU {http['cpu_us']:.2f}); "
        f"{steps} decode steps, flash_decode launches {dense} (counted by "
        f"the kernel on the card) in {eng.graphs.replays} graph replays; "
        f"/clear_kv_blocks cleared the worker's {cleared} cached pages; "
        f"tools chat 200 (finish_reason {tchoice['finish_reason']!r}), "
        f"llm_metrics {ann['metrics']}")
    del eng, chain
    gc.collect()
    torch.cuda.empty_cache()
    return dense, dict(ttft=ttft, gaps=gaps, tps=tps, us=us)


def part_ways(label, got, want):
    """Greedy streams (each request's engine tokens and its top-2
    logprobs) against the serve phase's generate() tokens for the same
    prompts. A stream whose prefill took another path (a group of one
    where the serve phase batched a pair, a prefix hit that prefills only
    the tail) sums in another order and may leave generate()'s stream
    where the two runs' top-2 swap: at the first step where they differ,
    its top-1 is its own token and its runner-up generate()'s. Returns,
    per request, None (identical) or (step, top-2 gap), and the streams
    that part otherwise (wrong blocks or state, not rounding)."""
    splits, problems = [], []
    for i, ((toks, top), w) in enumerate(zip(got, want)):
        if len(toks) != len(w):
            problems.append(f"{label}: request {i} gave {len(toks)} tokens, "
                            f"generate() {len(w)}")
            splits.append(None)
            continue
        j = next((j for j, (a, b) in enumerate(zip(toks, w)) if a != b),
                 None)
        if j is None:
            splits.append(None)
            continue
        (t1, l1), (t2, l2) = top[j][0], top[j][1]
        splits.append((j, l1 - l2))
        if t1 != toks[j] or t2 != w[j]:
            problems.append(
                f"{label}: request {i} left generate()'s stream at step {j} "
                f"({toks[j]} for {w[j]}), where its top-2 were {top[j][:2]}")
    return splits, problems


def rerun(eng, prompts, burst):
    """The prompts through ``eng.generate()`` with top-2 logprobs, greedy,
    N_NEW tokens each: as one burst behind an IntakeGate (burst=True),
    else one at a time. Returns each request's tokens."""
    async def go():
        if burst:
            IntakeGate(eng, len(prompts))
            return [t for t, *_ in await generate_all(eng, prompts, N_NEW,
                                                      logprobs=2)]
        out = []
        for p in prompts:
            out.append((await generate_all(eng, [p], N_NEW,
                                           logprobs=2))[0][0])
        return out

    return asyncio.run(go())


def describe_splits(splits):
    same = sum(s is None for s in splits)
    away = ", ".join(f"step {j} gap {g:.4f}" for j, g in
                     (s for s in splits if s is not None))
    return f"{same}/{len(splits)} identical" + (
        f" (the others part where its top-2 swap: {away})" if away else "")


def check_kv_launches(label, engines, dense, int8, issued, steps, layers):
    """The dense kernel ran on every layer of every decode step of the
    engines, inside replayed graphs (each engine's graphs recorded what
    the card ran), and nothing else launched."""
    recorded = sum(e.kernel_launches for e in engines)
    if dense != layers * steps or int8 or issued or recorded != dense:
        raise AssertionError(
            f"{label}: flash_decode ran {dense} times on the card (int8 "
            f"{int8}, {issued} issued eagerly, graphs recorded {recorded}) "
            f"over {steps} decode steps of {layers} layers")
    for i, e in enumerate(engines):
        check_replayed(e, f"{label} worker {i}")


def check_kv_router(params, direct_tokens, direct, http):
    """The KV router at Llama-3.1-8B: the port's store, two workers
    (launch.run's build_chain sharing the serve phase's weights, each
    registered through launch.run.serve_worker with the launcher's default
    --router-mode kv, each on its own loop thread with its own engine
    thread) and a frontend (ModelWatcher with KvRouterConfig(
    router_temperature=0.0) + HttpService); the client on the main thread.
    Every request asks top-2 logprobs.

    Wave A: the serve phase's 8 prompts as streamed requests, gated at
    both workers' intakes (gated_burst over both engines). Then, once the
    frontend's indexer holds every sealed prompt block under its worker's
    lease id, wave C: the 8 again, one at a time: each must go to the
    worker that served it in wave A, with the router's overlap the
    prompt's full blocks and the engine's matched blocks that overlap
    (less the last block when the prompt ends on one: a prefill needs a
    token). Wave C': the 8 one at a time straight to the other worker's
    endpoint (the frontend's RemoteWorkerEngine), which recomputes them.
    Failover: one worker shut down (its lease revoked); a prompt it held
    is served by the survivor and its blocks leave the indexer. Every
    HTTP stream maps back to the engine's tokens; every stream must be
    identical to generate() on one engine along the same prefill paths
    (the histories replayed on the survivor once the waves are counted),
    and may leave the serve phase's generate() stream only where their
    top-2 swap (part_ways). The kernel's own count must rise by layers x
    the decode steps of both engines over the waves. Prints memory with
    both workers up,
    TTFT, gaps and tok/s beside the http phase's, the matched blocks, and
    the TTFT of wave C against C' per prompt (the engine's own: intake to
    first token; and the client's)."""
    import random

    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.protocols.common import (
        OutputOptions,
        PreprocessedRequest,
        StopConditions,
    )
    from dynamo_tpu_torch.resilience.metrics import RESILIENCE
    from dynamo_tpu_torch.runtime.store import serve_store
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer
    from dynamo_tpu_torch.tokens import compute_block_hashes

    cfg = ModelConfig.llama3_8b()
    name = "llama3_8b"
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    prompts = serve_prompts(cfg.vocab_size)
    lp = {"logprobs": 2}
    problems: list[str] = []
    loops = {k: LoopThread(f"{k}-loop")
             for k in ("store", "worker0", "worker1", "frontend")}
    faulthandler.dump_traceback_later(900, exit=True)
    try:
        server, _ = loops["store"].run(serve_store("127.0.0.1", 0))
        cp_port = server.sockets[0].getsockname()[1]
        args = launch.build_parser().parse_intermixed_args(
            ["in=endpoint", "out=torch", "--model-config", name,
             "--model-name", name, "--control-plane",
             f"127.0.0.1:{cp_port}"])
        if args.router_mode != "kv":
            raise AssertionError(f"the launcher's default router mode is "
                                 f"{args.router_mode!r}")
        ps = args.page_size
        t0 = time.monotonic()
        engs, marks, chains, rts, served = [], [], [], [], []
        for k in range(2):
            # each engine captures its round graphs as it is built, before
            # the other serves anything
            _, chain = launch.build_chain(args, params=params,
                                          tokenizer=tok)
            chains.append(chain)
            engs.append(chain.engine)
            marks.append(record_marks(chain.engine))
        for k, chain in enumerate(chains):
            lt = loops[f"worker{k}"]
            rts.append(lt.run(launch.connect_runtime(args)))
            served.append(lt.run(launch.serve_worker(
                args, chain, rts[k], lease_ttl_s=10.0)))
        torch.cuda.synchronize()
        t_workers = time.monotonic() - t0
        mem = torch.cuda.memory_allocated()
        wids = [str(s.lease_id) for s in served]
        shared = all(e.params is params for e in engs)

        async def frontend_up():
            rt = await launch.connect_runtime(args)
            manager = ModelManager()
            watcher = await ModelWatcher(
                rt, manager,
                router_config=KvRouterConfig(router_temperature=0.0),
                tokenizer=tok).start()
            svc = HttpService(manager, host="127.0.0.1", port=0)
            await svc.start()
            for _ in range(600):
                push = watcher._routers.get(name)
                if push is not None and sorted(push.workers) == sorted(wids):
                    break
                await asyncio.sleep(0.05)
            return rt, manager, watcher, svc

        rt, manager, watcher, svc = loops["frontend"].run(frontend_up())
        push = watcher._routers.get(name)
        if push is None or sorted(push.workers) != sorted(wids):
            raise AssertionError(
                f"kv router: the frontend routes {name} over "
                f"{None if push is None else sorted(push.workers)}, the "
                f"workers are {wids}")
        log(f"kv router: store on 127.0.0.1:{cp_port}, workers {wids} "
            f"(TorchEngine on {engs[0].device} each, router mode "
            f"{args.router_mode!r}) built and registered in {t_workers:.1f} "
            f"s; {mem / 2**30:.2f} GiB allocated with both up (the weights "
            f"{weights_gib(params):.2f} GiB, {'one copy shared' if shared else 'NOT shared'}; "
            f"each engine's pool {engs[0].cache['k'].nbytes * 2 / 2**30:.2f} "
            f"GiB, ctx {engs[0].ctx['k'].nbytes * 2 / 2**30:.2f} GiB, graph "
            f"pool {engs[0].graphs.pool_bytes / 2**20:.1f} MiB); frontend on "
            f"127.0.0.1:{svc.port}")
        if not shared:
            problems.append("kv router: the engines copied the weights")
        # ties at temperature 0 break by the selector's draws: seeded
        push.router.scheduler.selector.rng = random.Random(SEED)
        hits: list = []
        push.router.scheduler.on_hit_rate = hits.append

        def take_marks():
            out = [dict(m) for m in marks]
            for m in marks:
                m.clear()
            return out

        def engine_streams(wave, ps_list, worker_of):
            return [(wave[worker_of[i]][tuple(p)]["tokens"],
                     wave[worker_of[i]][tuple(p)]["top"])
                    for i, p in enumerate(ps_list)]

        # every kernel count to 0 just before the main path
        fd.launches = fd.launches_int8 = 0
        for e in engs:
            e.kernel_launches = 0
        fd.executed(engs[0].device, reset=True)
        steps0 = [e.step_count for e in engs]

        # ---- wave A: the burst, gated at both intakes
        async def wave_a():
            res = await gated_burst(engs, svc.port, prompts, name,
                                    "kv router wave A", **lp)
            await settle_engines(*engs)
            return res

        res_a = asyncio.run(wave_a())
        ma = take_marks()
        worker_of = []
        for i, p in enumerate(prompts):
            ks = [k for k in range(2) if tuple(p) in ma[k]]
            if len(ks) != 1:
                raise AssertionError(f"kv router wave A: prompt {i} reached "
                                     f"workers {ks}")
            worker_of.append(ks[0])
        got_a = engine_streams(ma, prompts, worker_of)
        marks_a = {**ma[0], **ma[1]}
        ttft_a, gaps_a, firsts_a, ends_a = parse_streams(
            res_a, [t for t, _ in got_a], "kv router wave A")
        split_a, bad = part_ways("kv router wave A", got_a,
                                     direct_tokens)
        problems += bad
        tps_a = (N_NEW - 1) * len(prompts) / (max(ends_a) - min(firsts_a))
        took = [worker_of.count(k) for k in range(2)]

        # ---- the indexer holds every sealed prompt block of each worker
        want = {w: set() for w in wids}
        for i, p in enumerate(prompts):
            want[wids[worker_of[i]]].update(
                compute_block_hashes(p, ps, salt=name))

        async def indexed():
            idx = push.router.indexer
            for _ in range(1200):
                if all(want[w] <= idx._by_worker.get(w, set())
                       for w in wids):
                    return {w: len(idx._by_worker.get(w, ())) for w in wids}
                await asyncio.sleep(0.05)
            raise AssertionError(
                f"kv router: the indexer holds "
                f"{ {w: len(idx._by_worker.get(w, ())) for w in wids} } "
                f"blocks, the workers sealed "
                f"{ {w: len(want[w]) for w in wids} } prompt blocks")

        t0 = time.monotonic()
        held = loops["frontend"].run(indexed(), timeout=120)
        t_indexed = time.monotonic() - t0

        # ---- wave C: one at a time, each to its warm worker
        async def one_by_one(label):
            out = []
            async with HttpClient("127.0.0.1", svc.port) as c:
                for p in prompts:
                    out.append(await stream_completion(c, p, name, label,
                                                       **lp))
                    await settle_engines(*engs)
            return out

        del hits[:]
        res_c = asyncio.run(one_by_one("kv router wave C"))
        mc = take_marks()
        hits_c = list(hits)
        matched, matchable = [], []
        for i, p in enumerate(prompts):
            k = worker_of[i]
            m = mc[k].get(tuple(p))
            hit = hits_c[i] if i < len(hits_c) else None
            if m is None or hit is None or hit.worker_id != wids[k]:
                raise AssertionError(
                    f"kv router wave C: prompt {i} went to "
                    f"{None if hit is None else hit.worker_id}, wave A's "
                    f"worker was {wids[k]}")
            full = len(p) // ps
            can = (len(p) - 1) // ps
            if hit.overlap_blocks != full or m["hint"] != full \
                    or m["cached"] != min(hit.overlap_blocks, can):
                problems.append(
                    f"kv router wave C: prompt {i} ({len(p)} tokens): router "
                    f"overlap {hit.overlap_blocks} (hint at the worker "
                    f"{m['hint']}), the engine matched {m['cached']}, the "
                    f"prompt has {full} full blocks and {can} matchable")
            matched.append(m["cached"])
            matchable.append(can)
        got_c = engine_streams(mc, prompts, worker_of)
        ttft_c, _, _, _ = parse_streams(res_c, [t for t, _ in got_c],
                                        "kv router wave C")
        split_c, bad = part_ways("kv router wave C", got_c,
                                     direct_tokens)
        problems += bad
        eng_c = [mc[worker_of[i]][tuple(p)]["timing"]["ttft_s"]
                 for i, p in enumerate(prompts)]

        # ---- wave C': one at a time straight to the other worker
        async def straight(k, p):
            req = PreprocessedRequest(
                token_ids=list(p), model=name,
                stop_conditions=StopConditions(max_tokens=N_NEW,
                                               ignore_eos=True),
                output_options=OutputOptions(logprobs=2))
            t = time.monotonic()
            first = None
            async for out in push.workers[wids[k]].generate(req):
                if out.token_ids and first is None:
                    first = time.monotonic() - t
            await settle_engines(*engs)
            return first

        ttft_c2 = [loops["frontend"].run(straight(1 - worker_of[i], p))
                   for i, p in enumerate(prompts)]
        mc2 = take_marks()
        other = [1 - k for k in worker_of]
        got_c2 = engine_streams(mc2, prompts, other)
        split_c2, bad = part_ways("kv router wave C'", got_c2,
                                      direct_tokens)
        problems += bad
        eng_c2 = [mc2[other[i]][tuple(p)]["timing"]["ttft_s"]
                  for i, p in enumerate(prompts)]
        cached_c2 = [mc2[other[i]][tuple(p)]["cached"]
                     for i, p in enumerate(prompts)]
        if any(cached_c2):
            problems.append(f"kv router wave C': the other workers matched "
                            f"{cached_c2} blocks of prompts they never saw")

        # ---- failover: worker 0 goes; a prompt it held
        dead = 0
        i_dead = worker_of.index(dead)
        reroutes0 = RESILIENCE.get("dynamo_resilience_reroute_total")
        loops[f"worker{dead}"].run(served[dead].shutdown())
        t0 = time.monotonic()

        async def removed():
            idx = push.router.indexer
            for _ in range(600):
                if wids[dead] not in push.workers \
                        and wids[dead] not in idx._by_worker:
                    return
                await asyncio.sleep(0.02)
            raise AssertionError(
                f"kv router failover: worker {wids[dead]} still routed "
                f"({sorted(push.workers)}) or indexed "
                f"({sorted(idx._by_worker)})")

        loops["frontend"].run(removed())
        t_removed = time.monotonic() - t0
        del hits[:]

        async def failover():
            async with HttpClient("127.0.0.1", svc.port) as c:
                r = await stream_completion(c, prompts[i_dead], name,
                                            "kv router failover", **lp)
            await settle_engines(*engs)
            return r

        res_f = asyncio.run(failover())
        mf = take_marks()
        survivor = 1 - dead
        if tuple(prompts[i_dead]) not in mf[survivor] or not hits \
                or hits[-1].worker_id != wids[survivor]:
            raise AssertionError(
                f"kv router failover: prompt {i_dead} was not served by the "
                f"survivor {wids[survivor]}")
        mfd = mf[survivor][tuple(prompts[i_dead])]
        parse_streams([res_f], [mfd["tokens"]], "kv router failover")
        split_f, bad = part_ways("kv router failover",
                                     [(mfd["tokens"], mfd["top"])],
                                     [direct_tokens[i_dead]])
        problems += bad
        reroutes = RESILIENCE.get("dynamo_resilience_reroute_total") \
            - reroutes0

        # ---- the counts, once both engines idle
        loops["frontend"].run(settle_engines(*engs))
        torch.cuda.synchronize()
        dense, int8 = fd.executed(engs[0].device)
        issued = fd.launches + fd.launches_int8
        steps = sum(e.step_count - s for e, s in zip(engs, steps0))
        check_kv_launches("kv router", engs, dense, int8, issued, steps,
                          cfg.num_layers)

        # ---- the same histories through generate() on one engine: each
        # worker's wave A share as one gated burst, then its wave C
        # prompts one at a time; each wave C' prompt alone on a cold
        # cache; the failover prompt cold, then again as a prefix hit.
        # The prefill groups and cached blocks are then the waves' own,
        # so every stream must be identical
        ref = engs[survivor]
        same = {"A": 0, "C": 0, "C'": 0, "failover": 0}

        def hold(wave, i, got, want):
            if got == want:
                same[wave] += 1
            else:
                j = next(j for j, (a, b) in enumerate(zip(got, want))
                         if a != b)
                problems.append(
                    f"kv router {wave}: prompt {i} streamed {got[j]} at step "
                    f"{j} where generate() on the same prefill path gave "
                    f"{want[j]}")

        t0 = time.monotonic()
        for k in range(2):
            mine = [i for i in range(len(prompts)) if worker_of[i] == k]
            ref.clear_kv_blocks()
            a_ref = rerun(ref, [prompts[i] for i in mine], burst=True)
            c_ref = rerun(ref, [prompts[i] for i in mine], burst=False)
            for i, ta, tc in zip(mine, a_ref, c_ref):
                hold("A", i, got_a[i][0], ta)
                hold("C", i, got_c[i][0], tc)
        for i, p in enumerate(prompts):
            ref.clear_kv_blocks()
            hold("C'", i, got_c2[i][0], rerun(ref, [p], burst=False)[0])
        ref.clear_kv_blocks()
        hold("failover", i_dead, mfd["tokens"],
             rerun(ref, [prompts[i_dead]] * 2, burst=False)[1])
        take_marks()
        t_replay = time.monotonic() - t0

        async def frontend_down():
            await svc.stop()
            await watcher.stop()
            await rt.close()

        loops["frontend"].run(frontend_down())
        loops[f"worker{survivor}"].run(served[survivor].shutdown())
        for k in range(2):
            loops[f"worker{k}"].run(rts[k].close())
            loops[f"worker{k}"].run(engs[k].stop())

        async def store_down():
            server.close()
            await server.wait_closed()

        loops["store"].run(store_down())
    finally:
        faulthandler.cancel_dump_traceback_later()
        for lt in loops.values():
            lt.close()

    ratio = [a / b for a, b in zip(eng_c, eng_c2)]
    log(f"kv router wave A: 8 streamed /v1/completions (top-2 logprobs) "
        f"over 2 workers, gated at both intakes: {took[0]} and {took[1]} "
        f"requests; {describe_splits(split_a)} to the serve phase's "
        f"generate(); TTFT median {np.median(ttft_a):.4f} s max "
        f"{max(ttft_a):.4f} s (http {np.median(http['ttft']):.4f}, "
        f"{max(http['ttft']):.4f}; generate() "
        f"{np.median(direct['ttft']):.4f}, {max(direct['ttft']):.4f}); gap "
        f"median {np.median(gaps_a) * 1e3:.2f} ms max "
        f"{max(gaps_a) * 1e3:.2f} ms (http "
        f"{np.median(http['gaps']) * 1e3:.2f}, "
        f"{max(http['gaps']) * 1e3:.2f}); decode {tps_a:.1f} tok/s over "
        f"the batch (http {http['tps']:.1f}, generate() "
        f"{direct['tps']:.1f})")
    log(f"kv router wave A: "
        f"{ttft_split(prompts, res_a, firsts_a, marks_a)}")
    log(f"kv router: the indexer held every sealed prompt block "
        f"{t_indexed:.2f} s after wave A ({held} blocks by worker)")
    log(f"kv router wave C: 8 of 8 one at a time to the worker that served "
        f"them in wave A, router overlap = the engine's matched blocks: "
        f"matched {sum(matched)} of {sum(matchable)} matchable "
        f"({matched} of {matchable}); {describe_splits(split_c)}; TTFT "
        f"(client) median {np.median(ttft_c):.4f} s max {max(ttft_c):.4f} "
        f"s; engine intake to first token median {np.median(eng_c):.4f} s "
        f"max {max(eng_c):.4f} s")
    log(f"kv router wave C': 8 one at a time straight to the other "
        f"worker, recomputed (0 blocks matched); "
        f"{describe_splits(split_c2)}; TTFT (the frontend's call) median "
        f"{np.median(ttft_c2):.4f} s max {max(ttft_c2):.4f} s; engine "
        f"intake to first token median {np.median(eng_c2):.4f} s max "
        f"{max(eng_c2):.4f} s; wave C / C' engine TTFT per prompt "
        f"{', '.join(f'{r:.3f}' for r in ratio)} (median "
        f"{np.median(ratio):.3f})")
    log(f"kv router failover: worker {wids[dead]} shut down (lease revoked): "
        f"out of the router and its blocks out of the indexer "
        f"{t_removed:.3f} s later (lease-driven removal; reroutes "
        f"{int(reroutes)}); prompt {i_dead}, which it held, served by "
        f"{wids[survivor]} ({mfd['cached']} blocks matched there from wave "
        f"C'), {describe_splits(split_f)}")
    same_c2 = same["C'"]
    log(f"kv router: {steps} decode steps over both engines, flash_decode "
        f"launches {dense} (counted by the kernel on the card) = "
        f"{cfg.num_layers} x {steps}; identical to generate() on one "
        f"engine along the same prefill paths: wave A {same['A']}/8, wave "
        f"C {same['C']}/8, wave C' {same_c2}/8, failover "
        f"{same['failover']}/1 (replayed in {t_replay:.1f} s)")
    if problems:
        raise AssertionError("kv router: " + "; ".join(problems))
    del engs, chains
    gc.collect()
    torch.cuda.empty_cache()
    return dense, dict(ttft_a=ttft_a, ttft_c=ttft_c, eng_c=eng_c,
                       eng_c2=eng_c2)


def offload_prompts(vocab: int):
    """Wave B of the offload phase: 8 prompts of the serve prompts'
    lengths, from seed 1."""
    rng = np.random.RandomState(1)
    return [rng.randint(0, vocab, size=len(p)).tolist()
            for p in serve_prompts(vocab)]


def settle_offloads(eng, want_blocks, timeout_s=60.0):
    """Wait until the engine's offload queue is empty and nothing is in
    flight, with G2 and G3 holding ``want_blocks`` blocks at least."""
    t0 = time.monotonic()
    while True:
        held = len(eng.offload) + len(eng.offload.spill)
        busy = eng.offloads_pending()
        if held >= want_blocks and not busy:
            return
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(
                f"offload: G2 + G3 hold {held} blocks after {timeout_s} s "
                f"(want {want_blocks}); queue busy {bool(busy)}")
        time.sleep(0.02)


def offload_waves(eng, cfg, n_new=32):
    """Waves A (the serve prompts), B (``offload_prompts``) and C (A
    again) on ``eng``, each burst held at the intake until all 8 wait;
    with tiers, G2 and G3 must hold the blocks sealed so far before the
    next wave. Returns each wave's results (generate_all's tuples) and,
    around wave C, the G3 onboard hits and the integrity counters."""
    from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY

    waves = {}
    c_g3 = None
    before = after = None
    for name, prompts in (("A", serve_prompts(cfg.vocab_size)),
                          ("B", offload_prompts(cfg.vocab_size)),
                          ("C", serve_prompts(cfg.vocab_size))):
        if name == "C" and eng.offload is not None:
            before = KV_INTEGRITY.snapshot()
            g3_0 = eng.offload.spill.onboard_hits
        IntakeGate(eng, len(prompts))
        waves[name] = asyncio.run(generate_all(eng, prompts, n_new))
        if eng.offload is not None:
            if name == "C":
                after = KV_INTEGRITY.snapshot()
                c_g3 = eng.offload.spill.onboard_hits - g3_0
            else:
                settle_offloads(eng, eng.allocator.total_pages
                                - len(eng.allocator._free))
    for name, res in waves.items():
        for toks, finish, *_ in res:
            if len(toks) != n_new or finish != "length":
                raise AssertionError(f"offload wave {name}: a request ended "
                                     f"with {len(toks)} tokens, {finish}")
    return waves, c_g3, before, after


def check_export_import(eng, what):
    """export_pages of 16 committed pages (the most recently parked),
    imported into 16 fresh pages and exported again, must be byte-equal;
    clear_kv_blocks must return the G1 + G2 + G3 sizes before it."""
    from dynamo_tpu_torch.kv_integrity import tensor_bytes

    def raw(x):
        if hasattr(x, "scales"):
            return bytes(tensor_bytes(x.data)) + bytes(tensor_bytes(x.scales))
        return bytes(tensor_bytes(x))

    a = eng.allocator
    src = [a._registry[h].page for h in list(a._lru)[-16:]]
    dst = a.allocate(16)
    if len(src) != 16 or dst is None:
        raise AssertionError(f"{what}: no 16 committed and 16 free pages")
    t0 = time.monotonic()
    first = eng.export_pages(src)
    eng.import_pages(dst, first)
    second = eng.export_pages(dst)
    secs = time.monotonic() - t0
    a.free(dst)
    if raw(first) != raw(second) or raw(first) == raw(eng.export_pages(
            [a._registry[h].page for h in list(a._lru)[:16]])):
        raise AssertionError(f"{what}: export -> import -> export is not "
                             f"byte-equal")
    settle_offloads(eng, 0)
    sizes = (len(a._lru), len(eng.offload), len(eng.offload.spill))
    cleared = eng.clear_kv_blocks()
    if cleared != sum(sizes) or len(eng.offload) or len(eng.offload.spill):
        raise AssertionError(f"{what}: clear_kv_blocks returned {cleared}, "
                             f"tiers held G1 {sizes[0]}, G2 {sizes[1]}, G3 "
                             f"{sizes[2]}")
    log(f"offload {what}: 16 pages exported, imported and exported again "
        f"byte-equal ({secs:.3f} s for the three ops); clear_kv_blocks "
        f"dropped {cleared} = G1 {sizes[0]} + G2 {sizes[1]} + G3 "
        f"{sizes[2]}")


def check_offload(params, counts, card):
    """The offload phase: Llama-3.1-8B (the serve phase's bf16 weights)
    with a 96-page pool, a 128-page G2 and a 128-page G3 in a temporary
    directory, through waves A, B and C (``offload_waves``), in dense and
    int8 KV. Wave C must be token-identical to a G1 reference (512 pages,
    no tiers: every block of C a G1 hit), every matchable block of C a G1
    hit or onboarded with no block recomputed or failed, and G3 must
    serve a block of C; then export/import and clear_kv_blocks
    (``check_export_import``). A dense engine without tiers at 96 pages
    gives the recompute baseline. Prints wave C's TTFT by source, wave
    B's decode gap with offload on and off, host ms a page and the
    copies' GB/s, each line beside ``card`` (nvidia-smi's name and power
    limit); returns the flash-decode launches of the offload
    engines' waves (each mode's kernel on every layer of every step)."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd

    cfg = ModelConfig.llama3_8b()
    ps = EngineConfig().page_size
    matchable = [(len(p) - 1) // ps for p in serve_prompts(cfg.vocab_size)]

    def run(ecfg, label):
        t0 = time.monotonic()
        eng = TorchEngine(cfg, ecfg, params=params, device="cuda")
        torch.cuda.synchronize()
        steps0 = eng.step_count
        fd.executed(eng.device, reset=True)
        waves, c_g3, before, after = offload_waves(eng, cfg)
        ran = fd.executed(eng.device)
        steps = eng.step_count - steps0
        check_replayed(eng, f"offload {label}")
        out = dict(waves=waves, c_g3=c_g3, before=before, after=after,
                   steps=steps, ran=ran, secs=time.monotonic() - t0)
        if eng.offload is not None:
            out["stats"] = eng.transfer_stats()
            out["kv"] = eng.metrics().kv_stats
            check_export_import(eng, label)
        asyncio.run(eng.stop())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def ttft(res):
        t = [a["timing"]["ttft_s"] for _, _, a, *_ in res]
        return f"median {np.median(t):.4f} s max {max(t):.4f} s"

    def gap(res):
        return np.median([g for *_, gs, _ in res for g in gs]) * 1e3

    launches = {}
    figures = {}
    for kv_quant in ("none", "int8"):
        tmp = tempfile.mkdtemp(prefix="dynamo-torch-g3-")
        try:
            tiers = run(EngineConfig(
                kv_quant=kv_quant, num_pages=96, host_offload_pages=128,
                disk_offload_pages=128,
                disk_offload_path=os.path.join(tmp, "g3.mmap")),
                f"kv_quant={kv_quant}")
        finally:
            shutil.rmtree(tmp)
        ref = run(EngineConfig(kv_quant=kv_quant, num_pages=512),
                  f"G1 reference kv_quant={kv_quant}")
        quant = kv_quant == "int8"
        name = "flash_decode_int8" if quant else "flash_decode"
        mine, other = (tiers["ran"][1], tiers["ran"][0]) if quant \
            else tiers["ran"]
        if mine != cfg.num_layers * tiers["steps"] or other:
            raise AssertionError(
                f"offload {kv_quant}: {name} ran {mine} times (the other "
                f"mode {other}) over {tiers['steps']} steps")
        launches[name] = mine
        c_tiers = [t for t, *_ in tiers["waves"]["C"]]
        c_ref = [t for t, *_ in ref["waves"]["C"]]
        if c_tiers != c_ref:
            same = sum(a == b for x, y in zip(c_tiers, c_ref)
                       for a, b in zip(x, y))
            raise AssertionError(
                f"offload {kv_quant}: wave C differs from the G1 reference "
                f"({same} of {sum(map(len, c_ref))} tokens agree)")
        cached = [a["cached_blocks"] for _, _, a, *_ in tiers["waves"]["C"]]
        ref_cached = [a["cached_blocks"] for _, _, a, *_ in ref["waves"]["C"]]
        if cached != matchable or ref_cached != matchable:
            raise AssertionError(
                f"offload {kv_quant}: wave C matched {cached} blocks (G1 "
                f"reference {ref_cached}), want {matchable}")
        b, a = tiers["before"], tiers["after"]
        recomputed = (a["dynamo_kv_integrity_recomputed_total"]
                      - b["dynamo_kv_integrity_recomputed_total"])
        failed = a["dynamo_kv_integrity_failed_total"]
        verified = int(a["dynamo_kv_integrity_verified_total"]
                       - b["dynamo_kv_integrity_verified_total"])
        if recomputed or failed or not tiers["c_g3"]:
            raise AssertionError(
                f"offload {kv_quant}: wave C recomputed {recomputed} blocks, "
                f"{failed} failed verification, G3 served {tiers['c_g3']}")
        st = tiers["stats"]
        log(f"offload kv_quant={kv_quant}: waves A, B, C x 8 requests x 32 "
            f"tokens in {tiers['secs']:.1f} s (engine built in the time); "
            f"wave C token-identical to the G1 reference (512 pages); every "
            f"matchable block of C ({sum(matchable)}) a G1 hit or onboarded: "
            f"{st['onboard_pages']} onboarded, {tiers['c_g3']} of them "
            f"from G3, {verified} verified, 0 recomputed, 0 failed; "
            f"kv_stats {tiers['kv']}; {name} ran {mine} times on the card "
            f"= {cfg.num_layers} x {tiers['steps']} steps")
        log(f"offload kv_quant={kv_quant} ({card}): wave C TTFT onboarded "
            f"{ttft(tiers['waves']['C'])}, G1 hits {ttft(ref['waves']['C'])}"
            f"; host ms a page: offload (put thread: crc + copy into G2 "
            f"+ spill into G3) "
            f"{st['offload_host_ms_per_page']:.3f} over "
            f"{st['offload_pages']} pages, onboard (gather + verify + H2D "
            f"issue) {st['onboard_host_ms_per_page']:.3f}; D2H "
            f"{st['d2h_gb_s']:.2f} GB/s (copy stream), H2D "
            f"{st['h2d_gb_s']:.2f} GB/s")
        figures[kv_quant] = (tiers, ref)
    base = run(EngineConfig(num_pages=96), "recompute baseline")
    tiers, ref = figures["none"]
    log(f"offload dense ({card}): wave C TTFT recomputed (96 pages, no "
        f"tiers) "
        f"{ttft(base['waves']['C'])}, onboarded "
        f"{ttft(tiers['waves']['C'])}, G1 hits {ttft(ref['waves']['C'])}; "
        f"wave B decode gap median with offload on "
        f"{gap(tiers['waves']['B']):.2f} ms, off "
        f"{gap(base['waves']['B']):.2f} ms (G1 reference "
        f"{gap(ref['waves']['B']):.2f} ms)")
    counts["flash_decode_offload"] = launches["flash_decode"]
    counts["flash_decode_int8_offload"] = launches["flash_decode_int8"]


def check_cli(extra=()):
    """The launcher as a user runs it, with no --device (and ``extra``
    flags): it must serve a prompt on the card (cuda) and exit 0."""
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=text",
           "out=torch", "--model-config", "tiny", "--cache-dtype", "float32",
           "--prompt", "w1 w2 w3", "--max-tokens", "8", *extra]
    t0 = time.monotonic()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or "on cuda" not in out.stderr:
        raise AssertionError(f"cli: exit {out.returncode}\n{out.stderr}")
    log(f"cli: {' '.join(cmd[1:])} exited 0 in "
        f"{time.monotonic() - t0:.1f} s ({out.stderr.strip().splitlines()[0]}"
        f"); printed {out.stdout.strip()!r}")
    return out.stdout[:-1]


class Proc:
    """A subprocess whose merged output lines a thread collects."""

    def __init__(self, *argv):
        self.argv = argv
        self.p = subprocess.Popen(
            [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: list[str] = []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        for line in self.p.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, text, timeout=300.0):
        """The first output line holding ``text``."""
        deadline = time.monotonic() + timeout
        while True:
            hit = next((ln for ln in list(self.lines) if text in ln), None)
            if hit is not None:
                return hit
            if self.p.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"cli distributed: {' '.join(self.argv)} printed no "
                    f"{text!r} (exit {self.p.poll()}):\n"
                    + "\n".join(self.lines[-30:]))
            time.sleep(0.05)

    def stop(self, timeout=60.0):
        """SIGTERM; the exit code."""
        if self.p.poll() is None:
            self.p.terminate()
        try:
            self.p.wait(timeout)
        except subprocess.TimeoutExpired:
            self.p.kill()
            self.p.wait()
        self._t.join(10)
        return self.p.returncode


def check_cli_distributed(text_out):
    """The distributed entry points as a user runs them, in subprocesses
    on the card: ``python -m dynamo_tpu_torch.cli cp --port 0``, two
    ``launch.run in=endpoint out=torch --model-config tiny --cache-dtype
    float32 --router-mode round_robin`` workers with no --device, and one
    ``launch.run in=http --control-plane`` frontend. Four greedy chat
    completions of the cli phase's prompt must each equal what in=text
    printed (``text_out``); both workers must run on cuda and have served
    at least one (each prints its own count when SIGTERM stops it); every
    process must exit 0."""
    import socket

    from dynamo_tpu_torch.frontend.http import HttpClient

    t0 = time.monotonic()
    procs = []
    try:
        cp = Proc("dynamo_tpu_torch.cli", "cp", "--port", "0")
        procs.append(cp)
        addr = cp.wait_for("listening on").split()[-1]
        workers = [Proc("dynamo_tpu_torch.launch.run", "in=endpoint",
                        "out=torch", "--model-config", "tiny",
                        "--cache-dtype", "float32", "--router-mode",
                        "round_robin", "--model-name", "tiny",
                        "--control-plane", addr) for _ in range(2)]
        procs += workers
        for w in workers:
            if "on cuda" not in w.wait_for("TorchEngine on"):
                raise AssertionError("cli distributed: a worker is not on "
                                     "cuda")
            w.wait_for("serving dynamo/backend/generate")
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            http_port = sk.getsockname()[1]
        front = Proc("dynamo_tpu_torch.launch.run", "in=http",
                     "--control-plane", addr, "--http-host", "127.0.0.1",
                     "--http-port", str(http_port))
        procs.append(front)
        front.wait_for("dynamic frontend on")

        async def ask():
            async with HttpClient("127.0.0.1", http_port) as c:
                for _ in range(1200):
                    r = await c.request("GET", "/v1/models")
                    if [m["id"] for m in r.json()["data"]] == ["tiny"]:
                        break
                    await asyncio.sleep(0.05)
                texts = []
                for _ in range(4):
                    r = await c.request("POST", "/v1/chat/completions",
                                        json_body={
                        "model": "tiny", "max_tokens": 8, "messages": [
                            {"role": "user", "content": "w1 w2 w3"}]})
                    if r.status != 200:
                        raise AssertionError(f"cli distributed: status "
                                             f"{r.status} {r.body!r}")
                    texts.append(r.json()["choices"][0]["message"]["content"])
                return texts

        texts = asyncio.run(asyncio.wait_for(ask(), 120))
        if texts != [text_out] * 4:
            raise AssertionError(f"cli distributed: {texts}, in=text "
                                 f"printed {text_out!r}")
        served = []
        for w in workers:
            rc = w.stop()
            line = w.wait_for("served", timeout=10)
            if rc != 0:
                raise AssertionError(f"cli distributed: a worker exited "
                                     f"{rc}")
            served.append(int(line.split()[-2]))
        if sum(served) != 4 or min(served) < 1:
            raise AssertionError(f"cli distributed: the workers served "
                                 f"{served} requests")
        for p in (front, cp):
            rc = p.stop()
            if rc != 0:
                raise AssertionError(f"cli distributed: {' '.join(p.argv)} "
                                     f"exited {rc}:\n"
                                     + "\n".join(p.lines[-20:]))
    finally:
        for p in procs:
            p.stop()
    log(f"cli distributed: cli cp ({addr}), two in=endpoint workers on "
        f"cuda and in=http --control-plane in {time.monotonic() - t0:.1f} "
        f"s; 4 chat completions equal to in=text's {text_out!r}, served "
        f"{served} by the two workers; every process exited 0")


def first_step_logprob_diff(dense, quant, prompt):
    """The largest difference of the first step's logprobs (over the
    vocabulary) of ``prompt`` between Llama-3.1-8B with the dense weights
    and with their w8a16 quantization (llama.prefill of the prompt into a
    one-lane context)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    toks = torch.tensor(prompt, dtype=torch.int32, device="cuda")
    lps = []
    for cfg, params in ((ModelConfig.llama3_8b(), dense),
                        (ModelConfig.llama3_8b_int8(), quant)):
        ctx = llama.init_ctx(cfg, 1, len(prompt), torch.bfloat16, "cuda")
        logits = llama.prefill(cfg, params, ctx, toks, 0, 0, len(prompt))
        lps.append(torch.log_softmax(logits, dim=-1))
        del ctx
    return (lps[0] - lps[1]).abs().max().item()


def phase(name, fn, *args, **kw):
    """Run one phase and print its seconds."""
    t0 = time.monotonic()
    out = fn(*args, **kw)
    log(f"phase {name}: {time.monotonic() - t0:.1f} s")
    return out


def build_all():
    """Both kernel libraries, one nvcc each, started together; prints
    ptxas's registers, shared memory and spills per library."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.ops import cuda_build, w8a16

    names = ("flash_decode", "w8a16_gemm")
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(names)) as ex:
        outs = list(ex.map(cuda_build.build, names))
    secs = time.monotonic() - t0
    for name, ptxas in zip(names, outs):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", ptxas)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", ptxas))
        dyn = ("; dynamic shared memory " + ", ".join(
            f"{w8a16.smem_bytes(bm)} (mma BM {bm})" for bm in (8, 32, 64))
            + ", " + ", ".join(
                "{} (wgmma BR {}, {} stages)".format(
                    *w8a16.wgmma_smem_bytes(br)[:1], br,
                    w8a16.wgmma_smem_bytes(br)[1]) for br in (128, 256))
            + " bytes a block" if name == "w8a16_gemm" else "")
        log(f"build: {name} in {secs:.1f} s (built in parallel); " + (
            f"{len(regs)} kernels, {min(regs)}..{max(regs)} registers, up to "
            f"{max(smem, default=0)} bytes of static shared memory, {spills} "
            f"bytes of spills{dyn}" if regs else "built before this run"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase("build", build_all)
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.llama3_8b()
    serve_lens = [len(p) for p in serve_prompts(cfg.vocab_size)]
    fd_report = phase("kernels (flash_decode dense)", check_flash_decode,
                      serve_lens, quant=False)
    fd8_report = phase("kernels (flash_decode int8)", check_flash_decode,
                       serve_lens, quant=True)
    w8_report = phase("kernels (w8a16)", check_w8a16)
    phase("logits f32", check_logits_f32)
    phase("tiny", check_tiny_engine)
    phase("tiny int8", check_tiny_int8)
    phase("tiny w8a16", check_tiny_w8a16)
    from dynamo_tpu_torch.engine.config import EngineConfig

    tiny = ModelConfig.tiny(dtype="float32")
    rng = np.random.RandomState(SEED)
    phase("round_graph tiny", check_round_graph,
        "tiny f32", tiny, EngineConfig(
            num_pages=64, page_size=16, max_pages_per_seq=8,
            max_decode_slots=4, prefill_buckets=(32, 64),
            cache_dtype="float32"),
        llama.init_params(tiny, SEED, device="cuda"),
        [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)])
    time_block_hashes(serve_prompts(cfg.vocab_size), 64)
    counts: dict[str, int] = {}
    # the 8B weights are made once and serve every 8B phase; the w8a16
    # phases serve their quantization
    t0 = time.monotonic()
    params = llama.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: Llama-3.1-8B bf16 weights made on the card in "
        f"{time.monotonic() - t0:.1f} s")
    for kv_quant in ("none", "int8"):
        phase(f"round_graph 8B kv_quant={kv_quant}", check_round_graph,
              f"Llama-3.1-8B kv_quant={kv_quant}", cfg,
              EngineConfig(kv_quant=kv_quant), params,
              serve_prompts(cfg.vocab_size))
    dense_tokens, direct = phase("serve none", serve_llama3_8b, counts,
                                 params, "none")
    phase("serve int8", serve_llama3_8b, counts, params, "int8",
          dense_tokens)
    http_launches, http_figs = phase("http", check_http, params,
                                     dense_tokens[:8], direct)
    dist_launches, _ = phase("distributed", check_distributed, params,
                             dense_tokens[:8], direct, http_figs)
    kv_launches, _ = phase("kv router", check_kv_router, params,
                           dense_tokens[:8], direct, http_figs)
    phase("offload", check_offload, params, counts, smi)
    # w8a16: the same weights quantized per output channel on the card
    t0 = time.monotonic()
    qparams = llama.quantize_params(params)
    torch.cuda.synchronize()
    qcfg = ModelConfig.llama3_8b_int8()
    log(f"w8a16: quantize_params of the bf16 weights on the card in "
        f"{time.monotonic() - t0:.1f} s: {weights_gib(qparams):.2f} GiB "
        f"(bf16 {weights_gib(params):.2f} GiB)")
    lp_diff = first_step_logprob_diff(params, qparams,
                                      serve_prompts(cfg.vocab_size)[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase("round_graph 8B w8a16", check_round_graph,
          "Llama-3.1-8B w8a16 kv_quant=none", qcfg, EngineConfig(),
          qparams, serve_prompts(cfg.vocab_size))
    _, w8 = phase("serve w8a16", serve_llama3_8b, counts, qparams, "none",
                  dense_tokens, cfg=qcfg)
    log(f"serve w8a16 beside dense (same run, same prompts): TTFT median "
        f"{np.median(w8['ttft']):.4f} s max {max(w8['ttft']):.4f} s "
        f"(dense {np.median(direct['ttft']):.4f}, "
        f"{max(direct['ttft']):.4f}); gap median "
        f"{np.median(w8['gaps']) * 1e3:.2f} ms max "
        f"{max(w8['gaps']) * 1e3:.2f} ms (dense "
        f"{np.median(direct['gaps']) * 1e3:.2f}, "
        f"{max(direct['gaps']) * 1e3:.2f}); decode {w8['tps']:.1f} tok/s "
        f"(dense {direct['tps']:.1f}); weights {w8['gib']:.2f} GiB (dense "
        f"{direct['gib']:.2f}); the first step's largest logprob "
        f"difference to the dense weights (prompt 0) {lp_diff:.4f} "
        f"(information: random weights, quantized)")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    text_out = phase("cli", check_cli)
    phase("cli distributed", check_cli_distributed, text_out)
    phase("cli w8a16", check_cli, ["--quantize", "int8"])
    log(f"chip_smoke: {time.monotonic() - t_start:.1f} s in all")
    print(smi)
    source = "dynamo_tpu_torch/csrc/flash_decode.cu"
    kernels = [
        dict(name="flash_decode", route="cuda", source=source,
             replaces="dynamo_tpu/ops/flash_decode.py:210",
             launches=counts["flash_decode"], launches_http=http_launches,
             launches_distributed=dist_launches,
             launches_kv_router=kv_launches,
             launches_offload=counts["flash_decode_offload"], **fd_report),
        dict(name="flash_decode_int8", route="cuda", source=source,
             replaces="dynamo_tpu/ops/flash_decode.py:176",
             launches=counts["flash_decode_int8"],
             launches_offload=counts["flash_decode_int8_offload"],
             **fd8_report),
        # no Pallas kernel: XLA's fused convert + dot of _mm and the
        # quantized _logits; the figures are one 8B decode step's 225
        # products at M = 8, per shape under "shapes"
        dict(name="w8a16_gemm", route="cuda",
             source="dynamo_tpu_torch/csrc/w8a16_gemm.cu",
             replaces="dynamo_tpu/models/llama.py:409",
             launches=counts["w8a16_gemm"],
             launches_prefill_wgmma=counts["w8a16_gemm_prefill_wgmma"],
             **w8_report),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
