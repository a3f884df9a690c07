"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line (any failure raises and exits non-zero):
  1. card: name and power limit (nvidia-smi);
  2. build: the serving path's CUDA kernel, compiled with nvcc from
     dynamo_tpu_torch/csrc/flash_decode.cu;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes serving gives it (Llama-3.1-8B and Llama-3.2-1B decode
     shapes, several context/ring patterns; the plain version runs in f32
     on the same inputs, and per element |kernel - plain| <= atol + rtol *
     |plain|), with the kernel's, the plain
     version's and one library call's times and the kernel's least time
     (its byte or operation bound);
  4. tiny: TorchEngine on ModelConfig.tiny (f32) on the card must be
     greedy token-identical to the same engine on the CPU (which the CPU
     tests hold against the JAX TpuEngine);
  5. serve: TorchEngine at the full width of Llama-3.1-8B (32 layers,
     random bf16 weights from a seed, default EngineConfig) answers 8
     concurrent greedy requests and a prefix-cache hit through generate();
     launch counts are zeroed just before and read just after, and must
     show the decode kernel ran on every layer of every decode step.
The card line (nvidia-smi's name and power limit) comes third from last,
the second-to-last line is a JSON object describing every kernel, and the
last is {"ok": true, "device": {...}}. Without a CUDA device, or without
the rest of the repository beside it, the script fails.
"""
from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense tensor-core bf16
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
# kernel vs plain, per element: |got - want| <= atol + rtol * |want|; the
# plain version runs in f32 on the same inputs, so in bf16 the two differ
# by the final rounding (at most one bf16 step, 2**-7 of |want|)
BF16_TOL = (1e-4, 1e-2)
F32_TOL = (1e-5, 1e-4)
SEED = 0


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


def decode_bound_ms(ctx, base, nkv, nh, hd, R, elem):
    """Least time for one call: each live K/V row read once, q read and
    out written once; 4 flops per (head, live row, dim)."""
    live = sum(min(b, c) + max(0, min(c - b, R)) for c, b in zip(ctx, base))
    B = len(ctx)
    nbytes = (live * nkv * hd * 2 * elem + 2 * B * nh * hd * elem + 2 * B * 4)
    flops = 4 * live * nh * hd
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


def plain_f32(fd, q, ck, cv, rk, rv, layer, ctx, base):
    """The plain version on the same inputs computed in f32, in q's dtype.
    (The plain copy of the JAX reference rounds the probabilities to bf16
    before P.V; the kernel keeps them in f32. At a 3-row context whose
    terms cancel, that rounding alone moves an output by ~2e-3.)"""
    f = [t[layer:layer + 1].float() for t in (ck, cv, rk, rv)]
    return fd.flash_decode_attention_plain(
        q.float(), *f, 0, ctx, base).to(q.dtype)


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


def check_flash_decode(serve_lens):
    from dynamo_tpu_torch.ops import flash_decode as fd

    cases = [  # (label, dtype, L, nkv, nh, hd, B, S, R, tol)
        ("llama3_8b", torch.bfloat16, 32, 8, 32, 128, 8, 4096, 4, BF16_TOL),
        ("llama3_1b", torch.bfloat16, 16, 8, 32, 64, 8, 4096, 4, BF16_TOL),
        # f32: a ring of 40 rows spans two of the kernel's 32-row f32 tiles
        ("llama3_8b_f32", torch.float32, 2, 8, 32, 128, 8, 4096, 40, F32_TOL),
    ]
    report = None
    max_err = 0.0  # bf16, every case and pattern
    for label, dtype, L, nkv, nh, hd, B, S, R, tol in cases:
        q, ck, cv, rk, rv = decode_inputs(dtype, L, nkv, nh, hd, B, S, R)
        for pname, (ctx_l, base_l) in decode_patterns(S, R, serve_lens).items():
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
            base = torch.tensor(base_l, dtype=torch.int32, device="cuda")
            err = excess = 0.0
            for layer in (0, L - 1):
                got = fd.flash_decode_attention(
                    q, ck, cv, rk, rv, layer, ctx, base)
                torch.cuda.synchronize()
                want = plain_f32(fd, q, ck, cv, rk, rv, layer, ctx, base)
                err = max(err, (got.float() - want.float()).abs().max().item())
                excess = max(excess, tol_excess(got, want, tol))
                if not excess <= 1.0:
                    raise AssertionError(
                        f"flash_decode {label}/{pname}/layer {layer}: "
                        f"|kernel - plain| exceeds atol {tol[0]} + rtol "
                        f"{tol[1]} * |plain| by a factor {excess}")
                if pname == "serve":
                    # the check must see one dropped row: the plain output
                    # without each slot's current token fails it
                    short = plain_f32(fd, q, ck, cv, rk, rv, layer, ctx - 1,
                                      base)
                    if tol_excess(short, want, tol) <= 1.0:
                        raise AssertionError(
                            f"flash_decode {label}: tolerance {tol} cannot "
                            f"tell a dropped row")
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
            log(f"kernel flash_decode {label} {pname}: agrees with plain, "
                f"max |kernel - plain| {err:.3e}, at {excess:.3f} of the "
                f"tolerance (atol {tol[0]} + rtol {tol[1]} * |plain|)")
            if pname != "serve" or dtype != torch.bfloat16:
                continue
            elem = 2
            ms = cuda_time_ms(lambda i: fd.flash_decode_attention(
                q, ck, cv, rk, rv, i % L, ctx, base), iters=100)
            plain_ms = cuda_time_ms(lambda i: fd.flash_decode_attention_plain(
                q, ck, cv, rk, rv, i % L, ctx, base), iters=5, warmup=1)
            lib = sdpa_call(q, ck, cv, rk, rv, 1, ctx, base)
            library_ms = cuda_time_ms(lambda i: lib(), iters=20)
            bound_ms, bound_by = decode_bound_ms(
                ctx_l, base_l, nkv, nh, hd, R, elem)
            log(f"kernel flash_decode {label} serve shape: {ms:.4f} ms/call "
                f"(plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
                f"{bound_by} bound {bound_ms:.4f} ms)")
            if label == "llama3_8b":
                report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
        del q, ck, cv, rk, rv
        torch.cuda.empty_cache()
    report["max_abs_err"] = max_err
    return report


# ---------------------------------------------------------------------------
# engine

async def generate_all(engine, prompts, max_tokens):
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )

    async def one(p):
        req = PreprocessedRequest(
            token_ids=list(p),
            stop_conditions=StopConditions(max_tokens=max_tokens,
                                           ignore_eos=True))
        toks, ann, finish, gaps = [], {}, None, []
        last = None
        async for out in engine.generate(req):
            now = time.monotonic()
            if last is not None and out.token_ids:
                # a round's tokens arrive together: spread the gap over them
                gaps += [(now - last) / len(out.token_ids)] * len(out.token_ids)
            if out.token_ids:
                last = now
            toks.extend(out.token_ids)
            if out.finish_reason is not None:
                finish, ann = out.finish_reason.value, out.annotations
        return toks, finish, ann, gaps

    return await asyncio.gather(*[one(p) for p in prompts])


def check_tiny_engine():
    """Greedy tokens of the tiny model on the card (flash-decode kernel,
    hd 16 f32) vs on the CPU (plain version)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

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

        async def drive():
            res = await generate_all(eng, prompts, 12)
            res.append((await generate_all(eng, prompts[:1], 12))[0])
            await eng.stop()
            return res

        outs[dev] = [(t, f) for t, f, _, _ in asyncio.run(drive())]
        if dev == "cuda" and eng.kernel_launches == 0:
            raise AssertionError("tiny engine on cuda launched no kernel")
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(
            f"tiny engine: cuda {outs['cuda']} != cpu {outs['cpu']}")
    log(f"tiny: cuda engine greedy-identical to cpu engine over "
        f"{len(outs['cpu'])} requests")


def serve_llama3_8b(counts):
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd

    cfg = ModelConfig.llama3_8b()
    t0 = time.monotonic()
    eng = TorchEngine(cfg, EngineConfig(), device="cuda", rng_seed=SEED)
    torch.cuda.synchronize()
    log(f"serve: Llama-3.1-8B engine built in {time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
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
    fd.launches = 0  # every kernel count to 0 just before the main path
    res, repeat, t_batch = asyncio.run(drive())
    counts["flash_decode"] = fd.launches
    steps = eng.step_count - steps0
    for toks, finish, _, _ in res + [repeat]:
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
    if fd.launches < cfg.num_layers * steps or eng.kernel_launches < fd.launches:
        raise AssertionError(
            f"flash_decode launched {fd.launches} times over {steps} decode "
            f"steps of {cfg.num_layers} layers")
    ttft = [a["timing"]["ttft_s"] for _, _, a, _ in res]
    e2e = [a["timing"]["e2e_s"] for _, _, a, _ in res]
    gaps = [g for *_, gs in res for g in gs]
    decode_tokens = sum(len(t) - 1 for t, *_ in res)
    decode_tps = decode_tokens / (max(e2e) - min(ttft))
    log(f"serve: 8 requests x {n_new} tokens (prompts "
        f"{min(map(len, prompts))}..{max(map(len, prompts))}) in "
        f"{t_batch:.3f} s; TTFT median {np.median(ttft):.4f} s max "
        f"{max(ttft):.4f} s; inter-token gap median "
        f"{np.median(gaps) * 1e3:.2f} ms max {max(gaps) * 1e3:.2f} ms (a "
        f"round's gap spread over its tokens); decode {decode_tps:.1f} "
        f"tok/s over the batch (tokens after the first / span from first "
        f"first-token to last finish); {steps} decode steps, flash_decode "
        f"launches {fd.launches}")
    log(f"serve: prefix repeat hit {cached} cached blocks, TTFT "
        f"{repeat[2]['timing']['ttft_s']:.4f} s")
    return [len(p) for p in prompts]


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
    cuda_build.build("flash_decode")
    log(f"build: flash_decode in {time.monotonic() - t0:.1f} s")

    from dynamo_tpu_torch.models.config import ModelConfig

    serve_lens = [len(p) for p in serve_prompts(ModelConfig.llama3_8b().vocab_size)]
    fd_report = check_flash_decode(serve_lens)
    check_tiny_engine()
    counts: dict[str, int] = {}
    serve_llama3_8b(counts)
    print(smi)
    kernels = [dict(
        name="flash_decode", route="cuda",
        source="dynamo_tpu_torch/csrc/flash_decode.cu",
        replaces="dynamo_tpu/ops/flash_decode.py:210",
        launches=counts["flash_decode"], **fd_report,
    )]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
