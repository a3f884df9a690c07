"""The engine's device programs: a decode round and the state patch
between rounds, replayed as CUDA graphs on the card (the counterpart of
the JAX package's ``_build_jits``, dynamo_tpu/engine/engine.py:683-881).

The reference compiles a round -- ``flush_every`` decode+sample steps,
the ring->ctx flush and the fused block seal -- into one XLA program and
dispatches it once per round. Here the same round is one function,
``run_round``, that updates the engine's state IN PLACE and writes its
tokens (and packed logprobs) into static output buffers. On the card
each of the 8 round shapes ``(want_sample, want_lp, with a seal batch
or not)`` is captured into a ``torch.cuda.CUDAGraph`` when the engine is
built (``prepare``), so no capture ever stalls a served round, and every
round is then one graph launch. The patch between rounds (releases and
one admission) takes the reference's fixed shape, a clear mask [B] plus
one packed admission row (``run_patch``), and is one more graph. On the CPU both functions run
eagerly: that is the tests' path, not a fallback.

What capture requires, and how this module meets it:
  - Fixed addresses. The device state, the ctx region, the ring and the
    pool are updated in place. A round's inputs (its seal batch, padded
    to the fixed fused width with rows for scratch page 0) and a patch's
    (its packed row, the admitted first token) are copied into static
    buffers before the replay; a round's outputs land in static buffers
    that the caller copies to the host right after the replay, so stream
    order keeps that copy ahead of the next replay that overwrites them.
  - No lazy initialisation inside a capture. Each shape is first run
    eagerly on a side stream (cuBLAS workspaces, the flash-decode
    library's build and load, the card's cluster-residency query), on
    throwaway copies of the small state whose every lane writes the
    scratch lane, with the seal reading scratch page 0; the ring is
    scratch between rounds and the side stream waits for every queued
    program first.
  - Nothing inside a round synchronises the host.
  - One memory pool for all of an engine's graphs. No graph keeps a
    tensor of the pool alive past its capture, and one stream replays
    them in order, so their temporaries never overlap.
  - No fallback: a capture or replay that fails raises, and so does a
    round whose shape has no graph.

The flash-decode wrapper counts a launch where it issues one; inside a
capture that records the kernel into the graph. Each graph keeps the
launches recorded at its capture, and every call here returns the
kernel launches it made (a replay: the recorded count). The w8a16 GEMM
wrapper (a quantized model's weight products) counts its launches the
same way; each graph keeps them as a separate count, and
``w8a16_replayed`` sums them over the replays.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.ops import flash_decode, w8a16

# the packed patch row (int64 [B + PATCH_FIELDS]): [0, B) the clear
# mask, then the admitted slot (B: no admission), its context length,
# top_k, the two threefry key words, and the f32 bit patterns (as signed
# int32 values) of temperature, top_p and the three penalties
PATCH_FIELDS = 10
_F32_KNOBS = ("temp", "top_p", "freq", "pres", "rep")


def _kernel_count() -> int:
    return flash_decode.launches + flash_decode.launches_int8


def run_round(
    config: ModelConfig,
    ecfg: EngineConfig,
    params,
    ctx: llama.Cache,
    ring: llama.Cache,
    cache: llama.Cache,
    dev: dict[str, torch.Tensor],
    out: dict[str, torch.Tensor],
    want_sample: bool,
    want_lp: bool,
    seal: Optional[torch.Tensor] = None,
) -> None:
    """One decode round, IN PLACE: ``flush_every`` x (``decode_step``,
    then argmax or the full sampler, plus packed logprobs with
    ``want_lp``), the ring->ctx flush, then the seal batch ``seal``
    ([3, W] int32 slots, starts, pages) ctx->pool when given. Advances
    ``dev`` (tokens, ctx; counts and keys when sampling) and writes
    ``out["ring_base"]``, the step tokens ``out["toks"]`` [F, B] and,
    with ``want_lp``, ``out["lp"]`` [F, B, 1+2K]."""
    e = ecfg
    n = e.flush_every
    # the round's ring base is fixed at its start
    ring_base = out["ring_base"]
    ring_base.copy_(torch.clamp(dev["ctx"] - 1, min=0))
    sp = sampling.SamplingParams(
        temperature=dev["temp"], top_k=dev["top_k"], top_p=dev["top_p"],
        frequency_penalty=dev["freq"], presence_penalty=dev["pres"],
        repetition_penalty=dev["rep"],
    )
    for s in range(n):
        logits = llama.decode_step(config, params, ctx, ring, dev["tokens"],
                                   dev["ctx"], ring_base, s)
        if want_sample:
            toks = sampling.sample_step(logits, dev["counts"], sp,
                                        e.max_top_k, dev["keys"])
        else:
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        out["toks"][s] = toks
        if want_lp:
            out["lp"][s] = sampling.pack_logprobs(*sampling.compute_logprobs(
                logits, toks, e.max_logprobs))
        dev["tokens"].copy_(toks)
        dev["ctx"].add_(1).clamp_(max=e.max_context)
    # round boundary: scatter the ring into the ctx region (after every
    # read of the round)
    valid = torch.clamp(e.max_context - ring_base, max=n)
    llama.flush_ctx(ctx, ring, dev["dest"], ring_base, valid)
    if seal is not None:
        llama.seal_blocks(cache, ctx, seal[0], seal[1], seal[2], e.page_size)


def pack_patch(batch: int, clear_slots=(), admit: Optional[dict] = None
               ) -> np.ndarray:
    """The packed patch row for ``run_patch`` (layout at PATCH_FIELDS):
    release ``clear_slots`` and admit ``admit`` (slot, ctx, keys and the
    sampling knobs), or nothing when it is None."""
    row = np.zeros(batch + PATCH_FIELDS, np.int64)
    row[list(clear_slots)] = 1
    row[batch] = batch
    if admit is not None:
        row[batch: batch + 5] = (admit["slot"], admit["ctx"], admit["top_k"],
                                 *admit["keys"])
        knobs = np.asarray([admit[k] for k in _F32_KNOBS], np.float32)
        row[batch + 5:] = knobs.view(np.int32)
    return row


def run_patch(dev: dict[str, torch.Tensor], row: torch.Tensor,
              tok: torch.Tensor) -> None:
    """The state patch IN PLACE (the reference's ``patch``): lanes set in
    the clear mask are released (context 1, token 0, greedy, counts 0,
    parked on the scratch lane B, so their in-flight garbage steps cannot
    touch a lane being re-prefilled); the admitted slot, if any, takes
    its first token ``tok`` [1], context length, keys and knobs, with
    zeroed counts and its own lane. Fixed shapes: one program whatever
    the patch holds."""
    B = dev["tokens"].shape[0]
    lanes = torch.arange(B, device=row.device)
    clear = row[:B] != 0
    sel = lanes == row[B]
    knobs = row[B + 5:].to(torch.int32).view(torch.float32)

    def put(name, cleared, admitted):
        t = dev[name]
        if cleared is not None:
            t.copy_(torch.where(clear, cleared, t))
        t.copy_(torch.where(sel, admitted.to(t.dtype), t))

    put("ctx", 1, row[B + 1])
    put("tokens", 0, tok[0])
    put("dest", B, lanes)
    put("top_k", None, row[B + 2])
    for i, name in enumerate(_F32_KNOBS):
        put(name, 0.0 if name == "temp" else None, knobs[i])
    dev["keys"].copy_(torch.where(sel[:, None], row[None, B + 3:B + 5],
                                  dev["keys"]))
    dev["counts"].masked_fill_((clear | sel)[:, None], 0)


class DeviceGraphs:
    """The engine's round and patch programs on its device state: eager
    on the CPU; on the card, CUDA graphs captured by ``prepare`` and
    replayed. ``out`` holds the static round outputs."""

    def __init__(self, config: ModelConfig, ecfg: EngineConfig, params,
                 ctx: llama.Cache, ring: llama.Cache, cache: llama.Cache,
                 dev: dict[str, torch.Tensor], seal_width: int):
        self.config, self.ecfg, self.params = config, ecfg, params
        self.ctx, self.ring, self.cache, self.dev = ctx, ring, cache, dev
        B = dev["tokens"].shape[0]
        self.device = device = dev["tokens"].device
        self.on_card = device.type == "cuda"
        i32 = dict(dtype=torch.int32, device=device)
        n = ecfg.flush_every
        self.out = {
            "ring_base": torch.zeros(B, **i32),
            "toks": torch.zeros(n, B, **i32),
            "lp": torch.zeros(n, B, 1 + 2 * ecfg.max_logprobs,
                              dtype=torch.float32, device=device),
        }
        self.seal = torch.zeros(3, seal_width, **i32)
        self.patch_row = torch.zeros(B + PATCH_FIELDS, dtype=torch.int64,
                                     device=device)
        self.patch_tok = torch.zeros(1, **i32)
        self._graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self._pool = None
        # per graph key: flash-decode and w8a16 GEMM launches recorded,
        # capture seconds
        self.recorded: dict[tuple, int] = {}
        self.recorded_w8a16: dict[tuple, int] = {}
        self.capture_s: dict[tuple, float] = {}
        # device memory the captures reserved for the shared pool
        self.pool_bytes = 0
        self.replays = 0
        # w8a16 GEMM launches of the replays: recorded at capture, once a
        # replay
        self.w8a16_replayed = 0

    def _upload(self, dst: torch.Tensor, a: np.ndarray) -> None:
        """A host array into a static buffer without a stream sync
        (pinned staging, kept by the caching host allocator until the
        copy has run)."""
        src = torch.from_numpy(a)
        if self.on_card:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def prepare(self) -> None:
        """Capture every program before any request: the round in each
        of its 8 shapes, and the patch. Captures run nothing on the
        state. A no-op on the CPU."""
        if not self.on_card:
            return
        jobs = [self._round_job(s, lp, seal) for s in (False, True)
                for lp in (False, True) for seal in (False, True)]
        for job in jobs + [self._patch_job()]:
            if job[0] not in self._graphs:
                self._capture(*job)

    def round(self, want_sample: bool, want_lp: bool,
              seal: Optional[np.ndarray]) -> int:
        """One decode round (``run_round`` on the engine's state into
        ``out``) with the padded seal batch ``seal`` [3, W] or none.
        Returns the flash-decode launches it made."""
        if seal is not None:
            self._upload(self.seal, seal)
        key, fn, _ = self._round_job(want_sample, want_lp, seal is not None)
        return self._run(key, fn)

    def patch(self, row: np.ndarray, tok: Optional[torch.Tensor]) -> None:
        """The state patch of the packed ``row`` (``pack_patch``), with
        the admitted slot's first token ``tok`` [1] on the device."""
        self._upload(self.patch_row, row)
        if tok is not None:
            self.patch_tok.copy_(tok)
        key, fn, _ = self._patch_job()
        self._run(key, fn)

    def _round_job(self, want_sample: bool, want_lp: bool, has_seal: bool):
        """(graph key, the round on the engine's state, the same round on
        throwaway state for the warm-up)."""
        def body(dev, out, seal_buf):
            run_round(self.config, self.ecfg, self.params, self.ctx,
                      self.ring, self.cache, dev, out, want_sample, want_lp,
                      seal_buf)

        return (
            ("round", want_sample, want_lp, has_seal),
            lambda: body(self.dev, self.out, self.seal if has_seal else None),
            lambda: body(self._scratch_state(),
                         {k: v.clone() for k, v in self.out.items()},
                         torch.zeros_like(self.seal) if has_seal else None))

    def _patch_job(self):
        return (("patch",),
                lambda: run_patch(self.dev, self.patch_row, self.patch_tok),
                lambda: run_patch(self._scratch_state(), self.patch_row,
                                  self.patch_tok))

    def _scratch_state(self) -> dict[str, torch.Tensor]:
        """Throwaway copies of the small device state with every lane
        writing the scratch lane, for a warm-up run."""
        d = {k: v.clone() for k, v in self.dev.items()}
        d["dest"].fill_(d["tokens"].shape[0])
        return d

    def _run(self, key: tuple, fn: Callable[[], None]) -> int:
        if not self.on_card:
            fn()  # CPU tensors take the kernel's plain version
            return 0
        g = self._graphs.get(key)
        if g is None:
            raise RuntimeError(f"no CUDA graph for {key}: prepare() "
                               f"captures every program")
        g.replay()
        self.replays += 1
        self.w8a16_replayed += self.recorded_w8a16[key]
        return self.recorded[key]

    def _capture(self, key: tuple, fn: Callable[[], None],
                 warm: Callable[[], None]) -> torch.cuda.CUDAGraph:
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm()
        main.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        launches, gemms = _kernel_count(), w8a16.launches
        # thread_local: the engine thread captures while other threads
        # may use the device
        with torch.cuda.graph(g, pool=self._pool,
                              capture_error_mode="thread_local"):
            # read after the context has emptied the allocator's cache
            reserved = torch.cuda.memory_reserved(self.device)
            fn()
        self.pool_bytes += max(
            0, torch.cuda.memory_reserved(self.device) - reserved)
        self.recorded[key] = _kernel_count() - launches
        self.recorded_w8a16[key] = w8a16.launches - gemms
        self._graphs[key] = g
        self.capture_s[key] = time.perf_counter() - t0
        return g
