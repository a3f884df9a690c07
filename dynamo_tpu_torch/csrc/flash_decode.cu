// Flash decode attention over the contiguous per-slot context plus the
// per-round write ring, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode_attention`
// (dynamo_tpu/ops/flash_decode.py:210, body `_kernel` at :99) in both of
// its modes: dense (entry point flash_decode_launch) and int8
// (flash_decode_int8_launch; the scale path at flash_decode.py:176-190).
// Same semantics: one query token per slot, GQA with G = n_heads / n_kv query
// heads per KV head; keys/values at positions < min(ring_base[b],
// ctx_lens[b]) come from ctx_k/ctx_v[layer, h, b], and ring entry r holds
// position ring_base[b] + r, valid while < ctx_lens[b]. Scale 1/sqrt(hd),
// f32 running max / denominator / numerator, denominator floored at 1e-30.
//
// Bound. Decode attention reads every live K/V row once and does 4 flops
// per element of it, far below the card's ~295 flops/byte balance point,
// so it is bound by memory bytes: the least time for one layer is
//     (sum over slots of live positions) * n_kv * hd * 2 (K and V) * bytes
//     / 3.35 TB/s (H100 SXM HBM3).
// At the Llama-3.1-8B serving shape (B=8, n_kv=8, hd=128, bf16) a slot
// with 1024 live positions contributes 4 MiB per layer.
//
// Int8 mode. The ctx K/V rows are int8 with f32 absmax scales per (layer,
// lane, position group), scale[layer, b, pos / group]; element d of row
// pos is k_i8 * scale, computed in f32 and rounded to the compute dtype
// (bf16 or f32) exactly as the reference rounds it, before the f32-
// accumulated QK and PV products. The ring stays in the compute dtype. Its
// byte bound is the live ctx rows * n_kv * hd * 2 (K and V) * 1 byte, plus
// their scales (4 bytes per live row per K and V), the ring rows, q and
// out, over 3.35 TB/s: about half of the dense bound at the serve shape,
// so ~0.0036 ms against the dense kernel's 0.0072 ms.
//
// Which path runs which design:
//   * bf16 (hd 64, 128), both modes, what kv_quant="none" and "int8"
//     serve: flash_decode_cluster_kernel<KV, HD> (KV = bf16 or int8_t),
//     one launch (below, "Bf16, one launch");
//   * f32 (hd 16/64/128, the tiny model and the f32 card check), both
//     modes: flash_decode_split_kernel and flash_decode_combine_kernel, two
//     launches (the split-K design that follows).
//
// Design. A TPU runs its grid in order on one core, so the Pallas kernel
// walks a slot's chunks sequentially and carries (m, l, acc) in VMEM. On
// Hopper blocks run in parallel on 132 SMs and nothing carries between
// them, and B * n_kv is only 64 at the serving shape: one block per (slot,
// KV head) would leave half the SMs idle and each block would stream a
// whole context alone. So the work is split-K ("flash decoding"):
//   * grid (B, n_kv, n_split + 1). Block (b, h, z < n_split) takes the
//     z-th of n_split equal, tile-aligned shares of the slot's LIVE context
//     [0, min(ring_base, ctx_lens)); block z = n_split takes the ring (the
//     TPU grid's final ring step, flash_decode.py:131-132, 195-199). The
//     share is computed from the live length on the device, so a short
//     context is spread over all its splits and a block whose share is
//     empty writes m = -inf, l = 0 and exits: cost tracks the live context
//     as the TPU kernel's index-map DMA skip did (flash_decode.py:253-263).
//     The wrapper picks n_split so that B * n_kv * n_split covers the SMs
//     several times over (64 * 9 = 576 blocks at the serving shape).
//   * One block serves all G query heads of its KV head, so each K/V row is
//     read from device memory once for G heads. q [G, hd] sits in shared
//     memory as f32; K/V tiles of TILE rows are staged through shared
//     memory with 16-byte loads; scores, the running max m, denominator l
//     and the numerator acc are f32.
//   * Each block writes its partial (m, l, acc) to f32 scratch that the
//     wrapper allocates; a second launch merges the splits with max
//     rescaling, floors the denominator at 1e-30 and casts to the output
//     dtype.
//   * In int8 mode the same blocks stage each int8 ctx tile with 16-byte
//     loads (16 elements, half the bytes of a bf16 tile), multiply each row
//     by its scale (a per-row lookup, so any group that divides S works),
//     and store the rounded compute-dtype values in the shared tile that
//     the dense mode fills: the QK/PV loops, the online softmax, the early
//     exit and the combine are the dense mode's. Dequantizing at staging
//     does it once per element, not once per query head.
// That design stages with one synchronous 16-byte load per thread, takes
// its products as scalar FMAs out of shared memory and merges in a second
// launch. On an NVIDIA H100 80GB HBM3 at a 700 W power limit its bf16
// instantiations took 0.0379 ms (dense) and 0.0398 ms (int8) per call at
// the Llama-3.1-8B serve shape, 5.3x and 10.9x their byte bounds; the
// combine launch was a third of each mode's device time (PERF.md). Only
// the f32 instantiations remain.
//
// Bf16, one launch. Same split of the work and the same semantics as
// above, plus P = exp(s - m) rounded to bf16 before P.V and the
// denominator summing the unrounded values, as the TPU kernel rounds them
// (flash_decode.py:154-161). One template serves both modes; they differ
// only in how a landed tile reaches the padded bf16 layout the products
// read. What each part addresses:
//   * The merge, in a thread-block cluster. The n_split + 1 <= 8 blocks of
//     one (slot, KV head) form a cluster. Each keeps its (m, l, acc) in
//     its own shared memory; after a cluster barrier, the cluster's blocks
//     each take a share of the G * hd outputs, read every block's m, l and
//     acc through distributed shared memory, merge with max rescaling and
//     write out, and a second barrier keeps every block resident until its
//     peers have read it. This removes the combine launch and the f32
//     scratch in device memory. A block with an empty share still reaches
//     both barriers (m = -inf, l = 0). The wrapper asks the card, once per
//     mode and head dim (the modes' blocks differ in shared memory), how
//     many clusters of each size it holds at once
//     (cudaOccupancyMaxActiveClusters) and takes the largest cluster
//     (<= 8) of which all B * n_kv fit: a cluster left for a second wave
//     doubles the call.
//   * Asynchronous copies into 2 stages of K+V tiles (64 rows), completed
//     on an mbarrier a stage, so a block's share of 1-4 tiles at the serve
//     shape is in flight before its first products. A tail tile copies
//     only its live rows.
//   * Tensor-core products, mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//     keys on M and the G <= 8 query heads on N = 8: S^T = K q^T with q's
//     fragments in registers for the whole block, O^T = V^T P^T with V^T
//     read by ldmatrix.trans and P written to shared memory as bf16 in
//     between. ldmatrix reads rows padded by 16 bytes (conflict-free).
//     wgmma is not needed: the work is byte-bound and N is 8.
//   * Int8: a 64-row int8 tile of one (layer, KV head, lane) is one
//     contiguous run (8 KB at hd 128), so one thread asks for its K and V
//     with two copies. A bulk copy cannot pad, and fragments read straight
//     from the 128-byte int8 rows would conflict 8 ways, so each landed
//     tile is dequantized once into one padded bf16 tile, K first, then V
//     over it once the QK products have read it; the rows past a tail's
//     live ones dequantize as zero whatever stale bytes or scales they
//     hold (p = 0 times a non-finite V would be NaN). Scales come with
//     plain loads, a tile ahead. The ring (bf16) is staged with plain
//     16-byte loads. Four block barriers a tile.
//   * Dense: a bf16 tile needs no conversion, so it lands at the padded
//     row stride ((hd + 8) * 2 bytes: 272 at hd 128, 144 at hd 64) and
//     ldmatrix reads K and V in the stage itself: no shared-to-shared
//     pass, and V has its own tile. A bulk copy a row was tried first: a
//     tile is 128 copies, and issuing a block's first two tiles took 8 us
//     (an SM's copy engine spends ~10 ns a copy). So every thread issues
//     16-byte cp.async copies instead (16 a tile at hd 128) and arrives on
//     the stage's mbarrier once they land; rows from a tail's live ones to
//     the next 16-row boundary, which P.V reads, are zero-filled by the
//     same copies (src-size 0), whatever the stage held before (p = 0
//     times a NaN would be NaN). The ring block copies its rows the same
//     way. A stage is refilled once every warp is past the P.V that read
//     it, which the QK barrier of the next tile shows: two block barriers
//     a tile. 71.3 KB a block at hd 128, 3 blocks an SM.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py, tools/torch_flash_decode_sweep.py, PERF.md), at the
// Llama-3.1-8B serve shape:
//   * dense: 0.0173 ms per call (SDPA 0.0222 ms, byte bound 0.0072 ms),
//     0.0131 ms at Llama-3.2-1B (SDPA 0.0187 ms). The card holds 69
//     clusters of 5 of its block at hd 128 and 62 of 6, so 4 context
//     splits and the ring block; 8 at hd 64. A block's later tiles land
//     ~1.4 us apart, after a fixed ~6 us of launch, cluster barriers and
//     merge.
//   * int8: 0.0216 ms per call (SDPA over the dequantized K/V 0.0221 ms,
//     byte bound 0.0036 ms), 0.0153 ms at Llama-3.2-1B (SDPA 0.0184 ms);
//     the H100 holds 62 clusters of 8 of its 53.5 KB block and 69 of 7 at
//     hd 128, so 6 context splits and the ring block. Bytes do not bind
//     it: the sweep's own timeline shows a block bound by its per-tile
//     chain (~3 us a 64-row tile at hd 128 with ~3.4 blocks an SM), after
//     a fixed ~8 us of launch, the ctx_lens read, the first copy and the
//     merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;        // query heads per KV head
constexpr int kMaxCluster = 8;  // portable thread-block cluster size

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }

// rows per tile of the split kernel (f32): 32 keep the static shared
// memory of the largest instantiation (hd 128, G 8) under 48 KB
constexpr int kSplitTile = 32;

// Executions of the attention kernel per mode (0 dense, 1 int8) since the
// library loaded or the last reset: thread 0 of block (0, 0, 0) adds one
// at the start of every launch, so the count holds for launches replayed
// from a CUDA graph, which no host counter sees (flash_decode_executed).
__device__ unsigned long long g_executed[2];

__device__ __forceinline__ void count_execution(bool quant) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) {
    atomicAdd(&g_executed[quant ? 1 : 0], 1ULL);
  }
}

// Stage rows [0, n_valid) of a [rows, HD] slab into shared memory (row
// stride `stride` elements) and zero the rest, so that masked rows never
// feed NaN from uninitialised shared memory into p * V.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* src,
                                           int rows, int n_valid) {
  constexpr int kVec = 16 / sizeof(T);           // elements per 16 B
  constexpr int kPerRow = HD / kVec;
  for (int c = threadIdx.x; c < rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) {
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * HD + col);
    }
    *reinterpret_cast<uint4*>(dst + r * stride + col) = v;
  }
}

// Int8 mode: stage rows [0, n_valid) of an int8 [rows, HD] slab whose first
// row is position t0, dequantized with the row's scale (scale[(t0 + r) /
// group]) and rounded to T; the rest are zeroed as in stage_rows.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows_i8(T* dst, int stride, const int8_t* src,
                                              const float* scale, int t0, int group,
                                              int rows, int n_valid) {
  constexpr int kPerRow = HD / 16;               // 16 int8 per 16-byte load
  constexpr int kStores = 16 * sizeof(T) / 16;   // 16-byte stores per load
  for (int c = threadIdx.x; c < rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 16;
    __align__(16) T vals[16];
    if (r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * HD + col);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
      const float s = scale[(t0 + r) / group];
#pragma unroll
      for (int u = 0; u < 16; ++u) from_f(static_cast<float>(e[u]) * s, &vals[u]);
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) from_f(0.f, &vals[u]);
    }
#pragma unroll
    for (int w = 0; w < kStores; ++w) {
      *reinterpret_cast<uint4*>(dst + r * stride + col + w * (16 / sizeof(T))) =
          reinterpret_cast<const uint4*>(vals)[w];
    }
  }
}

// T: q, ring and output dtype (the compute dtype). KV: the ctx storage
// type, T (dense mode) or int8_t (int8 mode, with k_scale/v_scale f32
// [L, lanes, S / group]).
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ ctx_k,
                          const KV* __restrict__ ctx_v, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, int group,
                          const T* __restrict__ ring_k, const T* __restrict__ ring_v,
                          const int* __restrict__ ctx_lens, const int* __restrict__ ring_base,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc, int B, int n_heads, int n_kv,
                          int lanes, int S, int R, int layer, int n_split, float scale) {
  constexpr bool kQuant = !std::is_same<T, KV>::value;
  constexpr int TILE = kSplitTile;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int KSTRIDE = HD + kVec;  // 16 B pad: conflict-free row reads
  constexpr int GP = kThreads / HD;   // query-head groups in the PV phase
  constexpr int kAcc = (kMaxG + GP - 1) / GP;

  __shared__ __align__(16) T k_s[TILE * KSTRIDE];
  __shared__ __align__(16) T v_s[TILE * HD];
  __shared__ float q_s[kMaxG * HD];
  __shared__ float p_s[kMaxG * TILE];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const int G = n_heads / n_kv;
  const int NS = n_split + 1;
  const size_t part = (static_cast<size_t>(b) * n_kv + h) * NS + z;
  count_execution(kQuant);

  const int ctx = ctx_lens[b];
  const int base = ring_base[b];

  // this block's key range [start, end) and where its rows live: the
  // ring (compute dtype) or the ctx region (KV, with its scale rows)
  const bool is_ring = z == n_split;
  const T* rk_src = nullptr;
  const T* rv_src = nullptr;
  const KV* ck_src = nullptr;
  const KV* cv_src = nullptr;
  const float* ksc = nullptr;
  const float* vsc = nullptr;
  int start, end;
  if (is_ring) {
    // ring: entry r holds position base + r, valid while < ctx
    start = 0;
    end = min(max(ctx - base, 0), R);
    const size_t off = ((static_cast<size_t>(layer) * n_kv + h) * B + b) * R * HD;
    rk_src = ring_k + off;
    rv_src = ring_v + off;
  } else {
    const int live = min(max(min(base, ctx), 0), S);
    int share = (live + n_split - 1) / n_split;
    share = (share + TILE - 1) / TILE * TILE;
    start = z * share;
    end = min(start + share, live);
    const size_t off = ((static_cast<size_t>(layer) * n_kv + h) * lanes + b) * S * HD;
    ck_src = ctx_k + off;
    cv_src = ctx_v + off;
    if constexpr (kQuant) {
      const size_t soff = (static_cast<size_t>(layer) * lanes + b) * (S / group);
      ksc = k_scale + soff;
      vsc = v_scale + soff;
    }
  }
  if (start >= end) {
    if (threadIdx.x < G) {
      part_m[part * G + threadIdx.x] = -INFINITY;
      part_l[part * G + threadIdx.x] = 0.f;
    }
    return;
  }

  const T* q_src = q + (static_cast<size_t>(b) * n_heads + h * G) * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) q_s[i] = to_f(q_src[i]);
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int d = threadIdx.x % HD;
  const int gp = threadIdx.x / HD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int t0 = start; t0 < end; t0 += TILE) {
    const int n_valid = min(TILE, end - t0);
    __syncthreads();  // previous tile's readers are done
    const size_t row0 = static_cast<size_t>(t0) * HD;
    if (is_ring) {
      stage_rows<T, HD>(k_s, KSTRIDE, rk_src + row0, TILE, n_valid);
      stage_rows<T, HD>(v_s, HD, rv_src + row0, TILE, n_valid);
    } else if constexpr (kQuant) {
      stage_rows_i8<T, HD>(k_s, KSTRIDE, ck_src + row0, ksc, t0, group, TILE, n_valid);
      stage_rows_i8<T, HD>(v_s, HD, cv_src + row0, vsc, t0, group, TILE, n_valid);
    } else {
      stage_rows<T, HD>(k_s, KSTRIDE, ck_src + row0, TILE, n_valid);
      stage_rows<T, HD>(v_s, HD, cv_src + row0, TILE, n_valid);
    }
    __syncthreads();

    // scores: one (head, row) pair per thread and pass
    for (int idx = threadIdx.x; idx < G * TILE; idx += kThreads) {
      const int g = idx / TILE;
      const int j = idx % TILE;
      float s = -INFINITY;
      if (j < n_valid) {
        const float* qg = q_s + g * HD;
        const T* kr = k_s + j * KSTRIDE;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < HD; c += kVec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int u = 0; u < kVec; ++u) dot += qg[c + u] * to_f(e[u]);
        }
        s = dot * scale;
      }
      p_s[g * TILE + j] = s;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < TILE; j += 32) mx = fmaxf(mx, p_s[g * TILE + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has a valid row
      float sum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        const float p = expf(p_s[g * TILE + j] - m_new);
        p_s[g * TILE + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha + sum_j p[g, j] * V[j, d]
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = gp + i * GP;
      if (g < G) {
        float a = acc[i] * alpha_s[g];
        const float* pg = p_s + g * TILE;
        for (int j = 0; j < n_valid; ++j) a += pg[j] * to_f(v_s[j * HD + d]);
        acc[i] = a;
      }
    }
  }

  float* acc_out = part_acc + part * G * HD;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = gp + i * GP;
    if (g < G) acc_out[g * HD + d] = acc[i];
  }
  if (threadIdx.x < G) {
    part_m[part * G + threadIdx.x] = m_s[threadIdx.x];
    part_l[part * G + threadIdx.x] = l_s[threadIdx.x];
  }
}

// Merge the n_split + 1 partial results of one (slot, KV head).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                            const float* __restrict__ part_acc, T* __restrict__ out,
                            int n_heads, int n_kv, int n_split) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = n_heads / n_kv;
  const int NS = n_split + 1;
  const size_t first = (static_cast<size_t>(b) * n_kv + h) * NS;
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mx = -INFINITY;
    for (int z = 0; z < NS; ++z) mx = fmaxf(mx, part_m[(first + z) * G + g]);
    float l = 0.f, o = 0.f;
    if (mx != -INFINITY) {
      for (int z = 0; z < NS; ++z) {
        const float m = part_m[(first + z) * G + g];
        if (m == -INFINITY) continue;  // empty split: acc never written
        const float w = expf(m - mx);
        l += part_l[(first + z) * G + g] * w;
        o += part_acc[((first + z) * G + g) * HD + d] * w;
      }
    }
    from_f(o / fmaxf(l, 1e-30f), out + (static_cast<size_t>(b) * n_heads + h * G + g) * HD + d);
  }
}

template <typename T, typename KV, int HD>
cudaError_t launch(const void* q, const void* ctx_k, const void* ctx_v, const float* k_scale,
                   const float* v_scale, int group, const void* ring_k, const void* ring_v,
                   const int* ctx_lens, const int* ring_base, void* out, float* part_m,
                   float* part_l, float* part_acc, int B, int n_heads, int n_kv, int lanes,
                   int S, int R, int layer, int n_split, float scale, cudaStream_t stream) {
  const dim3 grid(B, n_kv, n_split + 1);
  flash_decode_split_kernel<T, KV, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(ctx_k), static_cast<const KV*>(ctx_v),
      k_scale, v_scale, group, static_cast<const T*>(ring_k), static_cast<const T*>(ring_v),
      ctx_lens, ring_base, part_m, part_l, part_acc, B, n_heads, n_kv, lanes, S, R, layer,
      n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<T, HD><<<dim3(B, n_kv), kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_heads, n_kv, n_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Bf16, one launch, both modes (hd 64 and 128).

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Bulk asynchronous copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to this block's shared memory; completion
// is counted in bytes on the mbarrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Asynchronous 16-byte copy from global to shared memory that writes
// `src_bytes` (16 or 0) of the source and zeros for the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// One arrival on the mbarrier once all of this thread's earlier cp.async
// copies have landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Four 8x8 bf16 matrices from shared memory, one row address per thread
// (threads 8i..8i+7 give matrix i's rows); .trans delivers them transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c[16x8] += a[16x16] b[16x8]: bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of the cluster kernel, keyed on the ctx storage type KV.
// A stage holds one tile's K rows, then its V rows. Int8 rows land as they
// lie in device memory (one bulk copy each for K and V; a bulk copy cannot
// pad) and are dequantized into the one padded bf16 tile at kOffTile. Bf16
// rows land by 16-byte async copies at the padded stride, so ldmatrix
// reads K and V in the stage itself and there is no padded tile.
template <typename KV, int HD>
struct Layout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kTile = 64;                  // rows per tile
  static constexpr int kStages = 2;                 // K+V tiles in flight
  static constexpr int kStride = HD + 8;            // padded bf16 row: 16 B pad
  static constexpr int kSStride = kTile + 4;        // f32 score row
  static constexpr int kPStride = kTile + 8;        // bf16 probability row
  static constexpr int kKVBytes = kQuant ? kTile * HD : kTile * kStride * 2;  // K or V
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kChunks = kTile * HD / 16 / kThreads;  // int8: 16 B per thread
  // byte offsets into dynamic shared memory; after the tile loop the stage
  // region holds this block's (m, l, acc) for the cluster merge
  static constexpr int kOffTile = kStages * kStageBytes;
  static constexpr int kOffS = kOffTile + (kQuant ? kTile * kStride * 2 : 0);
  static constexpr int kOffP = kOffS + kMaxG * kSStride * 4;
  static constexpr int kOffAlpha = kOffP + kMaxG * kPStride * 2;
  static constexpr int kOffBar = kOffAlpha + kMaxG * 4;
  static constexpr int kBytes = kOffBar + kStages * 8;
  static_assert(kStages * kStageBytes >= (2 + HD) * kMaxG * 4, "merge state fits the stages");
  static_assert((kStride * 2) % 16 == 0 && kOffTile % 16 == 0 && kOffBar % 8 == 0,
                "async copies and ldmatrix need 16-byte rows, mbarriers 8 bytes");
};

// Diagnostic timeline of the bf16 cluster kernel
// (tools/torch_flash_decode_sweep.py): given a buffer, thread 0 of each
// block stamps %globaltimer at its phases into kTraceSlots words; serving
// passes none.
constexpr int kTraceSlots = 12;
unsigned long long* cluster_trace = nullptr;  // host side, set for one launch

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Dequantize the int8 tile `src` ([kTile, HD], rows [0, n) landed) into
// the padded bf16 tile `dst`, row r times its group scale sc[u] (the
// thread's u-th 16-byte chunk) in f32 and rounded to bf16 as the
// reference rounds it; rows from n on are zeroed, whatever their bytes or
// scales hold (p = 0 times a non-finite V would be NaN).
template <int HD>
__device__ __forceinline__ void dequant_tile(bf16* dst, const int8_t* src,
                                             const float (&sc)[Layout<int8_t, HD>::kChunks],
                                             int n) {
  using Lay = Layout<int8_t, HD>;
  constexpr int kPerRow = HD / 16;
#pragma unroll
  for (int u = 0; u < Lay::kChunks; ++u) {
    const int c = threadIdx.x + u * kThreads;
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 16;
    uint4 pair[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    if (r < n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * HD + col);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
      __align__(16) bf16 vals[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) vals[k] = __float2bfloat16(static_cast<float>(e[k]) * sc[u]);
      pair[0] = reinterpret_cast<const uint4*>(vals)[0];
      pair[1] = reinterpret_cast<const uint4*>(vals)[1];
    }
    // at hd 128 eight threads share a 272-byte row: odd quads store their
    // second half first, so each quarter warp's 16-byte stores hit 32
    // distinct banks
    // (selected, not indexed: a register array indexed at run time would
    // live in local memory)
    const int w = HD == 128 ? (c >> 2) & 1 : 0;
    uint4* d = reinterpret_cast<uint4*>(dst + r * Lay::kStride + col);
    d[w] = w ? pair[1] : pair[0];
    d[w ^ 1] = w ? pair[0] : pair[1];
  }
}

// Ring rows [0, n) of a bf16 [rows, HD] slab into the padded tile; the
// rest zeroed.
template <int HD>
__device__ __forceinline__ void stage_ring(bf16* dst, const bf16* src, int n) {
  using Lay = Layout<int8_t, HD>;
  constexpr int kPerRow = HD / 8;
  for (int c = threadIdx.x; c < Lay::kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * HD + col);
    *reinterpret_cast<uint4*>(dst + r * Lay::kStride + col) = v;
  }
}

// Both modes in bf16 as one launch. Grid (B, n_kv, n_split + 1); the
// n_split + 1 blocks of one (slot, KV head) form one thread-block cluster.
// Block z < n_split streams its share of the live context through async
// copies into 2 stages of K+V tiles, block z = n_split the ring (in dense
// mode by the same copies; in int8 mode, whose ring is bf16 and its
// stages int8, with plain loads). Each keeps its (m, l, acc) in shared
// memory; the cluster's blocks merge them through distributed shared
// memory and write out.
template <typename KV, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_cluster_kernel(const bf16* __restrict__ q, const KV* __restrict__ ctx_k,
                            const KV* __restrict__ ctx_v, const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale, int group,
                            const bf16* __restrict__ ring_k, const bf16* __restrict__ ring_v,
                            const int* __restrict__ ctx_lens, const int* __restrict__ ring_base,
                            bf16* __restrict__ out, int n_heads, int n_kv, int lanes, int S,
                            int R, int layer, int n_split, float scale,
                            unsigned long long* trace) {
  using Lay = Layout<KV, HD>;
  constexpr bool kQuant = Lay::kQuant;
  constexpr int TILE = Lay::kTile;
  constexpr int kStages = Lay::kStages;
  constexpr int kPerRow = HD / 16;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* t_s = reinterpret_cast<bf16*>(smem + Lay::kOffTile);  // int8 mode's padded tile
  float* s_s = reinterpret_cast<float*>(smem + Lay::kOffS);
  bf16* p_s = reinterpret_cast<bf16*>(smem + Lay::kOffP);
  float* alpha_s = reinterpret_cast<float*>(smem + Lay::kOffAlpha);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::kOffBar);

  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const int B = gridDim.x;
  const int G = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (trace != nullptr) {  // stamps from thread 0 only
    trace = tid == 0 ? trace + kTraceSlots * (b + B * (h + n_kv * z)) : nullptr;
  }
  auto stamp = [&](int slot) {
    if (trace != nullptr) trace[slot] = global_ns();
  };
  stamp(0);
  count_execution(kQuant);
  const int ctx = ctx_lens[b];
  const int base = ring_base[b];

  const bool is_ring = z == n_split;
  const bf16* rk = nullptr;  // the int8 mode's ring rows
  const bf16* rv = nullptr;
  const KV* ck = nullptr;    // the rows this block copies asynchronously
  const KV* cv = nullptr;
  const float* ksc = nullptr;
  const float* vsc = nullptr;
  int start, end;
  if (is_ring) {
    start = 0;
    end = min(max(ctx - base, 0), R);
    const size_t off = ((static_cast<size_t>(layer) * n_kv + h) * B + b) * R * HD;
    if constexpr (kQuant) {
      rk = ring_k + off;
      rv = ring_v + off;
    } else {  // dense: the ring's rows are copied like the ctx rows
      ck = ring_k + off;
      cv = ring_v + off;
    }
  } else {
    const int live = min(max(min(base, ctx), 0), S);
    int share = (live + n_split - 1) / n_split;
    share = (share + TILE - 1) / TILE * TILE;
    start = z * share;
    end = min(start + share, live);
    const size_t off = ((static_cast<size_t>(layer) * n_kv + h) * lanes + b) * S * HD;
    ck = ctx_k + off;
    cv = ctx_v + off;
    if constexpr (kQuant) {
      const size_t soff = (static_cast<size_t>(layer) * lanes + b) * (S / group);
      ksc = k_scale + soff;
      vsc = v_scale + soff;
    }
  }
  // an empty share still runs to both cluster barriers below
  const int n_tiles = start < end ? (end - start + TILE - 1) / TILE : 0;

  auto issue = [&](int i) {  // tile i's K and V into stage i % kStages
    const int t0 = start + i * TILE;
    const int n = min(TILE, end - t0);
    unsigned char* dst = smem + (i % kStages) * Lay::kStageBytes;
    uint64_t* bar = &full[i % kStages];
    if constexpr (kQuant) {
      // a tile's int8 rows are one contiguous run: one copy each for K and V
      if (lane == 0) {
        const uint32_t bytes = static_cast<uint32_t>(n * HD);
        mbar_expect_tx(bar, 2 * bytes);
        bulk_load(dst, ck + static_cast<size_t>(t0) * HD, bytes, bar);
        bulk_load(dst + Lay::kKVBytes, cv + static_cast<size_t>(t0) * HD, bytes, bar);
      }
    } else {
      // every thread: 16-byte copies landing at the padded stride, rows
      // from n up to the next 16-row boundary (which P.V reads) filled
      // with zeros, then one arrival once they have landed
      constexpr int kChunksPerRow = HD / 8;
      const int rows = (n + 15) / 16 * 16;
#pragma unroll
      for (int u = 0; u < TILE * kChunksPerRow / kThreads; ++u) {
        const int c = tid + u * kThreads;
        const int r = c / kChunksPerRow;
        const int col = (c % kChunksPerRow) * 8;
        if (r < rows) {
          const size_t src = static_cast<size_t>(t0 + (r < n ? r : 0)) * HD + col;
          const int off = (r * Lay::kStride + col) * 2;
          const uint32_t bytes = r < n ? 16u : 0u;
          cp_async16(dst + off, ck + src, bytes);
          cp_async16(dst + Lay::kKVBytes + off, cv + src, bytes);
        }
      }
      cp_async_arrive(bar);
    }
  };

  if (warp == 0) {
    if (lane == 0) {
      // int8: one arrival (with the bytes expected); dense: every thread's
#pragma unroll
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], kQuant ? 1 : kThreads);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if constexpr (kQuant) {
      if (!is_ring) {
        for (int i = 0; i < min(kStages, n_tiles); ++i) issue(i);
      }
      stamp(1);
    }
    if (trace != nullptr) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      trace[10] = n_tiles;
      trace[11] = sm;
    }
  }
  __syncthreads();  // the mbarriers are initialised
  if constexpr (!kQuant) {
    for (int i = 0; i < min(kStages, n_tiles); ++i) issue(i);
    stamp(1);
  }
  // p_s and alpha_s are read after the barriers of the first tile
  for (int i = tid; i < kMaxG * Lay::kPStride; i += kThreads) p_s[i] = __float2bfloat16(0.f);
  if (tid < kMaxG) alpha_s[tid] = 1.f;

  // mma.m16n8k16 fragments (PTX ISA: thread = 4 * grp + quad). Keys run
  // along M and the G <= 8 query heads along N, so a fragment's column is
  // head hq = 2 * quad (+1) and its rows grp (+8).
  const int grp = lane / 4;
  const int hq = 2 * (lane % 4);
  const int mat = lane / 8;  // the ldmatrix matrix this thread addresses
  // q^T as the B operand of S^T = K q^T, held for the whole block: head
  // grp, dims 16 kk + hq (+1) and + 8; heads >= G are zero columns
  uint32_t qf[HD / 16][2];
  const bf16* q_src = q + (static_cast<size_t>(b) * n_heads + h * G + grp) * HD;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    qf[kk][0] = grp < G ? *reinterpret_cast<const uint32_t*>(q_src + 16 * kk + hq) : 0u;
    qf[kk][1] = grp < G ? *reinterpret_cast<const uint32_t*>(q_src + 16 * kk + hq + 8) : 0u;
  }
  // running max and denominator of heads warp and warp + 4 (softmax owners)
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  // O^T = V^T P^T: warp w owns dims [16 kMT w, 16 kMT (w + 1))
  constexpr int kMT = HD / 64;
  float acc[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[mt][k] = 0.f;
  }

  // int8: the group scales of this thread's 16-byte chunks of tile i,
  // loaded a tile ahead so that their round trip overlaps the work before it
  float ks[Lay::kChunks], vs[Lay::kChunks];
  auto load_scales = [&](int i, float (&k_out)[Lay::kChunks], float (&v_out)[Lay::kChunks]) {
    const int t0 = start + i * TILE;
    const int n = min(TILE, end - t0);
#pragma unroll
    for (int u = 0; u < Lay::kChunks; ++u) {
      const int r = (tid + u * kThreads) / kPerRow;
      k_out[u] = r < n ? ksc[(t0 + r) / group] : 0.f;
      v_out[u] = r < n ? vsc[(t0 + r) / group] : 0.f;
    }
  };
  if constexpr (kQuant) {
    if (!is_ring && n_tiles > 0) load_scales(0, ks, vs);
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = start + i * TILE;
    const int n = min(TILE, end - t0);
    unsigned char* st = smem + (i % kStages) * Lay::kStageBytes;
    // the padded bf16 K and V tiles that the products read
    const bf16* k_t = kQuant ? t_s : reinterpret_cast<const bf16*>(st);
    const bf16* v_t = kQuant ? t_s : reinterpret_cast<const bf16*>(st + Lay::kKVBytes);
    float ks_next[Lay::kChunks] = {}, vs_next[Lay::kChunks] = {};
    if constexpr (kQuant) {
      if (!is_ring && i + 1 < n_tiles) load_scales(i + 1, ks_next, vs_next);
      __syncthreads();  // the previous tile's P.V is done with t_s and p_s
      if (is_ring) {
        stage_ring<HD>(t_s, rk + static_cast<size_t>(t0) * HD, n);
      } else {
        mbar_wait(&full[i % kStages], (i / kStages) & 1);
        if (i < 4) stamp(2 + i);
        dequant_tile<HD>(t_s, reinterpret_cast<const int8_t*>(st), ks, n);
      }
      __syncthreads();
    } else {
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
      if (i < 4) stamp(2 + i);
    }

    // S^T[keys, heads] = K q^T: warp w takes keys [16 w, 16 w + 16)
    {
      const int m0 = 16 * warp;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if (m0 < n) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, k_t + (m0 + 8 * (mat & 1) + (lane & 7)) * Lay::kStride + 16 * kk +
                         8 * (mat >> 1));
          mma_bf16(c, a, qf[kk][0], qf[kk][1]);
        }
      }
      const int j = m0 + grp;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int g = hq + (k & 1);
        const int row = j + 8 * (k >> 1);
        if (g < G) s_s[g * Lay::kSStride + row] = row < n ? c[k] * scale : -INFINITY;
      }
    }
    __syncthreads();  // scores are in; every warp is done reading K
    if constexpr (!kQuant) {
      // every warp is past the previous tile's P.V (it came before the
      // barrier above): refill that tile's stage
      const int next = i - 1 + kStages;
      if (i >= 1 && next < n_tiles) issue(next);
    }

    // online softmax, one warp per head; P rounded to bf16 as the TPU
    // kernel rounds it, the denominator summing the unrounded values
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int g = warp + 4 * k;
      if (g < G) {
        const float s0 = s_s[g * Lay::kSStride + lane];
        const float s1 = s_s[g * Lay::kSStride + lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_r[k], mx);  // finite: the tile has a valid row
        const float p0 = expf(s0 - m_new);
        const float p1 = expf(s1 - m_new);
        float sum = p0 + p1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float alpha = expf(m_r[k] - m_new);
        l_r[k] = l_r[k] * alpha + sum;
        m_r[k] = m_new;
        p_s[g * Lay::kPStride + lane] = __float2bfloat16(p0);
        p_s[g * Lay::kPStride + lane + 32] = __float2bfloat16(p1);
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    if constexpr (kQuant) {  // V into the padded tile, over K
      if (is_ring) {
        stage_ring<HD>(t_s, rv + static_cast<size_t>(t0) * HD, n);
      } else {
        dequant_tile<HD>(t_s, reinterpret_cast<const int8_t*>(st + Lay::kKVBytes), vs, n);
      }
    }
    __syncthreads();
    if constexpr (kQuant) {
      if (!is_ring && warp == 0 && i + kStages < n_tiles) {
        // every thread has dequantized this stage (barrier above): refill it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(i + kStages);
      }
    }

    // O^T[d, heads] = O^T * alpha + V^T P^T (V^T through ldmatrix.trans)
    {
      const float al0 = alpha_s[hq];
      const float al1 = alpha_s[hq + 1];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        acc[mt][0] *= al0;
        acc[mt][1] *= al1;
        acc[mt][2] *= al0;
        acc[mt][3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        if (16 * kk < n) {  // rows from n on carry p = 0
          const bf16* pk = p_s + grp * Lay::kPStride + 16 * kk + hq;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pk);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pk + 8);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t a[4];
            ldsm_x4_trans(a, v_t + (16 * kk + 8 * (mat >> 1) + (lane & 7)) * Lay::kStride +
                                 16 * (kMT * warp + mt) + 8 * (mat & 1));
            mma_bf16(acc[mt], a, b0, b1);
          }
        }
      }
    }
    if constexpr (kQuant) {
#pragma unroll
      for (int u = 0; u < Lay::kChunks; ++u) {
        ks[u] = ks_next[u];
        vs[u] = vs_next[u];
      }
    }
  }

  stamp(6);
  // this block's (m, l, acc) into the stage region, once every warp's
  // P.V has read it (dense mode reads V there) and all copies have landed
  __syncthreads();
  float* m_s = reinterpret_cast<float*>(smem);
  float* l_s = m_s + kMaxG;
  float* acc_s = l_s + kMaxG;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int g = warp + 4 * k;
    if (g < G && lane == 0) {
      m_s[g] = m_r[k];
      l_s[g] = l_r[k];
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = hq + (k & 1);
      if (g < G) acc_s[g * HD + 16 * (kMT * warp + mt) + grp + 8 * (k >> 1)] = acc[mt][k];
    }
  }
  cluster.sync();
  stamp(7);
  // the merge, its G * HD outputs spread over the cluster's blocks: each
  // thread reads every block's m, then l and acc, through distributed
  // shared memory (two round trips) and writes one output
  const int NS = n_split + 1;
  for (int idx = cluster.block_rank() * kThreads + tid; idx < G * HD; idx += NS * kThreads) {
    const int g = idx / HD;
    float m_z[kMaxCluster];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      m_z[r] = r < NS ? cluster.map_shared_rank(m_s, r)[g] : -INFINITY;
      mx = fmaxf(mx, m_z[r]);
    }
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < NS) {  // an empty share has m = -inf, l = 0, acc = 0: weight 0
        const float w = m_z[r] == -INFINITY ? 0.f : expf(m_z[r] - mx);
        l += cluster.map_shared_rank(l_s, r)[g] * w;
        o += cluster.map_shared_rank(acc_s, r)[idx] * w;
      }
    }
    out[(static_cast<size_t>(b) * n_heads + h * G) * HD + idx] =
        __float2bfloat16(o / fmaxf(l, 1e-30f));
  }
  stamp(8);
  cluster.sync();  // every block stays resident until its peers have read it
  stamp(9);
}

// The cluster launch configuration of flash_decode_cluster_kernel<KV, HD>
// with `cluster` blocks a cluster over grid (B, n_kv, cluster), its dynamic
// shared memory attribute set; returns that attribute's error.
template <typename KV, int HD>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B, int n_kv,
                           int cluster, cudaStream_t stream) {
  constexpr int kBytes = Layout<KV, HD>::kBytes;
  auto* kernel = flash_decode_cluster_kernel<KV, HD>;
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = cluster;
  *cfg = {};
  cfg->gridDim = dim3(B, n_kv, cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = kBytes;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return smem_set;
}

template <typename KV, int HD>
cudaError_t launch_cluster(const void* q, const void* ctx_k, const void* ctx_v,
                           const float* k_scale, const float* v_scale, int group,
                           const void* ring_k, const void* ring_v, const int* ctx_lens,
                           const int* ring_base, void* out, int B, int n_heads, int n_kv,
                           int lanes, int S, int R, int layer, int n_split, float scale,
                           cudaStream_t stream) {
  if (n_split < 1 || n_split + 1 > kMaxCluster) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t smem_set = cluster_config<KV, HD>(&cfg, attr, B, n_kv, n_split + 1, stream);
  if (smem_set != cudaSuccess) return smem_set;
  auto* kernel = flash_decode_cluster_kernel<KV, HD>;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q),
      static_cast<const KV*>(ctx_k), static_cast<const KV*>(ctx_v), k_scale, v_scale, group,
      static_cast<const bf16*>(ring_k), static_cast<const bf16*>(ring_v), ctx_lens, ring_base,
      static_cast<bf16*>(out), n_heads, n_kv, lanes, S, R, layer, n_split, scale, cluster_trace);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename KV, int HD>
int max_active_clusters(int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (cluster_config<KV, HD>(&cfg, attr, 1, 1, cluster, nullptr) != cudaSuccess) return -1;
  int n = 0;
  auto* kernel = flash_decode_cluster_kernel<KV, HD>;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Shapes: q/out [B, n_heads, hd]; ctx_k/ctx_v [L, n_kv, lanes, S, hd];
// ring_k/ring_v [L, n_kv, B, R, hd]; ctx_lens/ring_base int32 [B];
// part_m/part_l f32 [B, n_kv, n_split+1, G]; part_acc f32 [.., G, hd].
// The caller checks shapes, contiguity, 16-byte alignment and G <= 8.
// Supported: bf16 with hd 64 or 128, one cluster launch (n_split + 1 <= 8;
// part_m/part_l/part_acc unused, may be null); f32 with hd 16, 64 or 128,
// the split and combine launches. Returns the cudaError_t of the launches
// (a refused cluster launch or shared-memory attribute included; 0 on
// success); other dtype/hd combinations return cudaErrorInvalidValue.
extern "C" int flash_decode_launch(const void* q, const void* ctx_k, const void* ctx_v,
                                   const void* ring_k, const void* ring_v,
                                   const void* ctx_lens, const void* ring_base, void* out,
                                   void* part_m, void* part_l, void* part_acc, int dtype,
                                   int B, int n_heads, int n_kv, int hd, int lanes, int S,
                                   int R, int layer, int n_split, float scale, void* stream) {
  const int* cl = static_cast<const int*>(ctx_lens);
  const int* rb = static_cast<const int*>(ring_base);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_LAUNCH(HD)                                                                         \
  return static_cast<int>(launch<float, float, HD>(q, ctx_k, ctx_v, nullptr, nullptr, 1,      \
                                                   ring_k, ring_v, cl, rb, out, pm, pl, pa, B, \
                                                   n_heads, n_kv, lanes, S, R, layer, n_split, \
                                                   scale, st))
#define FD_LAUNCH_CLUSTER(HD)                                                                  \
  return static_cast<int>(launch_cluster<bf16, HD>(q, ctx_k, ctx_v, nullptr, nullptr, 1,      \
                                                   ring_k, ring_v, cl, rb, out, B, n_heads,    \
                                                   n_kv, lanes, S, R, layer, n_split, scale,   \
                                                   st))
  if (dtype == 1) {
    if (hd == 128) FD_LAUNCH_CLUSTER(128);
    if (hd == 64) FD_LAUNCH_CLUSTER(64);
  } else if (dtype == 0) {
    if (hd == 128) FD_LAUNCH(128);
    if (hd == 64) FD_LAUNCH(64);
    if (hd == 16) FD_LAUNCH(16);
  }
#undef FD_LAUNCH
#undef FD_LAUNCH_CLUSTER
  return static_cast<int>(cudaErrorInvalidValue);
}

// Int8 mode (loaded with ctypes). As flash_decode_launch, but ctx_k/ctx_v
// are int8 [L, n_kv, lanes, S, hd] with k_scale/v_scale f32 [L, lanes,
// S / group]; q, the ring and out are in the compute dtype (0 = float32,
// 1 = bfloat16). The caller checks the shapes, S % group == 0 and the
// rest as for the dense mode. Supported: bf16 with hd 64 or 128, one
// cluster launch (n_split + 1 <= 8; part_m/part_l/part_acc unused, may be
// null); f32 with hd 16, 64 or 128, the split and combine launches.
// Returns the cudaError_t of the launches (a refused cluster launch or
// shared-memory attribute included).
extern "C" int flash_decode_int8_launch(const void* q, const void* ctx_k, const void* ctx_v,
                                        const void* k_scale, const void* v_scale,
                                        const void* ring_k, const void* ring_v,
                                        const void* ctx_lens, const void* ring_base, void* out,
                                        void* part_m, void* part_l, void* part_acc, int dtype,
                                        int B, int n_heads, int n_kv, int hd, int lanes, int S,
                                        int R, int layer, int n_split, int group, float scale,
                                        void* stream) {
  const int* cl = static_cast<const int*>(ctx_lens);
  const int* rb = static_cast<const int*>(ring_base);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group <= 0 || S % group != 0) return static_cast<int>(cudaErrorInvalidValue);
#define FD_LAUNCH_I8(HD)                                                                      \
  return static_cast<int>(launch<float, int8_t, HD>(q, ctx_k, ctx_v, ks, vs, group, ring_k,   \
                                                    ring_v, cl, rb, out, pm, pl, pa, B,       \
                                                    n_heads, n_kv, lanes, S, R, layer,        \
                                                    n_split, scale, st))
#define FD_LAUNCH_CLUSTER(HD)                                                                  \
  return static_cast<int>(launch_cluster<int8_t, HD>(q, ctx_k, ctx_v, ks, vs, group, ring_k, \
                                                     ring_v, cl, rb, out, B, n_heads, n_kv,  \
                                                     lanes, S, R, layer, n_split, scale, st))
  if (dtype == 1) {
    if (hd == 128) FD_LAUNCH_CLUSTER(128);
    if (hd == 64) FD_LAUNCH_CLUSTER(64);
  } else if (dtype == 0) {
    if (hd == 128) FD_LAUNCH_I8(128);
    if (hd == 64) FD_LAUNCH_I8(64);
    if (hd == 16) FD_LAUNCH_I8(16);
  }
#undef FD_LAUNCH_I8
#undef FD_LAUNCH_CLUSTER
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `cluster` blocks of the bf16 cluster kernel (quant:
// 0 = dense, 1 = int8) at head dim hd the card holds at once
// (cudaOccupancyMaxActiveClusters); -1 on an error or another hd.
extern "C" int flash_decode_max_active_clusters(int quant, int hd, int cluster) {
  if (quant) {
    if (hd == 128) return max_active_clusters<int8_t, 128>(cluster);
    if (hd == 64) return max_active_clusters<int8_t, 64>(cluster);
  } else {
    if (hd == 128) return max_active_clusters<bf16, 128>(cluster);
    if (hd == 64) return max_active_clusters<bf16, 64>(cluster);
  }
  return -1;
}

// Give the next bf16 cluster launch of either mode a timeline buffer of
// kTraceSlots u64 per block (B * n_kv * (n_split + 1) blocks), or none
// (null), for tools/torch_flash_decode_sweep.py. Returns kTraceSlots.
extern "C" int flash_decode_set_trace(void* buf) {
  cluster_trace = static_cast<unsigned long long*>(buf);
  return kTraceSlots;
}

// The attention kernel's executions on the current device since the
// library loaded or the last reset, into out[2] (dense, int8); with reset
// != 0 both go back to 0 after the read. Copies through the legacy default
// stream (the caller synchronises first). Returns the cudaError_t.
extern "C" int flash_decode_executed(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_executed, sizeof(g_executed));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    err = cudaMemcpyToSymbol(g_executed, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
