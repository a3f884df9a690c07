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
// This first version is written to be right and simple: no cp.async / TMA
// pipelining and no tensor-core products. Its measured time against the
// bound is recorded in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;  // query heads per KV head

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* o) { *o = __float2bfloat16(v); }

template <typename T>
struct Tile {
  // 64 rows of bf16 or 32 rows of f32 keep the static shared memory of the
  // largest instantiation (hd 128, G 8) under 48 KB
  static constexpr int kRows = sizeof(T) == 2 ? 64 : 32;
};

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
  constexpr int TILE = Tile<T>::kRows;
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

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Shapes: q/out [B, n_heads, hd]; ctx_k/ctx_v [L, n_kv, lanes, S, hd];
// ring_k/ring_v [L, n_kv, B, R, hd]; ctx_lens/ring_base int32 [B];
// part_m/part_l f32 [B, n_kv, n_split+1, G]; part_acc f32 [.., G, hd].
// The caller checks shapes, contiguity, 16-byte alignment and G <= 8.
// Supported: bf16 with hd 64 or 128; f32 with hd 16, 64 or 128. Returns the
// cudaError_t of the launches (0 on success); other dtype/hd combinations
// return cudaErrorInvalidValue.
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
#define FD_LAUNCH(T, HD)                                                                  \
  return static_cast<int>(launch<T, T, HD>(q, ctx_k, ctx_v, nullptr, nullptr, 1, ring_k,  \
                                           ring_v, cl, rb, out, pm, pl, pa, B, n_heads,   \
                                           n_kv, lanes, S, R, layer, n_split, scale, st))
  if (dtype == 1) {
    if (hd == 128) FD_LAUNCH(__nv_bfloat16, 128);
    if (hd == 64) FD_LAUNCH(__nv_bfloat16, 64);
  } else if (dtype == 0) {
    if (hd == 128) FD_LAUNCH(float, 128);
    if (hd == 64) FD_LAUNCH(float, 64);
    if (hd == 16) FD_LAUNCH(float, 16);
  }
#undef FD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Int8 mode (loaded with ctypes). As flash_decode_launch, but ctx_k/ctx_v
// are int8 [L, n_kv, lanes, S, hd] with k_scale/v_scale f32 [L, lanes,
// S / group]; q, the ring and out are in the compute dtype (0 = float32,
// 1 = bfloat16). The caller checks the shapes, S % group == 0 and the
// rest as for the dense mode. Supported: bf16 with hd 64 or 128; f32 with
// hd 16, 64 or 128. Returns the cudaError_t of the launches.
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
#define FD_LAUNCH_I8(T, HD)                                                                  \
  return static_cast<int>(launch<T, int8_t, HD>(q, ctx_k, ctx_v, ks, vs, group, ring_k,     \
                                                ring_v, cl, rb, out, pm, pl, pa, B, n_heads, \
                                                n_kv, lanes, S, R, layer, n_split, scale, st))
  if (dtype == 1) {
    if (hd == 128) FD_LAUNCH_I8(__nv_bfloat16, 128);
    if (hd == 64) FD_LAUNCH_I8(__nv_bfloat16, 64);
  } else if (dtype == 0) {
    if (hd == 128) FD_LAUNCH_I8(float, 128);
    if (hd == 64) FD_LAUNCH_I8(float, 64);
    if (hd == 16) FD_LAUNCH_I8(float, 16);
  }
#undef FD_LAUNCH_I8
  return static_cast<int>(cudaErrorInvalidValue);
}
