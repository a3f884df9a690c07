// Weight-only int8 matrix product (w8a16) for Hopper (sm_90a):
//     y[m, n] = sum_k x[m, k] * q[k, n],  then the per-output-channel scale s[n]
//
// Replaces what XLA fuses for the JAX package's quantized weights:
// `_mm` (dynamo_tpu/models/llama.py:409, `jnp.matmul(x, q.astype(x.dtype))
// * s.astype(x.dtype)`) on every layer product, and the quantized branch of
// `_logits` (:612-621, `jnp.matmul(h, q.astype(h.dtype),
// preferred_element_type=f32) * s`). The reference has no Pallas kernel
// for it: XLA fuses the int8 -> bf16 convert into the dot. In eager
// PyTorch that convert writes and rereads a bf16 copy of every weight
// (5 bytes a weight against bf16's 2), so the port does the convert here,
// on chip, and the weights stream from device memory as int8.
//
// Operands. x [M, K] row-major in the compute dtype; q int8, either
// [K, N] (layout KN: every layer weight and an untied lm_head, stored
// [in, out]) or [N, K] (layout NK: the tied embedding table [V, H] read
// as the logits weight without a transposed copy); s f32 [N]; y [M, N].
// Epilogues, matching the reference's rounding:
//   * bf16 x, bf16 y (a layer product): y = bf16(bf16(acc) * bf16(s)), as
//     jnp.matmul(x, q.astype(bf16)) rounds the product to bf16 and the
//     scale multiplies in bf16;
//   * bf16 or f32 x, f32 y (the logits, and every product of an f32
//     model): y = acc * s in f32.
// acc is the f32 sum of exact products (|q| <= 127 and a bf16 x multiply
// exactly into f32). Sums run in a fixed order: no float atomics, so a
// replayed CUDA graph gives the bits of an eager call.
//
// Bound. At decode M = 8 (max_decode_slots) each weight byte is used for
// 2 * M = 16 operations, far below the card's ~590 operations a byte for
// bf16 tensor cores, so a call is bound by its bytes: the int8 weight,
// plus x, s and y, over 3.35 TB/s. Llama-3.1-8B streams 7.50 GB of int8
// weights a decode step (2.24 ms; its bf16 weights 4.48 ms). At prefill M
// (thousands of rows) the bound becomes the tensor-core rate.
//
// Two tensor-core kernels for bf16 x; ops/w8a16.py::route picks one.
// w8a16_gemm_wgmma_kernel (below) takes the layer products of prefill:
// layout KN, bf16 y, M at or above the wrapper's threshold. Everything
// else (decode, the f32 logits, layout NK) runs w8a16_gemm_mma_kernel.
//
// Design (bf16 x, w8a16_gemm_mma_kernel):
//   * Swapped operands. mma.sync.m16n8k16 takes a 16-row A and an 8-column
//     B. The weights are A, with output channels n in its rows, and the
//     activation rows m are B's columns: at M = 8 no half of a tile is
//     padding. A block has 4 warps of 32 channels each (BN = 128), and every
//     warp covers all BM activation rows of the block (BM = 8, 32 or 64).
//   * Dequantization in registers. Each thread loads 32-bit words of int8
//     from shared memory and turns each byte into bf16 with the exponent
//     trick (0x4B000000 | (b ^ 0x80) is 2^23 + b + 128 as an f32; subtract
//     2^23 + 128), which is exact for |q| <= 127. The k positions inside a
//     16-deep mma step are permuted (slot s holds k = 4 * ((s & 7) >> 1) +
//     2 * (s >> 3) + (s & 1), the same for A and B), so a thread's four k
//     values are contiguous: one 64-bit load gives its B fragment and one
//     32-bit word (layout NK) four k values of one channel. In layout KN a
//     word holds four channels at one k; the A rows are permuted the same
//     way (row r of tile i in warp w is channel 32w + 4(r & 7) + 2i +
//     (r >> 3)), so four words give a thread its 16 values.
//   * Pipeline. 64-deep k tiles (8 KB of int8, BM x 64 bf16 of x) land by
//     16-byte cp.async copies in a ring of 4 stages; a copy past the end of
//     the matrix or the split writes zeros. The int8 tile is XOR-swizzled
//     by 16-byte chunk so that the fragment loads hit 32 distinct banks.
//   * Split K for small grids. When N / 128 * ceil(M / BM) output tiles
//     cannot fill the card (wk and wv at 8B: 8 tiles), the wrapper splits K
//     over `splits` <= 8 blocks that form one thread-block cluster along z.
//     Each block leaves its f32 partial tile in shared memory; after a
//     cluster barrier, block r sums a 1/splits share of the tile over the
//     cluster's blocks through distributed shared memory, in rank order,
//     applies the epilogue and stores. Deterministic, one launch, no
//     scratch in device memory.
//   * The output tile goes through shared memory in every case, so stores
//     are coalesced along n.
// f32 x (the tiny model and the f32 card check, w8a16_gemm_f32_kernel): a
// plain tiled FMA kernel, f32 all through (no TF32), k in ascending order.
//
// Counting. Thread 0 of block (0, 0, 0) adds one to a device counter at
// the start of every launch, so launches replayed from a CUDA graph are
// counted too (w8a16_gemm_executed).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // 4 warps
constexpr int kBN = 128;           // output channels per block (32 per warp)
constexpr int kBK = 64;            // k per pipeline stage
constexpr int kStages = 4;         // pipeline depth
constexpr int kMaxSplits = 8;      // portable cluster size
constexpr int kXStride = kBK * 2 + 32;   // bytes per staged x row (padded)
constexpr int kWBytes = kBK * kBN;       // int8 bytes per staged weight tile
constexpr int kRedStride = kBN + 4;      // f32 per row of the output tile

enum Layout { kKN = 0, kNK = 1 };

__device__ unsigned long long g_executed;

__device__ __forceinline__ void count_execution() {
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) {
    atomicAdd(&g_executed, 1ULL);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; writes zeros when src_bytes = 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// byte i of a word of four int8 as an exact f32
__device__ __forceinline__ float dq_byte(uint32_t biased, uint32_t selector) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, selector)) - 8388736.0f;
}

__device__ __forceinline__ void dq4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = dq_byte(u, 0x7650);
  f[1] = dq_byte(u, 0x7651);
  f[2] = dq_byte(u, 0x7652);
  f[3] = dq_byte(u, 0x7653);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16(bf16(acc) * bf16(s)): jnp.matmul(x, q.astype(bf16)) * s.astype(bf16)
__device__ __forceinline__ bf16 epilogue_bf16(float acc, float s) {
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  const float b = __bfloat162float(__float2bfloat16_rn(s));
  return __float2bfloat16_rn(a * b);
}

// Stage k tile `kt` (k in [kt * kBK, +kBK), clipped to k_end) of the weight
// and of x into shared memory buffers ws / xs.
template <int LAYOUT, int BM>
__device__ __forceinline__ void load_stage(int8_t* ws, uint8_t* xs, const int8_t* q,
                                           const bf16* x, int M, int N, int K, int m0, int n0,
                                           int k0, int k_end) {
  // weights: 512 chunks of 16 bytes
#pragma unroll
  for (int it = 0; it < kWBytes / 16 / kThreads; ++it) {
    const int c = threadIdx.x + it * kThreads;
    if (LAYOUT == kKN) {
      // row kr (k), chunk ch (16 channels); chunk swizzled by bits 2-3 of kr
      const int kr = c >> 3, ch = c & 7;
      const int k = k0 + kr, n = n0 + ch * 16;
      const bool ok = k < k_end && n < N;
      const int8_t* src = ok ? q + static_cast<size_t>(k) * N + n : q;
      cp_async16(ws + kr * kBN + ((ch ^ (((kr >> 2) & 3) << 1)) << 4), src, ok ? 16 : 0);
    } else {
      // row nr (channel), chunk ch (16 k); chunk swizzled by bits 1-2 of nr
      const int nr = c >> 2, ch = c & 3;
      const int n = n0 + nr, k = k0 + ch * 16;
      const bool ok = n < N && k < k_end;
      const int8_t* src = ok ? q + static_cast<size_t>(n) * K + k : q;
      cp_async16(ws + nr * kBK + ((ch ^ ((nr >> 1) & 3)) << 4), src, ok ? 16 : 0);
    }
  }
  // x: BM rows of 8 chunks of 8 bf16
  for (int c = threadIdx.x; c < BM * 8; c += kThreads) {
    const int mr = c >> 3, ch = c & 7;
    const int m = m0 + mr, k = k0 + ch * 8;
    const bool ok = m < M && k < k_end;
    const bf16* src = ok ? x + static_cast<size_t>(m) * K + k : x;
    cp_async16(xs + mr * kXStride + ch * 16, src, ok ? 16 : 0);
  }
}

template <int BM>
struct Smem {
  static constexpr int kStageBytes = kWBytes + BM * kXStride;
  static constexpr int kPipeBytes = kStages * kStageBytes;
  static constexpr int kRedBytes = BM * kRedStride * 4;
  static constexpr int kBytes = kPipeBytes > kRedBytes ? kPipeBytes : kRedBytes;
};

// grid (ceil(N / kBN), ceil(M / BM), splits); splits > 1 runs as clusters
// (1, 1, splits). OUT_BF16: y bf16 with the layer epilogue, else f32.
template <int LAYOUT, int BM, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads)
    w8a16_gemm_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                          const float* __restrict__ s, void* __restrict__ y, int M, int N, int K,
                          int k_tiles_per_split) {
  extern __shared__ __align__(128) uint8_t smem[];
  count_execution();
  constexpr int MT = BM / 8;  // n8 tiles (activation rows) per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int splits = gridDim.z;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * k_tiles_per_split;
  const int kt1 = min(kt0 + k_tiles_per_split, k_tiles);
  const int nkt = max(kt1 - kt0, 0);
  const int k_end = min(kt1 * kBK, K);

  auto ws_of = [&](int stage) {
    return reinterpret_cast<int8_t*>(smem + stage * Smem<BM>::kStageBytes);
  };
  auto xs_of = [&](int stage) { return smem + stage * Smem<BM>::kStageBytes + kWBytes; };

  float acc[2][MT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt) {
      load_stage<LAYOUT, BM>(ws_of(st), xs_of(st), q, x, M, N, K, m0, n0, (kt0 + st) * kBK,
                             k_end);
    }
    cp_async_commit();
  }

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {  // refill the slot that every warp finished with in the last iteration
      const int nxt = it + kStages - 1;
      if (nxt < nkt) {
        load_stage<LAYOUT, BM>(ws_of(nxt % kStages), xs_of(nxt % kStages), q, x, M, N, K, m0,
                               n0, (kt0 + nxt) * kBK, k_end);
      }
      cp_async_commit();
    }
    const int8_t* ws = ws_of(it % kStages);
    const uint8_t* xs = xs_of(it % kStages);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // A fragments of the warp's two 16-channel tiles: a[i] = {(row g, k
      // 4c..4c+1), (row g+8, same), (row g, 4c+2..4c+3), (row g+8, same)}
      uint32_t a[2][4];
      if (LAYOUT == kKN) {
        // word j: k = 16ks + 4c + j, channels 32w + 4g .. +3 (one byte each)
        float f[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = ks * 16 + 4 * c + j;  // (kr >> 2) & 3 == c
          const int ch = (2 * warp + (g >> 2)) ^ (2 * c);
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(ws + kr * kBN + ch * 16 + (g & 3) * 4);
          dq4(w, f[j]);
        }
        // channel 4g + i2 (i2 = 2i + h) is row g + 8h of tile i
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i2 = 2 * i + h;
            a[i][h] = pack_bf16(f[0][i2], f[1][i2]);
            a[i][2 + h] = pack_bf16(f[2][i2], f[3][i2]);
          }
        }
      } else {
        // row g + 8h of tile i is channel 32w + 8(2i + h) + g; its word
        // holds k = 16ks + 4c .. +3
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int nr = 32 * warp + 8 * (2 * i + h) + g;  // (nr >> 1) & 3 == (g >> 1) & 3
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                ws + nr * kBK + ((ks ^ ((g >> 1) & 3)) << 4) + 4 * c);
            float f[4];
            dq4(w, f);
            a[i][h] = pack_bf16(f[0], f[1]);
            a[i][2 + h] = pack_bf16(f[2], f[3]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const uint2 b = *reinterpret_cast<const uint2*>(xs + (t * 8 + g) * kXStride + ks * 32 +
                                                        c * 8);
        mma_bf16(acc[0][t], a[0], b.x, b.y);
        mma_bf16(acc[1][t], a[1], b.x, b.y);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the pipeline: reuse it

  // this block's partial tile [BM][kBN] (f32) into shared memory
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nr = LAYOUT == kKN ? 32 * warp + 4 * g + 2 * i + h : 32 * warp + 8 * (2 * i + h) + g;
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        red[(t * 8 + 2 * c) * kRedStride + nr] = acc[i][t][2 * h];
        red[(t * 8 + 2 * c + 1) * kRedStride + nr] = acc[i][t][2 * h + 1];
      }
    }
  }

  // each block of the cluster finishes a share of the tile: the sum over
  // the cluster's partial tiles in rank order, then the epilogue
  constexpr int E = BM * kBN;
  int e_lo = 0, e_hi = E;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) {
    cluster.sync();
    const int r = static_cast<int>(cluster.block_rank());
    e_lo = r * E / splits;
    e_hi = (r + 1) * E / splits;
  } else {
    __syncthreads();
  }
  for (int e = e_lo + threadIdx.x; e < e_hi; e += kThreads) {
    const int mr = e / kBN, nr = e % kBN;
    const int m = m0 + mr, n = n0 + nr;
    const int idx = mr * kRedStride + nr;
    // rank 0's partial first, then ranks 1.. in order, whichever block sums
    float v = splits > 1 ? cluster.map_shared_rank(red, 0)[idx] : red[idx];
    for (int r = 1; r < splits; ++r) v += cluster.map_shared_rank(red, r)[idx];
    if (m < M && n < N) {
      if (OUT_BF16) {
        static_cast<bf16*>(y)[static_cast<size_t>(m) * N + n] = epilogue_bf16(v, s[n]);
      } else {
        static_cast<float*>(y)[static_cast<size_t>(m) * N + n] = v * s[n];
      }
    }
  }
  if (splits > 1) cluster.sync();  // peers stay resident until read
}

// f32 x: grid (ceil(N / 64), ceil(M / 16)), 256 threads; thread (tx, ty)
// owns channel n0 + tx and rows m0 + 4ty .. +3. f32 FMA, k ascending.
constexpr int kF32BN = 64, kF32BM = 16, kF32BK = 32;

template <int LAYOUT>
__global__ void __launch_bounds__(256)
    w8a16_gemm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                          const float* __restrict__ s, float* __restrict__ y, int M, int N,
                          int K) {
  __shared__ float xs[kF32BM][kF32BK + 1];
  __shared__ float wsh[kF32BK][kF32BN + 1];
  count_execution();
  const int tx = threadIdx.x % kF32BN, ty = threadIdx.x / kF32BN;
  const int n0 = blockIdx.x * kF32BN, m0 = blockIdx.y * kF32BM;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += kF32BK) {
    for (int e = threadIdx.x; e < kF32BM * kF32BK; e += 256) {
      const int mr = e / kF32BK, kr = e % kF32BK;
      const int m = m0 + mr, k = k0 + kr;
      xs[mr][kr] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : 0.f;
    }
    for (int e = threadIdx.x; e < kF32BK * kF32BN; e += 256) {
      int kr, nr;
      if (LAYOUT == kKN) {
        kr = e / kF32BN;
        nr = e % kF32BN;
      } else {
        nr = e / kF32BK;
        kr = e % kF32BK;
      }
      const int k = k0 + kr, n = n0 + nr;
      int8_t v = 0;
      if (k < K && n < N) {
        v = LAYOUT == kKN ? q[static_cast<size_t>(k) * N + n] : q[static_cast<size_t>(n) * K + k];
      }
      wsh[kr][nr] = static_cast<float>(v);
    }
    __syncthreads();
#pragma unroll 8
    for (int kr = 0; kr < kF32BK; ++kr) {
      const float w = wsh[kr][tx];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = fmaf(xs[4 * ty + r][kr], w, acc[r]);
    }
    __syncthreads();
  }
  const int n = n0 + tx;
  if (n < N) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + 4 * ty + r;
      if (m < M) y[static_cast<size_t>(m) * N + n] = acc[r] * s[n];
    }
  }
}

template <int LAYOUT, int BM, bool OUT_BF16>
cudaError_t launch_mma(const void* x, const void* q, const float* s, void* y, int M, int N,
                       int K, int splits, cudaStream_t stream) {
  constexpr int kBytes = Smem<BM>::kBytes;
  auto* kernel = w8a16_gemm_mma_kernel<LAYOUT, BM, OUT_BF16>;
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (smem_set != cudaSuccess) return smem_set;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x), static_cast<const int8_t*>(q), s, y, M, N, K,
      per);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int LAYOUT, bool OUT_BF16>
cudaError_t launch_mma_bm(const void* x, const void* q, const float* s, void* y, int M, int N,
                          int K, int bm, int splits, cudaStream_t stream) {
  if (bm == 8) return launch_mma<LAYOUT, 8, OUT_BF16>(x, q, s, y, M, N, K, splits, stream);
  if (bm == 32) return launch_mma<LAYOUT, 32, OUT_BF16>(x, q, s, y, M, N, K, splits, stream);
  if (bm == 64) return launch_mma<LAYOUT, 64, OUT_BF16>(x, q, s, y, M, N, K, splits, stream);
  return cudaErrorInvalidValue;
}

template <int LAYOUT>
cudaError_t launch_f32(const void* x, const void* q, const float* s, void* y, int M, int N,
                       int K, cudaStream_t stream) {
  const dim3 grid((N + kF32BN - 1) / kF32BN, (M + kF32BM - 1) / kF32BM);
  w8a16_gemm_f32_kernel<LAYOUT><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q), s, static_cast<float*>(y), M,
      N, K);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Large-M layer products (prefill): w8a16_gemm_wgmma_kernel
//
// bf16 x, layout KN, bf16 y, M >= the wrapper's threshold (ops/w8a16.py
// route). mma.sync cannot reach Hopper's tensor-core rate, and the mma
// kernel above dequantizes each weight tile once per 64 activation rows;
// this kernel feeds wgmma from TMA and converts each weight fragment once
// per BR (128 or 256) activation rows.
//   * Roles. Block = 3 warpgroups: two consumers (64 output channels each,
//     so a block covers 128 channels x BR activation rows) and one
//     producer whose single thread issues the TMA copies. setmaxnreg moves
//     registers from the producer (40) to the consumers (232), whose
//     accumulators take BR / 2 registers.
//   * Copies. TMA loads the bf16 x tile [BR rows][64 k] and the int8 weight
//     tile [64 k][128 channels], both with the 128-byte swizzle, into a ring
//     of stages (as many as fit in 227 KB, up to 8); an mbarrier per stage
//     counts the bytes in (full) and the 256 consumer threads out (empty).
//     The tensor maps are encoded on the host per call (the driver's
//     cuTensorMapEncodeTiled, fetched through the runtime, so no -lcuda) and
//     passed as __grid_constant__ parameters; TMA writes zeros past the
//     matrix, which covers a ragged M, N or K.
//   * Products. Swapped operands, as in the mma kernel: the weights are
//     wgmma's 64-row A operand (output channels in its rows), dequantized
//     from shared memory straight into A's register fragments; the x tile
//     is B, read by wgmma from shared memory through a descriptor (K-major,
//     128-byte swizzle), with the activation rows as wgmma's N (BR). A's k
//     order is wgmma's own (B's is fixed by its layout), so the A rows are
//     permuted instead: rows 16w + g and 16w + g + 8 of warp w are the
//     channel pair (2(8w + g), +1) of the warpgroup's 64, a 16-bit word of
//     the int8 tile. Two ldmatrix.trans a stage give a thread its pair at
//     16 k (a word holds both channels at k and k + 1); it converts them
//     (dq4: the exponent trick, exact for |q| <= 127), and each converted
//     fragment feeds BR activation rows.
//   * Overlap. Each consumer warpgroup keeps one stage's products in flight
//     (wait_group 1) while it converts the next stage's fragments.
//   * Tile order. blockIdx.x walks the activation-row tiles, so the blocks
//     that run together share a weight panel (K x 128 int8) in L2 and every
//     weight byte comes from device memory about once; x (M x K bf16) is
//     the operand read again, once per channel tile, mostly from L2.
//   * Split K for small grids (wk and wv at 8B: 8 channel tiles): as in the
//     mma kernel, `splits` blocks of a cluster along z each sum a range of
//     k tiles and merge their f32 partial tiles through distributed shared
//     memory in rank order. Deterministic: no float atomics. The wrapper
//     picks BR and splits from a cost model that counts the waves the card
//     needs for clusters of that size (cudaOccupancyMaxActiveClusters).
//   * Epilogue. The f32 tile goes through shared memory (the pipeline's
//     bytes, once every stage is consumed), then y = bf16(bf16(acc) *
//     bf16(s)), stored two channels a thread, coalesced along n.

constexpr int kWgBN = 128;          // output channels per block (64 per consumer warpgroup)
constexpr int kWgBK = 64;           // k per stage: one 128-byte swizzle row of bf16 x
constexpr int kWgThreads = 384;     // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kWgConsumers = 256;   // consumer threads
constexpr int kSmemPerBlock = 232448;  // 227 KB, the most a block may use

template <int BR>
struct WgSmem {
  static constexpr int kXBytes = BR * kWgBK * 2;  // x tile [BR][64] bf16
  static constexpr int kWBytes = kWgBK * kWgBN;   // weight tile [64][128] int8
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kFit = (kSmemPerBlock - 1024 - 16 * 8) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kRedStride = kWgBN + 4;  // f32 per row of the output tile
  static constexpr int kRedBytes = BR * kRedStride * 4;
  static constexpr int kPipeBytes = kStages * kStageBytes;
  static constexpr int kBarOffset = kPipeBytes > kRedBytes ? kPipeBytes : kRedBytes;
  // 1024: slack to align the stages to the swizzle's 1024-byte period
  static constexpr int kBytes = 1024 + kBarOffset + 2 * kStages * 8;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 inner, c1 outer) of `map` into shared memory at dst,
// its bytes counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows and
// the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups
// 1024 bytes apart; the tile starts on a 1024-byte boundary. +2 advances k
// by 16 bf16 (32 bytes).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// four 8 x 8 matrices of 16-bit words from shared memory, transposed: lane L
// gives the address of row L % 8 of matrix L / 8 and gets, in r[j], matrix j's
// elements (2 (L % 4), L / 4) and (2 (L % 4) + 1, L / 4)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// dq4 of a word of bytes {(k, n), (k, n + 1), (k + 1, n), (k + 1, n + 1)},
// returned as f = {(k, n), (k + 1, n), (k, n + 1), (k + 1, n + 1)}
__device__ __forceinline__ void dq4_kpairs(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = dq_byte(u, 0x7650);
  f[1] = dq_byte(u, 0x7652);
  f[2] = dq_byte(u, 0x7651);
  f[3] = dq_byte(u, 0x7653);
}

// the consumer warpgroups only (barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumers) : "memory");
}

// d[64 x 128] += a[64 x 16] (registers) * b[16 x 128] (shared memory, K-major,
// 128-byte swizzle), bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 256] += a[64 x 16] (registers) * b[16 x 256] (shared memory, K-major,
// 128-byte swizzle), bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int BR>
__device__ __forceinline__ void wgmma_tile(float (&d)[BR / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (BR == 256) {
    wgmma_n256(d, a, desc_b);
  } else {
    wgmma_n128(d, a, desc_b);
  }
}

// Diagnostic timeline (tools/torch_w8a16_sweep.py --timeline): given a
// buffer, each block stamps %globaltimer at its phases into kWgTraceSlots
// words (slot 0 start, 1 first stage landed in consumer 0, 2 main loop end,
// 3 partial tile written (after the first cluster barrier when split), 4
// end; 5 the SM, 6 the block's k tiles), and block (0, 0, 0) stamps up to
// kWgTraceTiles k tiles after the blocks' slots: the producer's issue, then
// consumer thread 0 before and after its wait for the stage, and after its
// wait_group 1 in that stage's step. Serving passes none.
constexpr int kWgTraceSlots = 8;
constexpr int kWgTraceTiles = 256;
unsigned long long* wgmma_trace = nullptr;  // host side, set for one launch

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// grid (ceil(M / BR), ceil(N / kWgBN), splits); splits > 1 runs as clusters
// (1, 1, splits)
template <int BR>
__global__ void __launch_bounds__(kWgThreads, 1)
    w8a16_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                            const __grid_constant__ CUtensorMap tmap_q,
                            const float* __restrict__ s, bf16* __restrict__ y, int M, int N,
                            int K, int k_tiles_per_split, unsigned long long* trace) {
  using L = WgSmem<BR>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* xs = smem;                                // kStages x tiles
  uint8_t* wsm = smem + L::kStages * L::kXBytes;     // kStages weight tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + L::kStages;
  count_execution();
  const int m0 = blockIdx.x * BR, n0 = blockIdx.y * kWgBN;
  const int splits = gridDim.z;
  const int k_tiles = (K + kWgBK - 1) / kWgBK;
  const int kt0 = blockIdx.z * k_tiles_per_split;
  const int nkt = max(min(kt0 + k_tiles_per_split, k_tiles) - kt0, 0);
  // this block's stamps (thread 0), and block (0, 0, 0)'s per-tile ones
  unsigned long long* tiles = nullptr;
  if (trace != nullptr) {
    const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    if (blk == 0) tiles = trace + kWgTraceSlots * gridDim.x * gridDim.y * gridDim.z;
    trace += kWgTraceSlots * blk;
    if (threadIdx.x == 0) {
      trace[0] = global_ns();
      trace[5] = sm_id();
      trace[6] = nkt;
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();

  if (threadIdx.x >= kWgConsumers) {
    // producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == kWgConsumers) {
      for (int it = 0; it < nkt; ++it) {
        const int st = it % L::kStages;
        if (it >= L::kStages) mbar_wait(&empty[st], ((it / L::kStages) - 1) & 1);
        mbar_expect_tx(&full[st], L::kStageBytes);
        if (tiles != nullptr && it < kWgTraceTiles) tiles[4 * it] = global_ns();
        const int k = (kt0 + it) * kWgBK;
        tma_load_2d(xs + st * L::kXBytes, &tmap_x, k, m0, &full[st]);
        tma_load_2d(wsm + st * L::kWBytes, &tmap_q, n0, k, &full[st]);
      }
    }
    if (splits > 1) {  // the consumers' two cluster barriers
      cluster.sync();
      cluster.sync();
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    // A rows 16 warp + g and 16 warp + g + 8 are channels p and p + 1 of the block
    const int p = 64 * wg + 16 * warp + 2 * g;
    float acc[BR / 2];
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) acc[i] = 0.f;

    // thread 0's per-tile stamps in block (0, 0, 0)
    unsigned long long* my_tiles = threadIdx.x == 0 ? tiles : nullptr;
    // A fragments of stage `it`: a[ks] = {(row g, k 16ks + 2c, +1), (row g + 8,
    // same), (row g, k + 8, +9), (row g + 8, same)}. One ldmatrix.x4.trans
    // reads four 8 x 8 matrices of 16-bit words (rows k, columns the warp's
    // eight channel pairs): lane L gives the row address of matrix L / 8, row
    // k = 32 h + 8 (L / 8) + L % 8 (the swizzle puts byte (k, n) at k * 128 +
    // 16 ((n >> 4) ^ (k & 7)) + (n & 15)), and gets in register j the pair g
    // at k = 2c and 2c + 1 of matrix j: matrices 0, 1 are step 2h (k 0-7,
    // 8-15), 2, 3 step 2h + 1.
    const int chunk = 4 * wg + warp;  // the warp's 16 channels: one 16-byte chunk a row
    auto dequant = [&](uint32_t(&a)[4][4], int it) {
      const int st = it % L::kStages;
      const bool stamp = my_tiles != nullptr && it < kWgTraceTiles;
      if (stamp) my_tiles[4 * it + 1] = global_ns();
      mbar_wait(&full[st], (it / L::kStages) & 1);
      if (stamp) my_tiles[4 * it + 2] = global_ns();
      const uint8_t* ws = wsm + st * L::kWBytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 32 * h + 8 * (lane >> 3) + (lane & 7);
        uint32_t r[4];
        ldsm_x4_trans(r, ws + k * kWgBN + ((chunk ^ (lane & 7)) << 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float f[4];
          dq4_kpairs(r[j], f);
          a[2 * h + (j >> 1)][2 * (j & 1)] = pack_bf16(f[0], f[1]);
          a[2 * h + (j >> 1)][2 * (j & 1) + 1] = pack_bf16(f[2], f[3]);
        }
      }
    };
    // Stage `it`: its products from `a` join the previous stage's, still in
    // flight; once those are done (wait_group 1) the previous stage goes back
    // to the producer and its fragments' registers, `a_prev`, take the next
    // stage's. The tensor cores always hold one stage's products of this
    // warpgroup while it converts the next. The empty asm statements keep acc
    // and the fragments live across the asynchronous products, so the compiler
    // neither reads acc nor reuses a fragment's registers before its wait.
    auto step = [&](uint32_t(&a)[4][4], uint32_t(&a_prev)[4][4], int it) {
      const uint64_t desc = smem_desc_sw128(xs + (it % L::kStages) * L::kXBytes);
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgBK / 16; ++ks) wgmma_tile<BR>(acc, a[ks], desc + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();
      if (my_tiles != nullptr && it < kWgTraceTiles) my_tiles[4 * it + 3] = global_ns();
#pragma unroll
      for (int ks = 0; ks < kWgBK / 16; ++ks) {
        asm volatile("" : "+r"(a_prev[ks][0]), "+r"(a_prev[ks][1]), "+r"(a_prev[ks][2]),
                     "+r"(a_prev[ks][3])::"memory");
      }
      if (it > 0) mbar_arrive(&empty[(it - 1) % L::kStages]);
      if (it + 1 < nkt) dequant(a_prev, it + 1);
    };
    uint32_t a0[4][4], a1[4][4];
    if (nkt > 0) dequant(a0, 0);
    if (trace != nullptr && threadIdx.x == 0) trace[1] = global_ns();
    for (int it = 0; it < nkt; it += 2) {
      step(a0, a1, it);
      if (it + 1 < nkt) step(a1, a0, it + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
#pragma unroll
    for (int ks = 0; ks < kWgBK / 16; ++ks) {
      asm volatile("" : "+r"(a0[ks][0]), "+r"(a0[ks][1]), "+r"(a0[ks][2]), "+r"(a0[ks][3]),
                   "+r"(a1[ks][0]), "+r"(a1[ks][1]), "+r"(a1[ks][2]), "+r"(a1[ks][3])::"memory");
    }
    if (trace != nullptr && threadIdx.x == 0) trace[2] = global_ns();
    consumers_sync();  // both warpgroups are done with the pipeline: reuse it

    // this block's partial tile [BR][kWgBN] (f32): acc[4j + e] is channel p + (e >> 1),
    // activation row 8j + 2c + (e & 1)
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      const int r = 8 * j + 2 * c;
      *reinterpret_cast<float2*>(red + r * L::kRedStride + p) =
          make_float2(acc[4 * j], acc[4 * j + 2]);
      *reinterpret_cast<float2*>(red + (r + 1) * L::kRedStride + p) =
          make_float2(acc[4 * j + 1], acc[4 * j + 3]);
    }

    // each block of the cluster finishes a share of the tile's rows: the sum
    // over the cluster's partial tiles in rank order, then the epilogue.
    // Thread t owns the channel pair 2 (t % 64), +1 (its scales load once)
    // in every fourth row from t / 64.
    int r_lo = 0, r_hi = BR;
    if (splits > 1) {
      cluster.sync();
      const int r = static_cast<int>(cluster.block_rank());
      r_lo = r * BR / splits;
      r_hi = (r + 1) * BR / splits;
    } else {
      consumers_sync();
    }
    if (trace != nullptr && threadIdx.x == 0) trace[3] = global_ns();
    const int nr = 2 * (threadIdx.x & 63), n = n0 + nr;
    if (n < N) {
      const float s0 = s[n], s1 = s[n + 1];
      const int m_end = min(r_hi, M - m0);
#pragma unroll 4
      for (int mr = r_lo + static_cast<int>(threadIdx.x >> 6); mr < m_end; mr += 4) {
        const int idx = mr * L::kRedStride + nr;
        float2 v = splits > 1
                       ? *reinterpret_cast<const float2*>(cluster.map_shared_rank(red, 0) + idx)
                       : *reinterpret_cast<const float2*>(red + idx);
        for (int rk = 1; rk < splits; ++rk) {
          const float2 o =
              *reinterpret_cast<const float2*>(cluster.map_shared_rank(red, rk) + idx);
          v.x += o.x;
          v.y += o.y;
        }
        __nv_bfloat162 out;
        out.x = epilogue_bf16(v.x, s0);
        out.y = epilogue_bf16(v.y, s1);
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(m0 + mr) * N + n) = out;
      }
    }
    if (trace != nullptr && threadIdx.x == 0) trace[4] = global_ns();
    if (splits > 1) cluster.sync();  // peers stay resident until read
  }
}

using EncodeTiledFn = decltype(&cuTensorMapEncodeTiled);

// the driver's cuTensorMapEncodeTiled, fetched once through the runtime
EncodeTiledFn encode_tiled(cudaError_t* err) {
  static EncodeTiledFn fn = nullptr;
  static const cudaError_t status = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && (found != cudaDriverEntryPointSuccess || ptr == nullptr)) {
      e = cudaErrorNotSupported;
    }
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
    return e;
  }();
  *err = status;
  return fn;
}

// a 2-D row-major tensor [outer][inner] with rows `row_bytes` apart, read in
// boxes [box_outer][box_inner] under the 128-byte swizzle
cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                      uint64_t inner, uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                      uint32_t box_outer) {
  cudaError_t err;
  const EncodeTiledFn fn = encode_tiled(&err);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BR>
cudaError_t launch_wgmma(const void* x, const void* q, const float* s, void* y, int M, int N,
                         int K, int splits, cudaStream_t stream) {
  using L = WgSmem<BR>;
  auto* kernel = w8a16_gemm_wgmma_kernel<BR>;
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (smem_set != cudaSuccess) return smem_set;
  CUtensorMap map_x, map_q;
  cudaError_t err = encode_2d(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                              static_cast<uint64_t>(K) * 2, kWgBK, BR);
  if (err != cudaSuccess) return err;
  err = encode_2d(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N, kWgBN, kWgBK);
  if (err != cudaSuccess) return err;
  const int k_tiles = (K + kWgBK - 1) / kWgBK;
  const int per = (k_tiles + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.gridDim = dim3((M + BR - 1) / BR, (N + kWgBN - 1) / kWgBN, splits);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, map_x, map_q, s, static_cast<bf16*>(y), M, N, K, per,
                           wgmma_trace);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// y = (x @ q) * s on `stream` (loaded with ctypes). x [M, K] row-major
// (x_dtype 0 = float32, 1 = bfloat16); q int8 [K, N] (layout 0) or [N, K]
// (layout 1); s f32 [N]; y [M, N] row-major, bf16 with the layer epilogue
// when out_bf16 (bf16 x only), else f32 acc * s. bf16 x takes the
// tensor-core kernel with BM = bm (8, 32 or 64) activation rows a block
// and K split over `splits` (1..8) blocks of a cluster; f32 x the FMA
// kernel (bm and splits unused). The caller checks shapes, K % 16 == 0,
// N % 16 == 0 and 16-byte alignment. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for an unsupported combination).
extern "C" int w8a16_gemm_launch(const void* x, const void* q, const void* s, void* y,
                                 int x_dtype, int out_bf16, int layout, int M, int N, int K,
                                 int bm, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0 || layout < 0 || layout > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_dtype == 0) {
    if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(layout == kKN ? launch_f32<kKN>(x, q, sc, y, M, N, K, st)
                                          : launch_f32<kNK>(x, q, sc, y, M, N, K, st));
  }
  if (x_dtype != 1 || splits < 1 || splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (layout == kKN) {
    err = out_bf16 ? launch_mma_bm<kKN, true>(x, q, sc, y, M, N, K, bm, splits, st)
                   : launch_mma_bm<kKN, false>(x, q, sc, y, M, N, K, bm, splits, st);
  } else {
    err = out_bf16 ? launch_mma_bm<kNK, true>(x, q, sc, y, M, N, K, bm, splits, st)
                   : launch_mma_bm<kNK, false>(x, q, sc, y, M, N, K, bm, splits, st);
  }
  return static_cast<int>(err);
}

// y = bf16(bf16(x @ q) * bf16(s)) on `stream` by the wgmma kernel (loaded with
// ctypes): x bf16 [M, K] row-major, q int8 [K, N] (layout KN), s f32 [N], y
// bf16 [M, N]; BR = br (128 or 256) activation rows a block and K split over
// `splits` (1..8) blocks of a cluster. The caller checks shapes, K % 16 == 0,
// N % 16 == 0 and 16-byte alignment. Returns the cudaError_t of the tensor
// maps' encoding and the launch (cudaErrorInvalidValue for an unsupported
// combination).
extern "C" int w8a16_gemm_wgmma_launch(const void* x, const void* q, const void* s, void* y,
                                       int M, int N, int K, int br, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0 || splits < 1 ||
      splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (br == 128) return static_cast<int>(launch_wgmma<128>(x, q, sc, y, M, N, K, splits, st));
  if (br == 256) return static_cast<int>(launch_wgmma<256>(x, q, sc, y, M, N, K, splits, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a wgmma kernel block with BR = br, and its
// pipeline depth into *stages (0 for an unsupported br).
extern "C" int w8a16_gemm_wgmma_smem(int br, int* stages) {
  if (br == 128) {
    *stages = WgSmem<128>::kStages;
    return WgSmem<128>::kBytes;
  }
  if (br == 256) {
    *stages = WgSmem<256>::kStages;
    return WgSmem<256>::kBytes;
  }
  *stages = 0;
  return 0;
}

// Give the next wgmma launches a timeline buffer (kWgTraceSlots u64 per
// block, then 4 x kWgTraceTiles for block (0, 0, 0)), or none (null), for
// tools/torch_w8a16_sweep.py. Returns kWgTraceSlots.
extern "C" int w8a16_gemm_set_trace(void* buf) {
  wgmma_trace = static_cast<unsigned long long*>(buf);
  return kWgTraceSlots;
}

// How many clusters of `splits` wgmma blocks with BR = br the current device
// runs at once (cudaOccupancyMaxActiveClusters), into *out. Returns the
// cudaError_t.
extern "C" int w8a16_gemm_wgmma_max_clusters(int br, int splits, int* out) {
  *out = 0;
  if ((br != 128 && br != 256) || splits < 1 || splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = br == 128 ? WgSmem<128>::kBytes : WgSmem<256>::kBytes;
  const void* kernel = br == 128 ? reinterpret_cast<const void*>(w8a16_gemm_wgmma_kernel<128>)
                                 : reinterpret_cast<const void*>(w8a16_gemm_wgmma_kernel<256>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.gridDim = dim3(1, 1, splits);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

// The kernels' executions on the current device since the library loaded
// or the last reset, into *out; with reset != 0 the count goes back to 0
// after the read. Copies through the legacy default stream (the caller
// synchronises first). Returns the cudaError_t.
extern "C" int w8a16_gemm_executed(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_executed, sizeof(g_executed));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_executed, &zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
