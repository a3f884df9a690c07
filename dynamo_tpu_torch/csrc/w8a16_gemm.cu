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
