// Whole eval-mode GCN+TCN block (K5) for Hopper (sm_90a), f32.
//
// Replaces tamgcn_tpu/ops/pallas/gcn_tcn_block.py:_block_kernel (launched by
// gcn_tcn_block_fused) and computes the same function. With every eval
// BatchNorm folded into the 1x1 conv beside it:
//
//   x3     = x @ W3 + b3                          (S subsets packed, S*C wide)
//   y      = sum_s sum_v M_s[u,v,c] x3[t,v,s*C+c]  (the unit CTR-GC op, K1's)
//   y      = y * gy[0] + gy[1]                    (unit_gcn BN)
//   res    = x  |  x @ Wd + bd                    (identity | folded down conv)
//   off    = tanh((res - y) @ Wo + bo)            (TAM offset conv, folded)
//   h      = relu(y + off + res)
//   prefix = relu(h @ Wp + bp)                    (TCN entry conv, folded)
//   pw     = h @ Wpw + bpw                        (TCN 1x1 branch, folded)
//
// with M_s[n,u,v,c] = (tanh(x1s[n,s,u,:] - x2s[n,s,v,:]) @ w4s[s] + b4s[s,c])
// * alpha + As[s,u,v]. The refined adjacency M and h never go to device
// memory; x3 and y do (see below).
//
// What bounds it on this card. At the deep NW-UCLA blocks (N=64, T=13, V=20,
// Cin=C=256, R=32, P=192, BC=64) it moves ~34 MB (x in, prefix and pw out:
// ~10 us at 3.35 TB/s) and does ~12.7 GFLOP, 86% of it in the five 1x1-conv
// products (52% in x3 alone): ~77 us at the 165 TFLOP/s of f32 products on
// the tensor cores as 3xTF32. The operations bound it at every shape of the
// model. The design before this one ran every product on the CUDA cores and
// computed x3 inside the channel-tiled phase: one block of 8 warps an SM
// (M, the x3 chunk and the x chunks fill ~140 KB), its stage 1 and
// aggregation held by latency at half of K1's occupancy, and its epilogue
// products held by loads (one read-only-cache load per k).
//
// What the design does about it. The TPU kernel keeps M of whole samples for
// all S*C channels in VMEM (1.2 MB per sample at C=256); a Hopper block has
// 227 KB, and the epilogue's products mix all C channels of a row, so one
// block cannot own both a channel tile and a row. Three kernels, one launch
// of the wrapper, x3 and y passing through the wrapper's scratch:
//   x3 (block_x3_kernel): x @ W3 + b3 in 64 x 64 output tiles, 4 warps of
//   32 x 32 on the tensor cores as 3xTF32 with the operands staged by
//   cp.async (mma_tf32x3.cuh: tile_product, also K6's), several blocks an
//   SM; written to scratch (N*T*V*S*C floats).
//   The aggregation (block_agg_kernel): K1's kernels as they are
//   (unit_ctr_gc_fwd.cuh, unit_ctr_gc_whole.cuh), under K5's names: a block
//   per (sample, 16 channels, tile of <= 16 frames) builds M_s of its
//   channels for each subset in turn and aggregates its frames of x3, both
//   on the tensor cores; writes y, before the unit_gcn BN.
//   The epilogue (block_epilogue_kernel): a block per BR rows (n, t, v) with
//   all C channels, 128 rows at C = 64, else 32 (two blocks an SM up to C ~
//   360), 16 where 32 do not fit: res (x, or x @ Wd), res - y' (y' = y *
//   gy0 + gy1), off, h in shared memory (h overwrites res in place), then
//   prefix and pw, one product of h with [Wp | Wpw], straight to device
//   memory. Its products run on the tensor cores as 3xTF32 in passes of 64
//   or 128 columns (8 warps), the A operand from the block's rows in shared
//   memory, the weights staged by cp.async in chunks of 32 rows, the next
//   one copied while this one is multiplied, every warp on whole tiles (no
//   test in the loop). Where even 16 rows of all channels do not fit (C or
//   Cin past ~1500) the rows-of-4 design with its products on the CUDA
//   cores runs instead (block_epilogue_wide_kernel).
// The round trips: x3 (N*T*V*S*C floats written, then read by the
// aggregation: ~51 MB each way at the deep blocks, ~15 us at 3.35 TB/s each
// way) and y (~17 MB each way). They stay because a row tile of all channels
// cannot keep M beside it, and because the first form of this design, x3
// computed in the channel-tiled phase on the tensor cores, was slower than
// the earlier kernel at every block (one block an SM): three mma.sync
// products per f32 product leave the tensor cores' gain over the CUDA cores
// small, so the products gain only where they stop waiting.
// Left for later work: wgmma (the way past mma.sync's rate); a persistent
// grid.
//
// The bf16 form (gcn_tcn_block_bf16): x, prefix and pw bf16, every other
// operand f32, and the JAX kernel's bf16 body (`mm = bf16`,
// tamgcn_tpu/ops/pallas/gcn_tcn_block.py:52-149): every product takes both
// operands rounded to bf16 and sums in f32, and the rest stays f32. The same
// three kernels, templated on x's and the outputs' type:
//   x3: x read as bf16 and widened as it is staged, w3 rounded to bf16 in
//   the fragments, one TF32 product a term (a bf16 value is exact in TF32,
//   so that is the bf16 x bf16 product; mma_tf32x3.cuh Operands::kBf16),
//   written as f32: the aggregation reads the unrounded x3, as the JAX
//   kernel's f32 scratch holds it;
//   the aggregation: K1's bodies on f32 x1s, x2s and x3 with stage 1's bf16
//   policy (D and w4s rounded to bf16, Stage1::kBf16), under the names
//   block_agg_bf16_kernel and block_agg_bf16_kernel_tiled (the unit op's
//   own bf16 form reads a bf16 x3);
//   the epilogue: the identity residual widened from the bf16 x; the A rows
//   of the products (x, res - y, h) rounded to bf16 where they are staged
//   and the weights in the fragments, one TF32 product a term; prefix and pw
//   rounded once to bf16 as they are stored.
// Its scratch is the f32 form's (x3 and y f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_tf32x3.cuh"
#include "unit_ctr_gc_fwd.cuh"

namespace {

using namespace unit_ctr_gc;
namespace mm = mma_tf32x3;
using bf16 = __nv_bfloat16;

// the products of the epilogue on x's type: 3xTF32 in f32, the bf16 product
// (both operands rounded to bf16) in bf16
template <typename TX>
constexpr mm::Operands kProducts =
    std::is_same_v<TX, bf16> ? mm::Operands::kBf16 : mm::Operands::kF32;

// a value staged as a product's A operand: rounded to bf16 in the bf16 form
template <typename TX>
__device__ inline float operand(float v) {
  return std::is_same_v<TX, bf16> ? bf16_round(v) : v;
}

constexpr int kMaxV = 28;  // the joints K5 was sized and checked at
constexpr int kStages = 2;  // weight chunk buffers of phase B's products
constexpr int kBK = 32;   // weight rows per staged chunk in phase B
constexpr int kXK = 32;   // input channels per staged chunk of the x3 product
constexpr int kBRItems = 512;  // 4x4 tiles of the wide phase B block's C x C product
constexpr int kNI = 2;    // 4x4 output tiles per thread per pass of block_gemm

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round32(int a) { return (a + 31) / 32 * 32; }

__device__ inline float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// ---- x3 = x @ W3 + b3: 64 x 64 tiles on the tensor cores ----

// kVec: Cin % 4 == 0 (16-byte copies of x's rows, 8-byte loads in bf16); on
// a bf16 x the bf16 product (mma_tf32x3.cuh: tile_product)
template <bool kVec, typename TX>
__global__ void __launch_bounds__(mm::kTileThreads)
block_x3_kernel(const TX* __restrict__ x, const float* __restrict__ w3,
                const float* __restrict__ b3, float* __restrict__ x3, int NR, int Cin, int SC) {
  extern __shared__ float4 smem4[];
  float* Ab = reinterpret_cast<float*>(smem4);
  float* Bb = Ab + 2 * mm::tile_chunk<kXK>();
  const int tiles_n = (SC + mm::kTileN - 1) / mm::kTileN;
  const int m0 = blockIdx.x / tiles_n * mm::kTileM, n0 = blockIdx.x % tiles_n * mm::kTileN;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  mm::tile_product<kXK, false, kVec, true>(x, Cin, NR, w3, SC, SC, m0, n0, 0, Cin, Ab, Bb, acc,
                                      [](const float*) {});
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 32 * wm + 16 * mt + lane / 4 + 8 * h;
        const int c = n0 + 32 * wn + 8 * nt + 2 * (lane % 4);
        if (r < NR && c < SC) {  // SC % 4 == 0: c + 1 < SC too
          *reinterpret_cast<float2*>(x3 + (size_t)r * SC + c) =
              make_float2(acc[mt][nt][2 * h] + __ldg(b3 + c), acc[mt][nt][2 * h + 1] + __ldg(b3 + c + 1));
        }
      }
}

// ---- the aggregation: K1's kernels (unit_ctr_gc_fwd.cuh) under K5's names ----

template <int RP, int JT>
__global__ void __launch_bounds__(kThreads, 2)
block_agg_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
                 const float* __restrict__ x3s, const float* __restrict__ w4s,
                 const float* __restrict__ b4s, const float* __restrict__ alpha,
                 const float* __restrict__ As, float* __restrict__ out, int S, int T, int V,
                 int R, int C) {
  whole::run<true, RP, JT, float>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, S, T, V, R, C);
}

template <int RP, int TF>
__global__ void __launch_bounds__(kThreads, 1)
block_agg_kernel_tiled(const float* __restrict__ x1s, const float* __restrict__ x2s,
                       const float* __restrict__ x3s, const float* __restrict__ w4s,
                       const float* __restrict__ b4s, const float* __restrict__ alpha,
                       const float* __restrict__ As, float* __restrict__ out,
                       const __grid_constant__ CUtensorMap xmap, int S, int T, int V, int R,
                       int C) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, 4);
  run<true, RP, TF, CT, float>(x1s, x2s, x3s, w4s, b4s, alpha[0], As, out, &xmap, blockIdx.z, 0,
                               blockIdx.y * kJ, blockIdx.x * CT, S, T, V, R, C);
}

// the bf16 form's aggregation: f32 operands, stage 1's bf16 policy
template <int RP, int JT>
__global__ void __launch_bounds__(kThreads, 2)
block_agg_bf16_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
                      const float* __restrict__ x3s, const float* __restrict__ w4s,
                      const float* __restrict__ b4s, const float* __restrict__ alpha,
                      const float* __restrict__ As, float* __restrict__ out, int S, int T,
                      int V, int R, int C) {
  whole::run<true, RP, JT, float, float, float, Stage1::kBf16>(x1s, x2s, x3s, w4s, b4s, alpha,
                                                               As, out, S, T, V, R, C);
}

template <int RP, int TF>
__global__ void __launch_bounds__(kThreads, 1)
block_agg_bf16_kernel_tiled(const float* __restrict__ x1s, const float* __restrict__ x2s,
                            const float* __restrict__ x3s, const float* __restrict__ w4s,
                            const float* __restrict__ b4s, const float* __restrict__ alpha,
                            const float* __restrict__ As, float* __restrict__ out,
                            const __grid_constant__ CUtensorMap xmap, int S, int T, int V,
                            int R, int C) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, 4);
  run<true, RP, TF, CT, float, float, float, Stage1::kBf16>(
      x1s, x2s, x3s, w4s, b4s, alpha[0], As, out, &xmap, blockIdx.z, 0, blockIdx.y * kJ,
      blockIdx.x * CT, S, T, V, R, C);
}

struct AggLaunchBf16 {
  template <int RP, int JT>
  static int whole(dim3 grid, size_t smem, cudaStream_t st, const float* x1s, const float* x2s,
                   const float* x3s, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, float* out, int S, int T, int V, int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(block_agg_bf16_kernel<RP, JT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    block_agg_bf16_kernel<RP, JT><<<grid, kThreads, smem, st>>>(x1s, x2s, x3s, w4s, b4s, alpha,
                                                                 As, out, S, T, V, R, C);
    return cudaGetLastError();
  }
  template <int RP, int TF>
  static int tiled(dim3 grid, int smem, cudaStream_t st, const float* x1s, const float* x2s,
                   const float* x3s, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, float* out, const CUtensorMap& xmap, int S, int T, int V,
                   int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(block_agg_bf16_kernel_tiled<RP, TF>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    block_agg_bf16_kernel_tiled<RP, TF><<<grid, kThreads, smem, st>>>(
        x1s, x2s, x3s, w4s, b4s, alpha, As, out, xmap, S, T, V, R, C);
    return cudaGetLastError();
  }
};

struct AggLaunch {
  template <int RP, int JT, typename TA>
  static int whole(dim3 grid, size_t smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* x3s, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, TA* out, int S, int T, int V, int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(block_agg_kernel<RP, JT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    block_agg_kernel<RP, JT><<<grid, kThreads, smem, st>>>(x1s, x2s, x3s, w4s, b4s, alpha, As,
                                                            out, S, T, V, R, C);
    return cudaGetLastError();
  }
  template <int RP, int TF, typename TA>
  static int tiled(dim3 grid, int smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* x3s, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, TA* out, const CUtensorMap& xmap, int S, int T, int V,
                   int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(block_agg_kernel_tiled<RP, TF>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    block_agg_kernel_tiled<RP, TF><<<grid, kThreads, smem, st>>>(
        x1s, x2s, x3s, w4s, b4s, alpha, As, out, xmap, S, T, V, R, C);
    return cudaGetLastError();
  }
};

// ---- the epilogue ----

// out[r][c] = sum_k A[r][k] * W[k][c] for the BR rows of A (shared memory,
// row stride lda, columns k < round32(K) finite, zero from K on) and the
// columns c < ncols of W = [W0 | W1] (W0 K x n0, W1 K x (ncols - n0), n0
// and ncols multiples of 4, both 16-byte aligned, in device memory; W1 =
// W0 and n0 = ncols for one matrix), on the tensor cores as 3xTF32, in
// passes of kP (64 or 128) columns; W's chunks of kBK rows, zero past K and
// ncols, staged in Wb [kStages][kBK][kP + 8] by cp.async, the next one
// copied while this one is multiplied (kOp: the products a term takes,
// mma_tf32x3.cuh Operands). The 8 warps
// are MW x NW over BR rows and a pass (MW = 2, or 1 at BR = 16), each MT m
// tiles by NT n tiles, all whole: no test in the loop. For each pair of
// columns c, c + 1 < ncols of row r it calls epi(r, c, value of c, value of
// c + 1) once the pass is summed; rows past the block's own hold whatever A
// held there. Starts with a barrier, so Wb may be reused from one call to
// the next.
template <int BR, int kP, mm::Operands kOp, class Epi>
__device__ inline void block_product(const float* A, int lda, int K, const float* __restrict__ W0,
                                     int n0, const float* __restrict__ W1, int ncols, float* Wb,
                                     Epi epi) {
  constexpr int kMW = BR >= 32 ? 2 : 1, kNW = 8 / kMW;
  constexpr int kMT = BR / 16 / kMW, kNT = kP / kNW / 8;
  constexpr int kLd = kP + 8;  // 8 mod 32: conflict-free fragment loads
  static_assert(kMT >= 1 && kNT >= 1 && kMW * kMT * 16 == BR, "8 warps over BR rows x kP");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kNW, wn = warp % kNW;
  const int nkc = (K + kBK - 1) / kBK;
  const int nsteps = (ncols + kP - 1) / kP * nkc;
  auto stage = [&](int step) {
    if (step < nsteps) {
      const int c0 = step / nkc * kP, k0 = step % nkc * kBK;
      float* wb = Wb + step % kStages * kBK * kLd;
      for (int i = tid; i < kBK * kP / 4; i += kThreads) {
        const int k = i / (kP / 4), c = 4 * (i % (kP / 4)), col = c0 + c;
        const bool ok = k0 + k < K && col < ncols;
        const float* src = col < n0 ? W0 + (size_t)(k0 + k) * n0 + col
                                    : W1 + (size_t)(k0 + k) * (ncols - n0) + col - n0;
        mm::copy16(wb + k * kLd + c, ok ? src : W0, ok);
      }
    }
    mm::commit();
  };
  float acc[kMT][kNT][4];
  __syncthreads();  // the previous call's chunks are consumed
  for (int step = 0; step < kStages - 1; ++step) stage(step);
  for (int step = 0; step < nsteps; ++step) {
    const int kc = step % nkc, c0 = step / nkc * kP;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
    mm::wait<kStages - 2>();
    __syncthreads();  // the step's chunk is in; step - 1's buffer is consumed
    stage(step + kStages - 1);
    mm::warp_mma<kMT, kNT, false, kOp>(A + wm * kMT * 16 * lda + kc * kBK, lda,
                                  Wb + step % kStages * kBK * kLd + wn * kNT * 8, kLd, kBK / 8,
                                  acc);
    if (kc + 1 < nkc) continue;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm * kMT + mt) * 16 + lane / 4 + 8 * h;
          const int col = c0 + (wn * kNT + nt) * 8 + 2 * (lane % 4);
          if (col < ncols) epi(r, col, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
  }
}

// block_product in passes of 128 columns where ncols is a multiple of 128,
// else of 64 (no wasted pass at C=64 or P=192); always 64 at BR = 128
template <int BR, mm::Operands kOp, class Epi>
__device__ inline void block_product(const float* A, int lda, int K, const float* __restrict__ W0,
                                     int n0, const float* __restrict__ W1, int ncols, float* Wb,
                                     Epi epi) {
  if constexpr (BR == 128) {  // launched only where every width takes 64-column passes
    block_product<BR, 64, kOp>(A, lda, K, W0, n0, W1, ncols, Wb, epi);
  } else if (ncols % 128 == 0) {
    block_product<BR, 128, kOp>(A, lda, K, W0, n0, W1, ncols, Wb, epi);
  } else {
    block_product<BR, 64, kOp>(A, lda, K, W0, n0, W1, ncols, Wb, epi);
  }
}

// Phase B's row strides at (Cin, C): Rs [BR][ldr] (res, then h) and Ds
// [BR][ldd] (x when the residual is a conv, then res - y), 4 mod 32 so that a
// warp's fragment loads fall in distinct banks; shared memory in bytes.
__host__ __device__ inline int epi_ldr(int C) { return round32(C) + 4; }
__host__ __device__ inline int epi_ldd(int Cin, int C) { return round32(imax(Cin, C)) + 4; }
// The weight chunks' pass width: 128 where a product's width (C, or P + BC
// for [Wp | Wpw]) is a multiple of 128, else 64 (block_product).
__host__ __device__ inline int epi_pass(int C, int P, int BC) {
  return C % 128 == 0 || (P + BC) % 128 == 0 ? 128 : 64;
}
__host__ __device__ inline size_t epi_smem(int BR, int Cin, int C, int P, int BC) {
  return sizeof(float) * ((size_t)BR * (epi_ldr(C) + epi_ldd(Cin, C)) +
                          kStages * kBK * (epi_pass(C, P, BC) + 8));
}

// TX: the type of x, prefix and pw (f32, or bf16 with the bf16 products)
template <int BR, typename TX>
__global__ void __launch_bounds__(kThreads)
block_epilogue_kernel(const TX* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ gy, const float* __restrict__ wd,
                      const float* __restrict__ bd,
                      const float* __restrict__ wo, const float* __restrict__ bo,
                      const float* __restrict__ wp, const float* __restrict__ bp,
                      const float* __restrict__ wpw, const float* __restrict__ bpw,
                      TX* __restrict__ prefix, TX* __restrict__ pw, int NR, int Cin,
                      int C, int P, int BC) {
  constexpr mm::Operands kOp = kProducts<TX>;
  extern __shared__ float4 smem4[];
  const int ldr = epi_ldr(C), ldd = epi_ldd(Cin, C);
  float* Rs = reinterpret_cast<float*>(smem4);
  float* Ds = Rs + BR * ldr;
  float* Wb = Ds + BR * ldd;
  const int tid = threadIdx.x;
  const size_t r_base = (size_t)blockIdx.x * BR;
  const int rows = min(BR, NR - (int)r_base);
  const TX* xb = x + r_base * Cin;
  const float* yb = y + r_base * C;
  const int C8 = round32(C);  // the products read k < round32(K): zero past K

  // ---- res ----
  if (wd == nullptr) {  // identity (Cin == C)
    for (int i = tid; i < BR * C8; i += kThreads) {
      const int r = i / C8, k = i % C8;
      Rs[r * ldr + k] = r < rows && k < C ? Act<TX>::load(xb + (size_t)r * C + k) : 0.f;
    }
  } else {
    const int K8 = round32(Cin);
    for (int i = tid; i < BR * K8; i += kThreads) {
      const int r = i / K8, k = i % K8;
      Ds[r * ldd + k] = r < rows && k < Cin ? Act<TX>::load(xb + (size_t)r * Cin + k) : 0.f;
    }
    for (int i = tid; i < BR * (C8 - C); i += kThreads) {
      Rs[(i / (C8 - C)) * ldr + C + i % (C8 - C)] = 0.f;
    }
    __syncthreads();
    block_product<BR, kOp>(Ds, ldd, Cin, wd, C, wd, C, Wb, [&](int r, int c, float v0, float v1) {
      Rs[r * ldr + c] = v0 + __ldg(bd + c);
      Rs[r * ldr + c + 1] = v1 + __ldg(bd + c + 1);
    });
  }
  __syncthreads();
  // ---- res - y ----
  for (int i = tid; i < BR * C8; i += kThreads) {
    const int r = i / C8, k = i % C8;
    Ds[r * ldd + k] =
        r < rows && k < C
            ? operand<TX>(Rs[r * ldr + k] - fmaf(yb[(size_t)r * C + k], gy[k], gy[C + k]))
            : 0.f;
  }
  __syncthreads();
  // ---- off = tanh((res - y) @ Wo + bo); h = relu(y + off + res) into Rs ----
  block_product<BR, kOp>(Ds, ldd, C, wo, C, wo, C, Wb, [&](int r, int c, float v0, float v1) {
    if (r < rows) {
      const float2 yv = *reinterpret_cast<const float2*>(yb + (size_t)r * C + c);
      float* h = Rs + r * ldr + c;
      h[0] = operand<TX>(fmaxf(
          fmaf(yv.x, __ldg(gy + c), __ldg(gy + C + c)) + tanhf(v0 + __ldg(bo + c)) + h[0], 0.f));
      h[1] = operand<TX>(fmaxf(fmaf(yv.y, __ldg(gy + c + 1), __ldg(gy + C + c + 1)) +
                                   tanhf(v1 + __ldg(bo + c + 1)) + h[1],
                               0.f));
    }
  });
  __syncthreads();
  // ---- prefix = relu(h @ Wp + bp), pw = h @ Wpw + bpw: one product of h
  // with [Wp | Wpw] ----
  block_product<BR, kOp>(Rs, ldr, C, wp, P, wpw, P + BC, Wb, [&](int r, int c, float v0, float v1) {
    if (r < rows) {
      if (c < P) {
        Act<TX>::store2(prefix + (r_base + r) * P + c, fmaxf(v0 + __ldg(bp + c), 0.f),
                        fmaxf(v1 + __ldg(bp + c + 1), 0.f));
      } else {
        Act<TX>::store2(pw + (r_base + r) * BC + c - P, v0 + __ldg(bpw + c - P),
                        v1 + __ldg(bpw + c - P + 1));
      }
    }
  });
}

// ---- the wide phase B, for C or Cin where 16 rows of all channels do not
// fit a block: rows of 4, its products on the CUDA cores ----

// out[r, c..c+3] = sum_k A[r, k] * W[k, c..c+3] for the rows r < rows of A
// (shared memory, row stride lda, at least rows rounded up to 4 rows
// allocated) and the columns c < ncols (ncols % 4 == 0); W (ncols wide,
// 16-byte aligned) is read through the read-only cache. A thread computes
// kNI tiles of 4 x 4 in one pass over k (a tile past the last is computed
// again as the pass's first and not kept), and for each calls epi(r0, c,
// acc), acc[i] the 4 values of row r0 + i; rows past `rows` hold whatever A
// held there. kRound: W's values rounded to bf16 as they are read (the bf16
// form; its A rows are staged rounded).
template <bool kRound, class Epi>
__device__ inline void block_gemm(const float* A, int lda, int rows, int K,
                                  const float* __restrict__ W, int ncols,
                                  Epi epi) {
  auto wload = [&](const float* p) {
    const float4 w = ldg4(p);
    return kRound ? make_float4(bf16_round(w.x), bf16_round(w.y), bf16_round(w.z),
                                bf16_round(w.w))
                  : w;
  };
  const int ncq = ncols / 4;
  const int nitems = (rows + 3) / 4 * ncq;
  for (int base = threadIdx.x; base < nitems; base += kThreads * kNI) {
    int r0[kNI], c[kNI];
    float4 acc[kNI][4];
#pragma unroll
    for (int it = 0; it < kNI; ++it) {
      const int item = base + it * kThreads < nitems ? base + it * kThreads : base;
      c[it] = 4 * (item % ncq);
      r0[it] = 4 * (item / ncq);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[it][i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (kThreads % ncq == 0) {
      // every tile of the pass has the thread's columns: one weight load
      // serves them all
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        const float4 wk = wload(W + (size_t)k * ncols + c[0]);
#pragma unroll
        for (int it = 0; it < kNI; ++it) {
          const float* a = A + r0[it] * lda + k;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[it][i] = fma4(a[i * lda], wk, acc[it][i]);
        }
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int it = 0; it < kNI; ++it) {
          const float4 wk = wload(W + (size_t)k * ncols + c[it]);
          const float* a = A + r0[it] * lda + k;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[it][i] = fma4(a[i * lda], wk, acc[it][i]);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kNI; ++it) {
      if (base + it * kThreads < nitems) epi(r0[it], c[it], acc[it]);
    }
  }
}

// Shared memory: Rs [BR][C+4] (res, then h) and Ds [BR][max(Cin+1, C+4)]
// (x when the residual is a conv, then res - y). The row strides are padded
// so that the rows a warp reads sit in other banks.
__host__ __device__ inline int wide_ldr(int C) { return C + 4; }
__host__ __device__ inline int wide_region(int BR, int Cin, int C) {
  return BR * (wide_ldr(C) + imax(Cin + 1, wide_ldr(C)));
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
block_epilogue_wide_kernel(const TX* __restrict__ x, const float* __restrict__ y,
                           const float* __restrict__ gy, const float* __restrict__ wd,
                           const float* __restrict__ bd, const float* __restrict__ wo,
                           const float* __restrict__ bo, const float* __restrict__ wp,
                           const float* __restrict__ bp, const float* __restrict__ wpw,
                           const float* __restrict__ bpw, TX* __restrict__ prefix,
                           TX* __restrict__ pw, int NR, int Cin, int C, int P, int BC,
                           int BR) {
  constexpr bool kRound = std::is_same_v<TX, bf16>;
  extern __shared__ float4 smem4[];
  const int LDR = wide_ldr(C);
  float* Rs = reinterpret_cast<float*>(smem4);
  float* Ds = Rs + BR * LDR;
  const int tid = threadIdx.x;
  const size_t r_base = (size_t)blockIdx.x * BR;
  const int rows = min(BR, NR - (int)r_base);
  const TX* xb = x + r_base * Cin;
  const float* yb = y + r_base * C;

  // ---- res ----
  if (wd == nullptr) {  // identity (Cin == C)
    for (int i = tid; i < BR * C; i += kThreads) {
      Rs[(i / C) * LDR + i % C] = i / C < rows ? Act<TX>::load(xb + i) : 0.f;
    }
  } else {
    for (int i = tid; i < BR * Cin; i += kThreads) {
      Ds[(i / Cin) * (Cin + 1) + i % Cin] = i / Cin < rows ? Act<TX>::load(xb + i) : 0.f;
    }
    __syncthreads();
    block_gemm<kRound>(Ds, Cin + 1, BR, Cin, wd, C,
               [&](int r0, int c, const float4* acc) {
                 const float4 b = ldg4(bd + c);
#pragma unroll
                 for (int i = 0; i < 4; ++i) {
                   *reinterpret_cast<float4*>(Rs + (r0 + i) * LDR + c) =
                       make_float4(acc[i].x + b.x, acc[i].y + b.y,
                                   acc[i].z + b.z, acc[i].w + b.w);
                 }
               });
  }
  __syncthreads();
  // ---- res - y ----
  for (int i = tid; i < BR * C; i += kThreads) {
    const int r = i / C, k = i % C, o = r * LDR + k;
    Ds[o] = r < rows ? operand<TX>(Rs[o] - fmaf(yb[i], gy[k], gy[C + k])) : 0.f;
  }
  __syncthreads();
  // ---- off = tanh((res - y) @ Wo + bo); h = relu(y + off + res) into Rs ----
  block_gemm<kRound>(Ds, LDR, BR, C, wo, C, [&](int r0, int c, const float4* acc) {
    const float4 b = ldg4(bo + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < rows) {
        const float4 yr = *reinterpret_cast<const float4*>(yb + (r0 + i) * C + c);
        const float4 g0 = ldg4(gy + c), g1 = ldg4(gy + C + c);
        const float4 yv = make_float4(fmaf(yr.x, g0.x, g1.x), fmaf(yr.y, g0.y, g1.y),
                                      fmaf(yr.z, g0.z, g1.z), fmaf(yr.w, g0.w, g1.w));
        float4* h = reinterpret_cast<float4*>(Rs + (r0 + i) * LDR + c);
        const float4 r = *h;
        *h = make_float4(operand<TX>(fmaxf(yv.x + tanhf(acc[i].x + b.x) + r.x, 0.f)),
                         operand<TX>(fmaxf(yv.y + tanhf(acc[i].y + b.y) + r.y, 0.f)),
                         operand<TX>(fmaxf(yv.z + tanhf(acc[i].z + b.z) + r.z, 0.f)),
                         operand<TX>(fmaxf(yv.w + tanhf(acc[i].w + b.w) + r.w, 0.f)));
      }
    }
  });
  __syncthreads();
  // ---- prefix = relu(h @ Wp + bp); pw = h @ Wpw + bpw ----
  block_gemm<kRound>(Rs, LDR, BR, C, wp, P, [&](int r0, int c, const float4* acc) {
    const float4 b = ldg4(bp + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < rows) {
        Act<TX>::store4(prefix + (r_base + r0 + i) * P + c,
                        make_float4(fmaxf(acc[i].x + b.x, 0.f), fmaxf(acc[i].y + b.y, 0.f),
                                    fmaxf(acc[i].z + b.z, 0.f), fmaxf(acc[i].w + b.w, 0.f)));
      }
    }
  });
  block_gemm<kRound>(Rs, LDR, BR, C, wpw, BC, [&](int r0, int c, const float4* acc) {
    const float4 b = ldg4(bpw + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < rows) {
        Act<TX>::store4(pw + (r_base + r0 + i) * BC + c,
                        make_float4(acc[i].x + b.x, acc[i].y + b.y, acc[i].z + b.z,
                                    acc[i].w + b.w));
      }
    }
  });
}


template <typename TX>
int launch_x3(const TX* x, const float* w3, const float* b3, float* x3, int NR, int Cin,
              int SC, cudaStream_t stream) {
  const int blocks = (NR + mm::kTileM - 1) / mm::kTileM * ((SC + mm::kTileN - 1) / mm::kTileN);
  auto kernel = Cin % 4 == 0 ? block_x3_kernel<true, TX> : block_x3_kernel<false, TX>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mm::tile_smem_bytes<kXK>());
  if (err != cudaSuccess) return err;
  kernel<<<blocks, mm::kTileThreads, mm::tile_smem_bytes<kXK>(), stream>>>(x, w3, b3, x3, NR,
                                                                           Cin, SC);
  return cudaGetLastError();
}

template <int BR, typename TX>
int launch_epilogue_one(const TX* x, const float* y, const float* gy, const float* wd,
                        const float* bd,
                        const float* wo, const float* bo, const float* wp, const float* bp,
                        const float* wpw, const float* bpw, TX* prefix, TX* pw, int NR,
                        int Cin, int C, int P, int BC, cudaStream_t stream) {
  const size_t smem = epi_smem(BR, Cin, C, P, BC);
  cudaError_t err = cudaFuncSetAttribute(
      block_epilogue_kernel<BR, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block_epilogue_kernel<BR, TX><<<(NR + BR - 1) / BR, kThreads, smem, stream>>>(
      x, y, gy, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, NR, Cin, C, P, BC);
  return cudaGetLastError();
}

template <typename TX>
int launch_epilogue(const TX* x, const float* y, const float* gy, const float* wd,
                    const float* bd,
                    const float* wo, const float* bo, const float* wp, const float* bp,
                    const float* wpw, const float* bpw, TX* prefix, TX* pw, int NR,
                    int Cin, int C, int P, int BC, cudaStream_t stream) {
  // 128 rows where the passes are 64 columns wide and two blocks fit an SM
  // (C = 64): fewer blocks, each with more rows between barriers; else 32
  // (two blocks an SM up to C ~ 360), 16 where 32 do not fit
  if (epi_pass(C, P, BC) == 64 && 2 * epi_smem(128, Cin, C, P, BC) <= kSmemLimit) {
    return launch_epilogue_one<128>(x, y, gy, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, NR, Cin, C, P, BC, stream);
  }
  if (epi_smem(32, Cin, C, P, BC) <= kSmemLimit) {
    return launch_epilogue_one<32>(x, y, gy, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, NR, Cin, C, P, BC, stream);
  }
  if (epi_smem(16, Cin, C, P, BC) <= kSmemLimit) {
    return launch_epilogue_one<16>(x, y, gy, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, NR, Cin, C, P, BC, stream);
  }
  // the wide design: rows per block enough 4x4 tiles in the C x C product
  // for every thread, and what the block keeps within its shared memory
  int BR = imax(32, imin(128, kBRItems * 16 / C)) / 4 * 4;
  while (BR > 4 && sizeof(float) * (size_t)wide_region(BR, Cin, C) > (size_t)kSmemLimit) BR /= 2;
  const size_t smem = sizeof(float) * (size_t)wide_region(BR, Cin, C);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      block_epilogue_wide_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  block_epilogue_wide_kernel<TX><<<(NR + BR - 1) / BR, kThreads, smem, stream>>>(
      x, y, gy, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, NR, Cin, C, P, BC, BR);
  return cudaGetLastError();
}

// Floats of the scratch y that gcn_tcn_block_f32 needs: x3 (N,T,V,S*C),
// then y (N,T,V,C).
size_t scratch_floats(long long NR, int S, int C) {
  return ((size_t)NR * S * C + 3) / 4 * 4 + (size_t)NR * C;
}

// The three kernels of either form (L: the aggregation's launcher, AggLaunch
// or AggLaunchBf16), after the launcher's checks.
template <class L, typename TX>
int run_block(const TX* x, const float* x1s, const float* x2s, const float* w3,
              const float* b3, const float* w4s, const float* b4s, const float* alpha,
              const float* As, const float* gy, const float* wd, const float* bd,
              const float* wo, const float* bo, const float* wp, const float* bp,
              const float* wpw, const float* bpw, float* y, TX* prefix, TX* pw, int N, int S,
              int T, int V, int Cin, int R, int C, int P, int BC, void* stream) {
  const long long NR = (long long)N * T * V;
  if (N < 1 || N > 65535 || S < 1 || T < 1 || V < 1 || V > kMaxV || Cin < 1 || R < 1 ||
      R > 32 || C < 4 || C % 4 != 0 || P < 4 || P % 4 != 0 || BC < 4 || BC % 4 != 0 ||
      (wd == nullptr) != (bd == nullptr) || (wd == nullptr && Cin != C) ||
      NR * S * C > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* x3 = y;
  float* agg = y + scratch_floats(NR, S, C) - (size_t)NR * C;
  int err = launch_x3(x, w3, b3, x3, (int)NR, Cin, S * C, st);
  if (err != cudaSuccess) return err;
  err = fwd::run<L, float>(x1s, x2s, x3, w4s, b4s, alpha, As, agg, N, S, T, V, R, C, st);
  if (err != cudaSuccess) return err;
  return launch_epilogue(x, agg, gy, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, (int)NR, Cin,
                         C, P, BC, st);
}

}  // namespace

// All tensors contiguous f32 on the device, 16-byte aligned: x (N,T,V,Cin);
// x1s, x2s (N,S,V,R); w3 (Cin,S*C); b3 (S*C,); w4s (S,R,C); b4s (S,C);
// alpha (1,); As (S,V,V); gy (2,C); wd (Cin,C) and bd (C,), or both null for
// an identity residual (Cin == C); wo (C,C); bo (C,); wp (C,P); bp (P,);
// wpw (C,BC); bpw (BC,); y, scratch of N*T*V*(S+1)*C + 3 floats (x3, then
// the unit op's output); prefix (N,T,V,P); pw (N,T,V,BC). C, P and BC % 4
// == 0, R <= 32, V <= 28. Launches the three kernels on `stream` and
// returns the first non-zero cudaGetLastError() (0 = ok).
extern "C" int gcn_tcn_block_f32(
    const float* x, const float* x1s, const float* x2s, const float* w3,
    const float* b3, const float* w4s, const float* b4s, const float* alpha,
    const float* As, const float* gy, const float* wd, const float* bd,
    const float* wo, const float* bo, const float* wp, const float* bp,
    const float* wpw, const float* bpw, float* y, float* prefix, float* pw,
    int N, int S, int T, int V, int Cin, int R, int C, int P, int BC,
    void* stream) {
  return run_block<AggLaunch>(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wd, bd, wo, bo, wp,
                              bp, wpw, bpw, y, prefix, pw, N, S, T, V, Cin, R, C, P, BC, stream);
}

// The bf16 form (the header): x (N,T,V,Cin), prefix and pw bf16, 8-byte
// aligned; every other tensor and the scratch y as gcn_tcn_block_f32's.
extern "C" int gcn_tcn_block_bf16(
    const bf16* x, const float* x1s, const float* x2s, const float* w3,
    const float* b3, const float* w4s, const float* b4s, const float* alpha,
    const float* As, const float* gy, const float* wd, const float* bd,
    const float* wo, const float* bo, const float* wp, const float* bp,
    const float* wpw, const float* bpw, float* y, bf16* prefix, bf16* pw,
    int N, int S, int T, int V, int Cin, int R, int C, int P, int BC,
    void* stream) {
  return run_block<AggLaunchBf16>(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wd, bd, wo, bo,
                                  wp, bp, wpw, bpw, y, prefix, pw, N, S, T, V, Cin, R, C, P, BC,
                                  stream);
}
