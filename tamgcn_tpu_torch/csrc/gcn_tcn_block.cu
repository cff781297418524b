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
// operands rounded to bf16 and sums in f32, and the rest stays f32. What
// bounds it: the same work with the products at the bf16 rate (989
// TFLOP/s), so its bound is ~5x below the f32 form's, and a design that
// takes each product as one TF32 MMA of k = 8 on f32 rows (its first form)
// gains little over f32: the fragments are read one value at a time and W
// rounded at every load, the rows fill as much shared memory as f32's, and
// past C ~ 1500 the products ran on the CUDA cores. Its own kernels, four in
// one wrapper call:
//   the prologue (block_prologue_bf16_kernel): w3, wd, wo and [wp | wpw]
//   rounded to bf16 once a call into the wrapper's scratch, rows padded with
//   zeros to a multiple of 8 values (16-byte copies), and x padded so where
//   its rows are not 16-byte copies (Cin % 8, or x not 16-byte aligned);
//   x3 (block_x3_bf16_kernel): x @ W3 on bf16 MMAs (mma_bf16.cuh:
//   tile_product_bf16, K6-bf16's: 128 x 64 tiles, ldmatrix + mma.sync
//   m16n8k16, a cp.async ring of 64-k chunks), + b3, written as f32: the
//   aggregation reads the unrounded x3, as the JAX kernel's f32 scratch
//   holds it (rounding it fails the share criterion against JAX);
//   the aggregation: K1's bodies on f32 x1s, x2s and x3 with stage 1's bf16
//   policy (D and w4s rounded to bf16, Stage1::kBf16), under the names
//   block_agg_bf16_kernel and block_agg_bf16_kernel_tiled (its stage 2 is
//   f32 x f32, 3xTF32, as the JAX kernel computes it);
//   the epilogue (block_epilogue_bf16_kernel): the f32 form's row tiles with
//   every product's A rows bf16 in shared memory (res - y and h each rounded
//   once where they are written, h over the f32 res in place, a pass's h
//   written after a barrier once the pass has read its res); the block's
//   rows of x and y arrive by 16-byte cp.async at its start, all in flight
//   at once (read where they were needed, their loads waited one phase at a
//   time); the products are bf16 MMAs (ldmatrix + m16n8k16) on bf16 weight
//   chunks fed by a three-deep cp.async ring; rows a block: the most of
//   128, 64, 32 that fit two blocks an SM (128 at C = 64, 64 at C = 128, 32
//   at C = 256), else of 64, 32, 16 that fit one; y's rows are read from
//   device memory where even 16 rows do not fit beside them (C past
//   ~1500), so the f32 form's wide design has no bf16 counterpart (C =
//   2048 runs at 16 rows; past C ~ 2200 the form is refused); prefix and pw
//   rounded once to bf16 as they are stored.
// Its scratch is the f32 form's (x3 and y f32), then the bf16 operands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "unit_ctr_gc_fwd.cuh"

namespace {

using namespace unit_ctr_gc;
namespace mm = mma_tf32x3;
namespace mb = mma_bf16;
using bf16 = __nv_bfloat16;

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

// kVec: Cin % 4 == 0 (16-byte copies of x's rows)
template <bool kVec>
__global__ void __launch_bounds__(mm::kTileThreads)
block_x3_kernel(const float* __restrict__ x, const float* __restrict__ w3,
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
// copied while this one is multiplied. The 8 warps
// are MW x NW over BR rows and a pass (MW = 2, or 1 at BR = 16), each MT m
// tiles by NT n tiles, all whole: no test in the loop. For each pair of
// columns c, c + 1 < ncols of row r it calls epi(r, c, value of c, value of
// c + 1) once the pass is summed; rows past the block's own hold whatever A
// held there. Starts with a barrier, so Wb may be reused from one call to
// the next.
template <int BR, int kP, class Epi>
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
    mm::warp_mma<kMT, kNT, false>(A + wm * kMT * 16 * lda + kc * kBK, lda,
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
template <int BR, class Epi>
__device__ inline void block_product(const float* A, int lda, int K, const float* __restrict__ W0,
                                     int n0, const float* __restrict__ W1, int ncols, float* Wb,
                                     Epi epi) {
  if constexpr (BR == 128) {  // launched only where every width takes 64-column passes
    block_product<BR, 64>(A, lda, K, W0, n0, W1, ncols, Wb, epi);
  } else if (ncols % 128 == 0) {
    block_product<BR, 128>(A, lda, K, W0, n0, W1, ncols, Wb, epi);
  } else {
    block_product<BR, 64>(A, lda, K, W0, n0, W1, ncols, Wb, epi);
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

template <int BR>
__global__ void __launch_bounds__(kThreads)
block_epilogue_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ gy, const float* __restrict__ wd,
                      const float* __restrict__ bd,
                      const float* __restrict__ wo, const float* __restrict__ bo,
                      const float* __restrict__ wp, const float* __restrict__ bp,
                      const float* __restrict__ wpw, const float* __restrict__ bpw,
                      float* __restrict__ prefix, float* __restrict__ pw, int NR, int Cin,
                      int C, int P, int BC) {
  extern __shared__ float4 smem4[];
  const int ldr = epi_ldr(C), ldd = epi_ldd(Cin, C);
  float* Rs = reinterpret_cast<float*>(smem4);
  float* Ds = Rs + BR * ldr;
  float* Wb = Ds + BR * ldd;
  const int tid = threadIdx.x;
  const size_t r_base = (size_t)blockIdx.x * BR;
  const int rows = min(BR, NR - (int)r_base);
  const float* xb = x + r_base * Cin;
  const float* yb = y + r_base * C;
  const int C8 = round32(C);  // the products read k < round32(K): zero past K

  // ---- res ----
  if (wd == nullptr) {  // identity (Cin == C)
    for (int i = tid; i < BR * C8; i += kThreads) {
      const int r = i / C8, k = i % C8;
      Rs[r * ldr + k] = r < rows && k < C ? xb[(size_t)r * C + k] : 0.f;
    }
  } else {
    const int K8 = round32(Cin);
    for (int i = tid; i < BR * K8; i += kThreads) {
      const int r = i / K8, k = i % K8;
      Ds[r * ldd + k] = r < rows && k < Cin ? xb[(size_t)r * Cin + k] : 0.f;
    }
    for (int i = tid; i < BR * (C8 - C); i += kThreads) {
      Rs[(i / (C8 - C)) * ldr + C + i % (C8 - C)] = 0.f;
    }
    __syncthreads();
    block_product<BR>(Ds, ldd, Cin, wd, C, wd, C, Wb, [&](int r, int c, float v0, float v1) {
      Rs[r * ldr + c] = v0 + __ldg(bd + c);
      Rs[r * ldr + c + 1] = v1 + __ldg(bd + c + 1);
    });
  }
  __syncthreads();
  // ---- res - y ----
  for (int i = tid; i < BR * C8; i += kThreads) {
    const int r = i / C8, k = i % C8;
    Ds[r * ldd + k] = r < rows && k < C
                          ? Rs[r * ldr + k] - fmaf(yb[(size_t)r * C + k], gy[k], gy[C + k])
                          : 0.f;
  }
  __syncthreads();
  // ---- off = tanh((res - y) @ Wo + bo); h = relu(y + off + res) into Rs ----
  block_product<BR>(Ds, ldd, C, wo, C, wo, C, Wb, [&](int r, int c, float v0, float v1) {
    if (r < rows) {
      const float2 yv = *reinterpret_cast<const float2*>(yb + (size_t)r * C + c);
      float* h = Rs + r * ldr + c;
      h[0] = fmaxf(fmaf(yv.x, __ldg(gy + c), __ldg(gy + C + c)) + tanhf(v0 + __ldg(bo + c)) + h[0],
                   0.f);
      h[1] = fmaxf(fmaf(yv.y, __ldg(gy + c + 1), __ldg(gy + C + c + 1)) +
                       tanhf(v1 + __ldg(bo + c + 1)) + h[1],
                   0.f);
    }
  });
  __syncthreads();
  // ---- prefix = relu(h @ Wp + bp), pw = h @ Wpw + bpw: one product of h
  // with [Wp | Wpw] ----
  block_product<BR>(Rs, ldr, C, wp, P, wpw, P + BC, Wb, [&](int r, int c, float v0, float v1) {
    if (r < rows) {
      if (c < P) {
        *reinterpret_cast<float2*>(prefix + (r_base + r) * P + c) =
            make_float2(fmaxf(v0 + __ldg(bp + c), 0.f), fmaxf(v1 + __ldg(bp + c + 1), 0.f));
      } else {
        *reinterpret_cast<float2*>(pw + (r_base + r) * BC + c - P) =
            make_float2(v0 + __ldg(bpw + c - P), v1 + __ldg(bpw + c - P + 1));
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
// held there.
template <class Epi>
__device__ inline void block_gemm(const float* A, int lda, int rows, int K,
                                  const float* __restrict__ W, int ncols,
                                  Epi epi) {
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
        const float4 wk = ldg4(W + (size_t)k * ncols + c[0]);
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
          const float4 wk = ldg4(W + (size_t)k * ncols + c[it]);
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

__global__ void __launch_bounds__(kThreads)
block_epilogue_wide_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           const float* __restrict__ gy, const float* __restrict__ wd,
                           const float* __restrict__ bd, const float* __restrict__ wo,
                           const float* __restrict__ bo, const float* __restrict__ wp,
                           const float* __restrict__ bp, const float* __restrict__ wpw,
                           const float* __restrict__ bpw, float* __restrict__ prefix,
                           float* __restrict__ pw, int NR, int Cin, int C, int P, int BC,
                           int BR) {
  extern __shared__ float4 smem4[];
  const int LDR = wide_ldr(C);
  float* Rs = reinterpret_cast<float*>(smem4);
  float* Ds = Rs + BR * LDR;
  const int tid = threadIdx.x;
  const size_t r_base = (size_t)blockIdx.x * BR;
  const int rows = min(BR, NR - (int)r_base);
  const float* xb = x + r_base * Cin;
  const float* yb = y + r_base * C;

  // ---- res ----
  if (wd == nullptr) {  // identity (Cin == C)
    for (int i = tid; i < BR * C; i += kThreads) {
      Rs[(i / C) * LDR + i % C] = i / C < rows ? xb[i] : 0.f;
    }
  } else {
    for (int i = tid; i < BR * Cin; i += kThreads) {
      Ds[(i / Cin) * (Cin + 1) + i % Cin] = i / Cin < rows ? xb[i] : 0.f;
    }
    __syncthreads();
    block_gemm(Ds, Cin + 1, BR, Cin, wd, C,
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
    Ds[o] = r < rows ? Rs[o] - fmaf(yb[i], gy[k], gy[C + k]) : 0.f;
  }
  __syncthreads();
  // ---- off = tanh((res - y) @ Wo + bo); h = relu(y + off + res) into Rs ----
  block_gemm(Ds, LDR, BR, C, wo, C, [&](int r0, int c, const float4* acc) {
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
        *h = make_float4(fmaxf(yv.x + tanhf(acc[i].x + b.x) + r.x, 0.f),
                         fmaxf(yv.y + tanhf(acc[i].y + b.y) + r.y, 0.f),
                         fmaxf(yv.z + tanhf(acc[i].z + b.z) + r.z, 0.f),
                         fmaxf(yv.w + tanhf(acc[i].w + b.w) + r.w, 0.f));
      }
    }
  });
  __syncthreads();
  // ---- prefix = relu(h @ Wp + bp); pw = h @ Wpw + bpw ----
  block_gemm(Rs, LDR, BR, C, wp, P, [&](int r0, int c, const float4* acc) {
    const float4 b = ldg4(bp + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < rows) {
        *reinterpret_cast<float4*>(prefix + (r_base + r0 + i) * P + c) =
            make_float4(fmaxf(acc[i].x + b.x, 0.f), fmaxf(acc[i].y + b.y, 0.f),
                        fmaxf(acc[i].z + b.z, 0.f), fmaxf(acc[i].w + b.w, 0.f));
      }
    }
  });
  block_gemm(Rs, LDR, BR, C, wpw, BC, [&](int r0, int c, const float4* acc) {
    const float4 b = ldg4(bpw + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < rows) {
        *reinterpret_cast<float4*>(pw + (r_base + r0 + i) * BC + c) = make_float4(
            acc[i].x + b.x, acc[i].y + b.y, acc[i].z + b.z, acc[i].w + b.w);
      }
    }
  });
}

int launch_x3(const float* x, const float* w3, const float* b3, float* x3, int NR, int Cin,
              int SC, cudaStream_t stream) {
  const int blocks = (NR + mm::kTileM - 1) / mm::kTileM * ((SC + mm::kTileN - 1) / mm::kTileN);
  auto kernel = Cin % 4 == 0 ? block_x3_kernel<true> : block_x3_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mm::tile_smem_bytes<kXK>());
  if (err != cudaSuccess) return err;
  kernel<<<blocks, mm::kTileThreads, mm::tile_smem_bytes<kXK>(), stream>>>(x, w3, b3, x3, NR,
                                                                           Cin, SC);
  return cudaGetLastError();
}

template <int BR>
int launch_epilogue_one(const float* x, const float* y, const float* gy, const float* wd,
                        const float* bd,
                        const float* wo, const float* bo, const float* wp, const float* bp,
                        const float* wpw, const float* bpw, float* prefix, float* pw, int NR,
                        int Cin, int C, int P, int BC, cudaStream_t stream) {
  const size_t smem = epi_smem(BR, Cin, C, P, BC);
  cudaError_t err = cudaFuncSetAttribute(
      block_epilogue_kernel<BR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block_epilogue_kernel<BR><<<(NR + BR - 1) / BR, kThreads, smem, stream>>>(
      x, y, gy, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, NR, Cin, C, P, BC);
  return cudaGetLastError();
}

int launch_epilogue(const float* x, const float* y, const float* gy, const float* wd,
                    const float* bd,
                    const float* wo, const float* bo, const float* wp, const float* bp,
                    const float* wpw, const float* bpw, float* prefix, float* pw, int NR,
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
      block_epilogue_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  block_epilogue_wide_kernel<<<(NR + BR - 1) / BR, kThreads, smem, stream>>>(
      x, y, gy, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, NR, Cin, C, P, BC, BR);
  return cudaGetLastError();
}

// Floats of the scratch y that gcn_tcn_block_f32 needs: x3 (N,T,V,S*C),
// then y (N,T,V,C).
size_t scratch_floats(long long NR, int S, int C) {
  return ((size_t)NR * S * C + 3) / 4 * 4 + (size_t)NR * C;
}

// What both forms' launchers take: the wrapper's checks, V <= 28 and x3
// indexed by an int.
bool takes(int N, int S, int T, int V, int Cin, int R, int C, int P, int BC, const void* wd,
           const void* bd) {
  const long long NR = (long long)N * T * V;
  return N >= 1 && N <= 65535 && S >= 1 && T >= 1 && V >= 1 && V <= kMaxV && Cin >= 1 &&
         R >= 1 && R <= 32 && C >= 4 && C % 4 == 0 && P >= 4 && P % 4 == 0 && BC >= 4 &&
         BC % 4 == 0 && (wd == nullptr) == (bd == nullptr) && (wd != nullptr || Cin == C) &&
         NR * S * C <= 0x7fffffffLL;
}

// The three kernels of the f32 form, after the launcher's checks.
int run_block(const float* x, const float* x1s, const float* x2s, const float* w3,
              const float* b3, const float* w4s, const float* b4s, const float* alpha,
              const float* As, const float* gy, const float* wd, const float* bd,
              const float* wo, const float* bo, const float* wp, const float* bp,
              const float* wpw, const float* bpw, float* y, float* prefix, float* pw, int N,
              int S, int T, int V, int Cin, int R, int C, int P, int BC, void* stream) {
  if (!takes(N, S, T, V, Cin, R, C, P, BC, wd, bd)) return cudaErrorInvalidValue;
  const long long NR = (long long)N * T * V;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* x3 = y;
  float* agg = y + scratch_floats(NR, S, C) - (size_t)NR * C;
  int err = launch_x3(x, w3, b3, x3, (int)NR, Cin, S * C, st);
  if (err != cudaSuccess) return err;
  err = fwd::run<AggLaunch, float>(x1s, x2s, x3, w4s, b4s, alpha, As, agg, N, S, T, V, R, C, st);
  if (err != cudaSuccess) return err;
  return launch_epilogue(x, agg, gy, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, (int)NR, Cin,
                         C, P, BC, st);
}

// ==== the bf16 form ====

__host__ __device__ inline int round8(int a) { return (a + 7) / 8 * 8; }
__host__ __device__ inline int round64(int a) { return (a + 63) / 64 * 64; }

// The bf16 operands the prologue writes into the scratch after x3 and y
// (offsets in bf16 values from there; every matrix 16-byte aligned, its
// rows padded with zeros to a multiple of 8 values): w3 (cin8, ld3), wd
// (cin8, ldc), wo (C, ldc), [wp | wpw] (C, ldpp), and x padded to rows of
// cin8 values where x's rows are not 16-byte copies as they are (Cin % 8,
// or x not 16-byte aligned). Rows Cin .. cin8 of w3 and wd are zero.
struct Bf16Layout {
  int cin8, ld3, ldc, ldpp;
  size_t w3, wd, wo, wpp, xp, values;
};

bool pads_x(const bf16* x, int Cin) {
  return Cin % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0;
}

Bf16Layout bf16_layout(long long NR, int Cin, int S, int C, int P, int BC, bool pad_x) {
  Bf16Layout L;
  L.cin8 = round8(Cin);
  L.ld3 = round8(S * C);
  L.ldc = round8(C);
  L.ldpp = round8(P + BC);
  L.w3 = 0;
  L.wd = L.w3 + (size_t)L.cin8 * L.ld3;
  L.wo = L.wd + (size_t)L.cin8 * L.ldc;
  L.wpp = L.wo + (size_t)C * L.ldc;
  L.xp = L.wpp + (size_t)C * L.ldpp;
  L.values = L.xp + (pad_x ? (size_t)NR * L.cin8 : 0);
  return L;
}

// Floats of the scratch y that gcn_tcn_block_bf16 needs: the f32 form's x3
// and y, then the bf16 operands (Bf16Layout).
size_t bf16_scratch_floats(long long NR, int S, int C, const Bf16Layout& L) {
  return scratch_floats(NR, S, C) + (L.values + 7) / 8 * 4;
}

// ---- the prologue: each weight rounded to bf16 once a call ----

// One bf16 matrix of `rows` rows of ld values: (k, c) = W0[k][c] for c < n0,
// W1[k][c - n0] for c < ncols (W0 K x n0, W1 K x (ncols - n0), f32, n0 and
// ncols even), rounded to bf16; zero for c >= ncols and for k >= K.
struct Bf16Matrix {
  const float* w0;
  const float* w1;
  int n0, ncols, K, rows, ld;
  bf16* dst;
};

struct Prologue {
  Bf16Matrix m[4];
  int count;
  const bf16* x;  // padded into xp (rows of cin8) where xp is not null
  bf16* xp;
  int Cin, cin8;
  long long NR;
};

// Pairs of values over every matrix of p, then over xp, by a grid-stride
// loop: a pair never straddles a row (ld and cin8 are even).
__global__ void __launch_bounds__(kThreads)
block_prologue_bf16_kernel(const __grid_constant__ Prologue p) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;; i += stride) {
    long long j = i;
    int s = 0;
    for (; s < p.count; ++s) {
      const long long n = (long long)p.m[s].rows * p.m[s].ld / 2;
      if (j < n) break;
      j -= n;
    }
    if (s < p.count) {
      const Bf16Matrix& m = p.m[s];
      const int k = (int)(2 * j / m.ld), c = (int)(2 * j % m.ld);
      float2 w = make_float2(0.f, 0.f);
      if (k < m.K && c < m.ncols) {
        w = c < m.n0 ? *reinterpret_cast<const float2*>(m.w0 + (size_t)k * m.n0 + c)
                     : *reinterpret_cast<const float2*>(m.w1 + (size_t)k * (m.ncols - m.n0) +
                                                        c - m.n0);
      }
      *reinterpret_cast<__nv_bfloat162*>(m.dst + (size_t)k * m.ld + c) =
          __floats2bfloat162_rn(w.x, w.y);
    } else {
      if (p.xp == nullptr || j >= p.NR * p.cin8 / 2) return;
      const long long r = 2 * j / p.cin8;
      const int c = (int)(2 * j % p.cin8);
      const bf16* xr = p.x + r * p.Cin;
      const bf16 zero = __float2bfloat16(0.f);
      *reinterpret_cast<__nv_bfloat162*>(p.xp + r * p.cin8 + c) =
          __halves2bfloat162(c < p.Cin ? xr[c] : zero, c + 1 < p.Cin ? xr[c + 1] : zero);
    }
  }
}

// ---- x3 = x @ W3 + b3: 128 x 64 tiles of bf16 products, written f32 ----

// x (rows of ldx bf16 values, 16-byte aligned, zero past Cin) @ the bf16 w3
// (ldx rows of ld3) on the tensor cores (mma_bf16.cuh: tile_product_bf16,
// ldmatrix + mma.sync m16n8k16, a cp.async ring), plus b3, written as f32:
// the aggregation reads the unrounded x3, as the JAX kernel's f32 scratch
// holds it.
__global__ void __launch_bounds__(mb::kTileThreads, 2)
block_x3_bf16_kernel(const bf16* __restrict__ x, int ldx, const bf16* __restrict__ w3, int ld3,
                     const float* __restrict__ b3, float* __restrict__ x3, int NR, int SC) {
  extern __shared__ float4 smem4[];
  const int tiles_n = (SC + mb::kTileN - 1) / mb::kTileN;
  const int m0 = blockIdx.x / tiles_n * mb::kTileM, n0 = blockIdx.x % tiles_n * mb::kTileN;
  float acc[mb::kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < mb::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  mb::tile_product_bf16<false, true, true>(x, ldx, NR, w3, ld3, ld3, m0, n0, 0, ldx,
                                           reinterpret_cast<bf16*>(smem4), acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / mb::kWarpsN, wn = warp % mb::kWarpsN;
#pragma unroll
  for (int mt = 0; mt < mb::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mb::kWarpM * wm + 16 * mt + lane / 4 + 8 * h;
        const int c = n0 + 32 * wn + 8 * nt + 2 * (lane % 4);
        if (r < NR && c < SC) {  // SC % 4 == 0: c + 1 < SC too
          *reinterpret_cast<float2*>(x3 + (size_t)r * SC + c) = make_float2(
              acc[mt][nt][2 * h] + __ldg(b3 + c), acc[mt][nt][2 * h + 1] + __ldg(b3 + c + 1));
        }
      }
}

// ---- the epilogue on bf16 rows ----

constexpr int kBStages = 3;  // weight chunks in the ring of block_product_bf16
constexpr int kBBK = 32;     // weight rows a chunk: two m16n8k16 steps
constexpr int kBPass = 128;  // the widest pass, which the ring is sized for

// 8 warps over BR rows and kP columns: kMW x kNW warps of kMT m16 tiles by
// kNT n8 tiles
template <int BR, int kP>
struct Warps {
  static constexpr int kMW = BR >= 128 ? 4 : BR >= 32 ? 2 : 1, kNW = 8 / kMW;
  static constexpr int kMT = BR / 16 / kMW, kNT = kP / kNW / 8;
  static_assert(kMT >= 1 && kNT >= 1 && kMW * kMT * 16 == BR && kNW * kNT * 8 == kP,
                "8 warps over BR rows x kP");
};

// acc = A @ W over the BR rows of A (bf16 in shared memory, row stride lda
// values, 16-byte aligned rows, columns k < round32(K) finite and zero from K
// on) and the columns of W (bf16 in device memory, rows k < K of ldw values,
// ldw % 8 == 0, zero past the matrix's own columns, 16-byte aligned), in
// passes of kP columns up to ncols, on the tensor cores: ldmatrix and
// mma.sync m16n8k16 (mma_bf16.cuh), f32 sums. W's chunks of kBBK rows, zero
// past K and ldw, arrive by 16-byte cp.async in a ring of kBStages buffers
// Wb [kBStages][kBBK][kP + 8], kBStages - 1 in flight while the warps
// multiply the oldest. Once a pass is summed, epi(r, c, v0, v1) runs for
// every pair of columns c, c + 1 of every row r < BR (v0, v1 writable: the
// pass's sums); with kInPlace, then a barrier, then out(r, c, v0, v1) on
// what epi left (so that out may overwrite what epi read). Starts with a
// barrier, so Wb and A may be rewritten between calls.
template <int BR, int kP, bool kInPlace, class Epi, class Out>
__device__ inline void block_product_bf16(const bf16* A, int lda, int K,
                                          const bf16* __restrict__ W, int ldw, int ncols,
                                          bf16* Wb, Epi epi, Out out) {
  using Wp = Warps<BR, kP>;
  constexpr int kMT = Wp::kMT, kNT = Wp::kNT, kLd = kP + 8;  // kLd: 16 mod 128 bytes
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / Wp::kNW, wn = warp % Wp::kNW;
  const int nkc = (K + kBBK - 1) / kBBK;
  const int nsteps = (ncols + kP - 1) / kP * nkc;
  auto stage = [&](int step) {
    if (step < nsteps) {
      const int c0 = step / nkc * kP, k0 = step % nkc * kBBK;
      bf16* wb = Wb + step % kBStages * kBBK * kLd;
      for (int i = tid; i < kBBK * kP / 8; i += kThreads) {
        const int k = i / (kP / 8), c = 8 * (i % (kP / 8));
        const bool ok = k0 + k < K && c0 + c < ldw;
        mb::copy16(wb + k * kLd + c, ok ? W + (size_t)(k0 + k) * ldw + c0 + c : W, ok);
      }
    }
    mb::commit();  // one group a step, empty past the last, so wait<> counts steps
  };
  float acc[kMT][kNT][4];
  __syncthreads();  // the previous call's chunks and A's rows are consumed or written
  for (int step = 0; step < kBStages - 1; ++step) stage(step);
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
    mb::wait<kBStages - 2>();
    __syncthreads();  // the step's chunk is in; step - 1's buffer is consumed
    stage(step + kBStages - 1);
    const bf16* wb = Wb + step % kBStages * kBBK * kLd + wn * kNT * 8;
#pragma unroll
    for (int ks = 0; ks < kBBK / 16; ++ks) {
      uint32_t bf[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        // [k][n]: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
        // (k 8-15, n 8-15), transposed: the B fragments of two n tiles
        uint32_t r[4];
        mb::ldmatrix4<true>(r, wb + (ks * 16 + (lane & 15)) * kLd + np * 16 + (lane >> 4) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
      if constexpr (kNT % 2 == 1) {
        mb::ldmatrix2_trans(bf[kNT - 1], wb + (ks * 16 + (lane & 15)) * kLd + (kNT - 1) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // [m][k]: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
        // (m 8-15, k 8-15)
        uint32_t af[4];
        mb::ldmatrix4<false>(af, A + ((wm * kMT + mt) * 16 + (lane & 15)) * lda + kc * kBBK +
                                     ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mb::mma(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
    if (kc + 1 < nkc) continue;
    const int r0 = wm * kMT * 16 + lane / 4, col0 = c0 + wn * kNT * 8 + 2 * (lane % 4);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          epi(r0 + mt * 16 + 8 * h, col0 + nt * 8, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
    if constexpr (kInPlace) {
      __syncthreads();  // every thread's epi has read what out overwrites
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            out(r0 + mt * 16 + 8 * h, col0 + nt * 8, acc[mt][nt][2 * h],
                acc[mt][nt][2 * h + 1]);
          }
    }
  }
  mb::wait<0>();  // no copy is left in flight into Wb
}

// block_product_bf16 in passes of 128 columns where ncols is a multiple of
// 128, else of 64
template <int BR, bool kInPlace = false, class Epi, class Out>
__device__ inline void product_bf16(const bf16* A, int lda, int K, const bf16* __restrict__ W,
                                    int ldw, int ncols, bf16* Wb, Epi epi, Out out) {
  if (ncols % 128 == 0) {
    block_product_bf16<BR, 128, kInPlace>(A, lda, K, W, ldw, ncols, Wb, epi, out);
  } else {
    block_product_bf16<BR, 64, kInPlace>(A, lda, K, W, ldw, ncols, Wb, epi, out);
  }
}
template <int BR, class Epi>
__device__ inline void product_bf16(const bf16* A, int lda, int K, const bf16* __restrict__ W,
                                    int ldw, int ncols, bf16* Wb, Epi epi) {
  product_bf16<BR>(A, lda, K, W, ldw, ncols, Wb, epi, [](int, int, float, float) {});
}

// The bf16 epilogue's shared memory at (cin8, C): Rs f32 [BR][ldr] (res,
// then h as bf16 [BR][2 * ldr] in the same bytes), with kYs Ys f32
// [BR][ldr] (the block's rows of y), Ds bf16 [BR][ldd] (x, then res - y),
// the weight ring. A bf16 row stride of 16 mod 128 bytes puts the 8 rows of
// an ldmatrix in 8 distinct 16-byte bank groups; every row holds round32 of
// its width.
__host__ __device__ inline int bf16_ldr(int C) { return round32(C) + 4; }
__host__ __device__ inline int bf16_ldd(int cin8, int C) {
  return round64(imax(round32(cin8), round32(C))) + 8;
}
__host__ __device__ inline size_t bf16_epi_smem(int BR, int cin8, int C, bool ys) {
  return (size_t)BR * bf16_ldr(C) * sizeof(float) * (ys ? 2 : 1) +
         (size_t)BR * bf16_ldd(cin8, C) * 2 + (size_t)kBStages * kBBK * (kBPass + 8) * 2;
}

// How the bf16 epilogue runs at (cin8, C): rows a block, and whether the
// block keeps its rows of y in shared memory (ys).
struct EpiBf16 {
  int rows;
  bool ys;
};

// The most rows of 128, 64 and 32 whose blocks, y's rows kept, fit two an
// SM; else the most of 64, 32 and 16 that fit one with y's rows, else 16
// rows without them (C past ~1500, y read from device memory as it is
// needed); rows 0 where even that does not fit (C past ~2200).
EpiBf16 bf16_epi(int cin8, int C) {
  constexpr size_t kSM = 233472, kReserved = 1024;  // an SM's shared memory, a block's share
  for (const int br : {128, 64, 32}) {
    if (2 * (bf16_epi_smem(br, cin8, C, true) + kReserved) <= kSM) return {br, true};
  }
  for (const int br : {64, 32, 16}) {
    if (bf16_epi_smem(br, cin8, C, true) <= (size_t)kSmemLimit) return {br, true};
  }
  if (bf16_epi_smem(16, cin8, C, false) <= (size_t)kSmemLimit) return {16, false};
  return {0, false};
}

// x: the rows of ldx bf16 values the products read (16-byte aligned, zero
// past Cin; Cin == C for an identity residual, wd null); y's and x's rows
// arrive by 16-byte cp.async at the start, all in flight at once (with kYs
// y's into Ys; else y is read from device memory where it is needed).
template <int BR, bool kYs>
__global__ void __launch_bounds__(kThreads)
block_epilogue_bf16_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ y,
                           const float* __restrict__ gy, const bf16* __restrict__ wd,
                           const float* __restrict__ bd, const bf16* __restrict__ wo,
                           const float* __restrict__ bo, const bf16* __restrict__ wpp,
                           const float* __restrict__ bp, const float* __restrict__ bpw,
                           bf16* __restrict__ prefix, bf16* __restrict__ pw, int NR, int C,
                           int P, int BC, int ldc, int ldpp) {
  extern __shared__ float4 smem4[];
  const int ldr = bf16_ldr(C), ldd = bf16_ldd(ldx, C), ldh = 2 * ldr;
  float* Rs = reinterpret_cast<float*>(smem4);
  bf16* Hs = reinterpret_cast<bf16*>(Rs);  // h over res, in place
  float* Ys = Rs + BR * ldr;
  bf16* Ds = reinterpret_cast<bf16*>(Ys + (kYs ? BR * ldr : 0));
  bf16* Wb = Ds + BR * ldd;
  const int tid = threadIdx.x;
  const size_t r_base = (size_t)blockIdx.x * BR;
  const int rows = min(BR, NR - (int)r_base);
  const float* yb = y + r_base * C;
  const int C32 = round32(C);  // the products read k < round32(K): zero past K

  // ---- x's rows into Ds, zero past them; y's rows into Ys ----
  const bf16* xb = x + r_base * ldx;
  const int K32 = round32(ldx);
  for (int i = tid; i < BR * K32 / 8; i += kThreads) {
    const int r = i / (K32 / 8), k = 8 * (i % (K32 / 8));
    const bool ok = r < rows && k < ldx;
    mb::copy16(Ds + r * ldd + k, ok ? xb + (size_t)r * ldx + k : x, ok);
  }
  mb::commit();
  if constexpr (kYs) {
    for (int i = tid; i < rows * (C / 4); i += kThreads) {
      const int r = i / (C / 4), k = 4 * (i % (C / 4));
      mb::copy16(Ys + r * ldr + k, yb + (size_t)r * C + k, true);
    }
  }
  mb::commit();
  // y' = y * gy0 + gy1 at 4 columns of a row the block owns
  auto yprime4 = [&](int r, int k) {
    const float4 yv = kYs ? *reinterpret_cast<const float4*>(Ys + r * ldr + k)
                          : *reinterpret_cast<const float4*>(yb + (size_t)r * C + k);
    const float4 g0 = ldg4(gy + k), g1 = ldg4(gy + C + k);
    return make_float4(fmaf(yv.x, g0.x, g1.x), fmaf(yv.y, g0.y, g1.y), fmaf(yv.z, g0.z, g1.z),
                       fmaf(yv.w, g0.w, g1.w));
  };

  if (wd == nullptr) {
    // ---- identity: res = x widened; res - y', rounded once to bf16, over
    // x in place (the same thread reads and writes the 4 values) ----
    mb::wait<0>();
    __syncthreads();
    for (int i = tid; i < BR * C32 / 4; i += kThreads) {
      const int r = i / (C32 / 4), k = 4 * (i % (C32 / 4));
      float4 res = make_float4(0.f, 0.f, 0.f, 0.f), d = res;
      if (r < rows && k < C) {
        res = Act<bf16>::load4(Ds + r * ldd + k);
        const float4 yp = yprime4(r, k);
        d = make_float4(res.x - yp.x, res.y - yp.y, res.z - yp.z, res.w - yp.w);
      }
      *reinterpret_cast<float4*>(Rs + r * ldr + k) = res;
      Act<bf16>::store4(Ds + r * ldd + k, d);
    }
  } else {
    // ---- res = x @ Wd + bd (x's rows in, y's still arriving) ----
    mb::wait<1>();
    product_bf16<BR>(Ds, ldd, ldx, wd, ldc, C, Wb, [&](int r, int c, float v0, float v1) {
      if (c < C) {
        *reinterpret_cast<float2*>(Rs + r * ldr + c) =
            make_float2(v0 + __ldg(bd + c), v1 + __ldg(bd + c + 1));
      }
    });
    __syncthreads();  // every warp's product has read Ds; Rs and Ys are in
    // ---- res - y', rounded once to bf16 ----
    for (int i = tid; i < BR * C32 / 4; i += kThreads) {
      const int r = i / (C32 / 4), k = 4 * (i % (C32 / 4));
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && k < C) {
        const float4 rv = *reinterpret_cast<const float4*>(Rs + r * ldr + k);
        const float4 yp = yprime4(r, k);
        d = make_float4(rv.x - yp.x, rv.y - yp.y, rv.z - yp.z, rv.w - yp.w);
      }
      Act<bf16>::store4(Ds + r * ldd + k, d);
    }
  }
  // ---- off = tanh((res - y') @ Wo + bo); h = relu(y' + off + res), rounded
  // once to bf16, over res in place: a pass's h is written after every res
  // of the pass is read (h's column c overwrites res's column c / 2, which
  // this pass or an earlier one read); zero past C and past the block's rows
  // ----
  product_bf16<BR, true>(
      Ds, ldd, C, wo, ldc, C, Wb,
      [&](int r, int c, float& v0, float& v1) {
        float h0 = 0.f, h1 = 0.f;
        if (r < rows && c < C) {
          const float2 yv = kYs ? *reinterpret_cast<const float2*>(Ys + r * ldr + c)
                                : *reinterpret_cast<const float2*>(yb + (size_t)r * C + c);
          const float2 res = *reinterpret_cast<const float2*>(Rs + r * ldr + c);
          h0 = fmaxf(fmaf(yv.x, __ldg(gy + c), __ldg(gy + C + c)) + tanhf(v0 + __ldg(bo + c)) +
                         res.x,
                     0.f);
          h1 = fmaxf(fmaf(yv.y, __ldg(gy + c + 1), __ldg(gy + C + c + 1)) +
                         tanhf(v1 + __ldg(bo + c + 1)) + res.y,
                     0.f);
        }
        v0 = h0;
        v1 = h1;
      },
      [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<__nv_bfloat162*>(Hs + r * ldh + c) = __floats2bfloat162_rn(v0, v1);
      });
  // ---- prefix = relu(h @ Wp + bp), pw = h @ Wpw + bpw: one product of h
  // with [Wp | Wpw], rounded once to bf16 as they are stored ----
  product_bf16<BR>(Hs, ldh, C, wpp, ldpp, P + BC, Wb, [&](int r, int c, float v0, float v1) {
    if (r < rows && c < P + BC) {
      if (c < P) {
        Act<bf16>::store2(prefix + (r_base + r) * P + c, fmaxf(v0 + __ldg(bp + c), 0.f),
                          fmaxf(v1 + __ldg(bp + c + 1), 0.f));
      } else {
        Act<bf16>::store2(pw + (r_base + r) * BC + c - P, v0 + __ldg(bpw + c - P),
                          v1 + __ldg(bpw + c - P + 1));
      }
    }
  });
}

template <int BR, bool kYs>
int launch_epilogue_bf16(const bf16* x, int ldx, const float* y, const float* gy,
                         const bf16* wd, const float* bd, const bf16* wo, const float* bo,
                         const bf16* wpp, const float* bp, const float* bpw, bf16* prefix,
                         bf16* pw, int NR, int C, int P, int BC, int ldc, int ldpp,
                         cudaStream_t stream) {
  const size_t smem = bf16_epi_smem(BR, ldx, C, kYs);
  cudaError_t err = cudaFuncSetAttribute(block_epilogue_bf16_kernel<BR, kYs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block_epilogue_bf16_kernel<BR, kYs><<<(NR + BR - 1) / BR, kThreads, smem, stream>>>(
      x, ldx, y, gy, wd, bd, wo, bo, wpp, bp, bpw, prefix, pw, NR, C, P, BC, ldc, ldpp);
  return cudaGetLastError();
}

// The four kernels of the bf16 form, after the launcher's checks: the
// prologue, x3, the aggregation (K1's body under stage 1's bf16 policy on
// the f32 x3), the epilogue.
int run_block_bf16(const bf16* x, const float* x1s, const float* x2s, const float* w3,
                   const float* b3, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, const float* gy, const float* wd, const float* bd,
                   const float* wo, const float* bo, const float* wp, const float* bp,
                   const float* wpw, const float* bpw, float* y, bf16* prefix, bf16* pw, int N,
                   int S, int T, int V, int Cin, int R, int C, int P, int BC, void* stream) {
  const long long NR = (long long)N * T * V;
  const EpiBf16 epi = bf16_epi(round8(Cin), C);
  if (!takes(N, S, T, V, Cin, R, C, P, BC, wd, bd) || epi.rows == 0 ||
      NR * round8(Cin) > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pad = pads_x(x, Cin);
  const Bf16Layout L = bf16_layout(NR, Cin, S, C, P, BC, pad);
  bf16* ops = reinterpret_cast<bf16*>(y + scratch_floats(NR, S, C));
  Prologue pro{};
  pro.m[0] = Bf16Matrix{w3, w3, S * C, S * C, Cin, L.cin8, L.ld3, ops + L.w3};
  pro.m[1] = Bf16Matrix{wo, wo, C, C, C, C, L.ldc, ops + L.wo};
  pro.m[2] = Bf16Matrix{wp, wpw, P, P + BC, C, C, L.ldpp, ops + L.wpp};
  pro.count = 3;
  if (wd != nullptr) pro.m[pro.count++] = Bf16Matrix{wd, wd, C, C, Cin, L.cin8, L.ldc, ops + L.wd};
  pro.x = x;
  pro.xp = pad ? ops + L.xp : nullptr;
  pro.Cin = Cin;
  pro.cin8 = L.cin8;
  pro.NR = NR;
  long long pairs = pad ? NR * L.cin8 / 2 : 0;
  for (int s = 0; s < pro.count; ++s) pairs += (long long)pro.m[s].rows * pro.m[s].ld / 2;
  const int grid = (int)std::min<long long>((pairs + kThreads - 1) / kThreads, 132 * 8);
  block_prologue_bf16_kernel<<<grid, kThreads, 0, st>>>(pro);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bf16* xa = pad ? ops + L.xp : x;  // x's rows as the products read them
  float* x3 = y;
  float* agg = y + scratch_floats(NR, S, C) - (size_t)NR * C;
  const int SC = S * C;
  const int blocks = (int)((NR + mb::kTileM - 1) / mb::kTileM) * ((SC + mb::kTileN - 1) / mb::kTileN);
  err = cudaFuncSetAttribute(block_x3_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             mb::kTileSmemBytes);
  if (err != cudaSuccess) return err;
  block_x3_bf16_kernel<<<blocks, mb::kTileThreads, mb::kTileSmemBytes, st>>>(
      xa, L.cin8, ops + L.w3, L.ld3, b3, x3, (int)NR, SC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fwd::run<AggLaunchBf16, float>(x1s, x2s, x3, w4s, b4s, alpha, As, agg, N, S, T, V, R, C,
                                       st);
  if (err != cudaSuccess) return err;
  const bf16* wdb = wd == nullptr ? nullptr : ops + L.wd;
  auto launch = [&](auto kernel_launch) {
    return kernel_launch(xa, L.cin8, agg, gy, wdb, bd, ops + L.wo, bo, ops + L.wpp, bp, bpw,
                         prefix, pw, (int)NR, C, P, BC, L.ldc, L.ldpp, st);
  };
  if (!epi.ys) return launch(launch_epilogue_bf16<16, false>);
  switch (epi.rows) {
    case 128: return launch(launch_epilogue_bf16<128, true>);
    case 64: return launch(launch_epilogue_bf16<64, true>);
    case 32: return launch(launch_epilogue_bf16<32, true>);
    default: return launch(launch_epilogue_bf16<16, true>);
  }
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
  return run_block(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wd, bd, wo, bo, wp, bp, wpw,
                   bpw, y, prefix, pw, N, S, T, V, Cin, R, C, P, BC, stream);
}

// Floats of the scratch y that gcn_tcn_block_bf16 needs for the bf16 x at
// the shape (its bf16 operands follow the f32 form's x3 and y).
extern "C" long long gcn_tcn_block_bf16_scratch_floats(const bf16* x, int N, int S, int T,
                                                        int V, int Cin, int C, int P, int BC) {
  const long long NR = (long long)N * T * V;
  return (long long)bf16_scratch_floats(
      NR, S, C, bf16_layout(NR, Cin, S, C, P, BC, pads_x(x, Cin)));
}

// The bf16 form (the header): x (N,T,V,Cin), prefix and pw bf16, 8-byte
// aligned; every other tensor as gcn_tcn_block_f32's; the scratch y of
// gcn_tcn_block_bf16_scratch_floats(x, ...) floats, 16-byte aligned.
// Launches the four kernels on `stream`; returns as gcn_tcn_block_f32 does
// (cudaErrorInvalidValue also where 16 rows of all C channels do not fit
// the epilogue's block, C past ~2200).
extern "C" int gcn_tcn_block_bf16(
    const bf16* x, const float* x1s, const float* x2s, const float* w3,
    const float* b3, const float* w4s, const float* b4s, const float* alpha,
    const float* As, const float* gy, const float* wd, const float* bd,
    const float* wo, const float* bo, const float* wp, const float* bp,
    const float* wpw, const float* bpw, float* y, bf16* prefix, bf16* pw,
    int N, int S, int T, int V, int Cin, int R, int C, int P, int BC,
    void* stream) {
  return run_block_bf16(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, wd, bd, wo, bo, wp, bp,
                        wpw, bpw, y, prefix, pw, N, S, T, V, Cin, R, C, P, BC, stream);
}
