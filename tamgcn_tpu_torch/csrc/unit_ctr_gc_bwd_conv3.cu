// Unit CTR-GC backward fused with conv3's VJP (K6), for Hopper (sm_90a), f32
// and bf16.
//
// Replaces tamgcn_tpu/ops/pallas/ctr_gc.py:_unit_bwd_dx3_conv3_kernel_tile
// (launched by unit_ctr_gc_bwd_conv3_pallas), which computes K2's x3
// gradient and, from it, the gradients of the packed conv3 1x1 that produced
// x3s = x @ w3 + b3:
//
//   dx3s[n,t,v,s*C+c] = sum_u M_s[n,u,v,c] * g[n,t,u,c]
//   dx[n,t,v,i]       = sum_o dx3s[n,t,v,o] * w3[i,o]
//   dw3[i,o]          = sum_{n,t,v} x[n,t,v,i] * dx3s[n,t,v,o]
//   db3[o]            = sum_{n,t,v} dx3s[n,t,v,o]
//   M_s[n,u,v,c] = (sum_r tanh(x1s[n,s,u,r] - x2s[n,s,v,r]) * w4s[s,r,c]
//                   + b4s[s,c]) * alpha + As[s,u,v]
//
// dw3 comes out transposed, (S*C, Cin): the layout of conv3's weight.
//
// What bounds it on this card. At the deep NW-UCLA shape (N=16, T=13, V=20,
// Cin=C=256, R=32) the function reads g and x and writes dx (~13 MB, ~4 us
// at 3.35 TB/s) and does 2*N*S*(V*V*R*C + T*V*V*C) + 4*N*T*V*S*C*Cin
// ~ 3.7 GFLOP, 88% of it in the two products with w3 and x: ~22 us at the
// 165 TFLOP/s of f32 products on the tensor cores as 3xTF32. The operations
// bound it. Two things fight: a row of dx mixes all S*C channels, while M
// for one sample (V*V*S*C floats, 1.2 MB at C=256) is far larger than a
// block's 227 KB of shared memory, so a block cannot own both a row and all
// of M. The design before this one owned both for a chunk of frames: 80
// blocks on 132 SMs, stage 1 built once per chunk (5 times per sample at
// the deep shape), every product on the CUDA cores, and 63 MB of per-block
// partial sums.
//
// What this design does about it: two phases, three launches of one wrapper
// call, with dx3s passing through device scratch (13 MB at the deep shape,
// written once and read twice, mostly from the 50 MB L2).
//   Phase A, channel-tiled: K2's kernels as they are (unit_ctr_gc_dx3.cuh),
//   under this source's names: a block per (sample, subset, 16 channels,
//   tile of <= 16 frames) builds M_s of its channels and aggregates its
//   frames, both on the tensor cores (unit_ctr_gc_whole.cuh; the joint-tiled
//   design past V = 24).
//   Phase B, the products, one launch of 128-thread blocks, each a 64 x 64
//   output tile of one of two products:
//     dx tiles (rows x Cin): dx3s @ w3^T over k = S*C;
//     dw3^T tiles (S*C x Cin) of one of G fixed groups of rows: dx3s^T @ x
//     over the group's rows, written to that group's partial sums; the
//     blocks of the first Cin tile also sum dx3s's columns (db3).
//   Both on the tensor cores as 3xTF32 (mma_tf32x3.cuh: tile_product, four
//   warps of 32 x 32, mma.sync m16n8k8), their operands staged by cp.async
//   in chunks of 64 k, the next chunk copied while the warps multiply the
//   current one; three blocks an SM. G is
//   picked from the shape so that the launch has at least 264 dw3 blocks
//   (two per SM) beside the dx blocks: the partials are G * S*C * (Cin+1)
//   floats, 4-7 MB at the NW-UCLA shapes.
//   A last launch sums the G partials in group order. Nothing uses atomics,
//   so two launches give bitwise equal gradients.
// What it leaves: dx3s's round trip through L2; mma.sync, not wgmma.
//
// bf16 (unit_ctr_gc_bwd_conv3_bf16), the JAX kernel's bf16 body
// (`mm_dtype`, ctr_gc.py:510-558) on bf16 x1s, x2s, g, x and w3 with f32
// w4s, b4s, alpha and As: phase A is K2's bf16 form (stage 1 over D and w4s
// rounded to bf16) writing dx3s in f32, unrounded, to the same scratch.
// Phase B's products take dx3s rounded once to bf16 as it is staged, and x
// and w3 as they are, on the tensor cores as one bf16 mma.sync m16n8k16 a
// term with f32 accumulation (mma_bf16.cuh); db3's column sums read the f32
// dx3s before the rounding. dx is written in bf16; dw3's group partials stay
// f32 and the last launch sums them in group order and rounds dw3 and db3
// once to bf16. At the deep shape the operations still bound it: ~3.3
// GFLOP of bf16 products, ~3.3 us at the 989 TFLOP/s bf16 peak, beside
// ~7 MB of bf16 bytes (~2.1 us) and phase A's ~1 us.
// x's and w3's rows are read 16 bytes at a time where Cin % 8 == 0 (and the
// tensors are 16-byte aligned), else one value at a time.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "unit_ctr_gc_dx3.cuh"

namespace {

using namespace unit_ctr_gc;
namespace mm = mma_tf32x3;

// ---- phase A: K2's kernels under K6's names, dx3s in f32 in both forms ----

template <int RP, int JT, typename TA>
__global__ void __launch_bounds__(kThreads, 2)
unit_ctr_gc_bwd_conv3_kernel(const TA* __restrict__ x1s, const TA* __restrict__ x2s,
                             const TA* __restrict__ g, const float* __restrict__ w4s,
                             const float* __restrict__ b4s, const float* __restrict__ alpha,
                             const float* __restrict__ As, float* __restrict__ dx3s, int S,
                             int T, int V, int R, int C) {
  whole::run<false, RP, JT, TA, TA, float>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, S, T, V, R,
                                           C);
}

template <int RP, int TF, typename TA>
__global__ void __launch_bounds__(kThreads, 1)
unit_ctr_gc_bwd_conv3_kernel_tiled(const TA* __restrict__ x1s, const TA* __restrict__ x2s,
                                   const TA* __restrict__ g,
                                   const float* __restrict__ w4s,
                                   const float* __restrict__ b4s,
                                   const float* __restrict__ alpha,
                                   const float* __restrict__ As, float* __restrict__ dx3s,
                                   const __grid_constant__ CUtensorMap xmap, int S, int T,
                                   int V, int R, int C) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, sizeof(TA));
  run<false, RP, TF, CT, TA, TA, float>(x1s, x2s, g, w4s, b4s, alpha[0], As, dx3s, &xmap,
                                        blockIdx.z, blockIdx.y % S, (blockIdx.y / S) * kJ,
                                        blockIdx.x * CT, S, T, V, R, C);
}

struct PhaseA {
  template <int RP, int JT, typename TA>
  static int whole(dim3 grid, size_t smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* g, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, float* dx3s, int S, int T, int V, int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_bwd_conv3_kernel<RP, JT, TA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    unit_ctr_gc_bwd_conv3_kernel<RP, JT, TA><<<grid, kThreads, smem, st>>>(
        x1s, x2s, g, w4s, b4s, alpha, As, dx3s, S, T, V, R, C);
    return cudaGetLastError();
  }
  template <int RP, int TF, typename TA>
  static int tiled(dim3 grid, int smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* g, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, float* dx3s, const CUtensorMap& xmap, int S, int T, int V,
                   int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_bwd_conv3_kernel_tiled<RP, TF, TA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    unit_ctr_gc_bwd_conv3_kernel_tiled<RP, TF, TA><<<grid, kThreads, smem, st>>>(
        x1s, x2s, g, w4s, b4s, alpha, As, dx3s, xmap, S, T, V, R, C);
    return cudaGetLastError();
  }
};

// ---- phase B: the products ----

constexpr int kPT = mm::kTileThreads;  // threads of a product block
constexpr int kBM = mm::kTileM, kBN = mm::kTileN;
constexpr int kBK = 64;             // k per staged chunk (rows of x and dx3s for dw3)
constexpr int kDwBlocks = 264;      // dw3 blocks a launch aims for: two per SM

__host__ __device__ inline int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// The rows of each dw3 group (a multiple of kBK) and the number of groups:
// enough groups for kDwBlocks blocks, at least 4 chunks of rows each.
struct Groups {
  int rows, count;
};
__host__ __device__ inline Groups groups_of(long long NR, int SC, int Cin) {
  const int tiles = cdiv(SC, kBM) * cdiv(Cin, kBN);
  const int want = imax(1, imin(cdiv(kDwBlocks, tiles), cdiv(NR, 4 * kBK)));
  const int rows = cdiv(cdiv(NR, want), kBK) * kBK;
  return Groups{rows, cdiv(NR, rows)};
}

// dx (NR, Cin) = dx3s (NR, SC) @ w3t (SC, Cin), and the G groups' dw3t
// (SC, Cin) = dx3s^T x and db3 (SC) partial sums, partials [G][SC*Cin + SC].
// Blocks 0 .. n_dx-1: the dx tiles, row tile major; then the dw3 tiles,
// group major. kVec: Cin % 4 == 0 (16-byte copies of w3t's and x's rows).
template <bool kVec>
__global__ void __launch_bounds__(kPT)
unit_ctr_gc_bwd_conv3_products(const float* __restrict__ dx3s, const float* __restrict__ x,
                               const float* __restrict__ w3t, float* __restrict__ dx,
                               float* __restrict__ partials, int NR, int SC, int Cin,
                               int group_rows, int n_dx) {
  extern __shared__ float4 smem4[];
  float* Ab = reinterpret_cast<float*>(smem4);
  float* Bb = Ab + 2 * mm::tile_chunk<kBK>();
  float* colsum = Bb + 2 * mm::tile_chunk<kBK>();  // [kPT]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // the warp's 32 x 32 of the tile
  const int tiles_n = cdiv(Cin, kBN);
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  float* out;
  int m0, n0, rows;
  const bool is_dx = (int)blockIdx.x < n_dx;
  bool sums_b = false;  // this block also sums db3's columns
  float bsum = 0.f;     // db3: column tid % kBM, rows of half tid / kBM of each chunk
  if (is_dx) {
    m0 = (blockIdx.x / tiles_n) * kBM;  // rows
    n0 = (blockIdx.x % tiles_n) * kBN;  // input channels
    mm::tile_product<kBK, false, true, kVec>(dx3s, SC, NR, w3t, Cin, Cin, m0, n0, 0, SC, Ab, Bb, acc,
                                        [](const float*) {});
    out = dx;
    rows = NR;
  } else {
    const int b = blockIdx.x - n_dx, tiles = cdiv(SC, kBM) * tiles_n;
    const int grp = b / tiles;
    m0 = ((b % tiles) / tiles_n) * kBM;  // packed output channels o
    n0 = ((b % tiles) % tiles_n) * kBN;  // input channels
    const int k_begin = grp * group_rows;  // rows of the group
    sums_b = n0 == 0;
    mm::tile_product<kBK, true, true, kVec>(
        dx3s, SC, SC, x, Cin, Cin, m0, n0, k_begin, imin(NR, k_begin + group_rows), Ab, Bb, acc,
        [&](const float* a) {
          if (sums_b) {
            const float* col = a + (tid / kBM) * (kBK / 2) * mm::kTileLd + tid % kBM;
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < kBK / 2; ++k) s += col[k * mm::kTileLd];
            bsum += s;
          }
        });
    out = partials + (size_t)grp * ((size_t)SC * Cin + SC);
    rows = SC;
  }

  // acc[mt][nt][i]: row m0 + 32*wm + 16*mt + lane/4 + 8*(i/2), column n0 +
  // 32*wn + 8*nt + 2*(lane%4) + i%2
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + 32 * wm + 16 * mt + lane / 4 + 8 * (i / 2);
        const int c = n0 + 32 * wn + 8 * nt + 2 * (lane % 4) + i % 2;
        if (r < rows && c < Cin) out[(size_t)r * Cin + c] = acc[mt][nt][i];
      }
  if (sums_b) {
    colsum[tid] = bsum;
    __syncthreads();
    if (tid < kBM && m0 + tid < SC) {
      out[(size_t)SC * Cin + m0 + tid] = colsum[tid] + colsum[tid + kBM];
    }
  }
}

// The bf16 form of the products (mma_bf16.cuh), the blocks as in
// unit_ctr_gc_bwd_conv3_products: dx (NR, Cin) in bf16 = bf16(dx3s) @ w3t,
// and the G groups' dw3t = bf16(dx3s)^T x and db3 (from the f32 dx3s)
// partials in f32. kVec: 16-byte loads of w3t's and x's bf16 rows.
template <bool kVec>
__global__ void __launch_bounds__(kPT)
unit_ctr_gc_bwd_conv3_products_bf16(const float* __restrict__ dx3s,
                                    const __nv_bfloat16* __restrict__ x,
                                    const __nv_bfloat16* __restrict__ w3t,
                                    __nv_bfloat16* __restrict__ dx,
                                    float* __restrict__ partials, int NR, int SC, int Cin,
                                    int group_rows, int n_dx) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem4);
  float4* colsum = reinterpret_cast<float4*>(
      reinterpret_cast<char*>(smem4) + mma_bf16::kTileSmemBytes);  // [kPT]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int tiles_n = cdiv(Cin, kBN);
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const bool is_dx = (int)blockIdx.x < n_dx;
  int m0, n0;
  if (is_dx) {
    m0 = (blockIdx.x / tiles_n) * kBM;  // rows
    n0 = (blockIdx.x % tiles_n) * kBN;  // input channels
    mma_bf16::tile_product_bf16<false, kVec>(dx3s, SC, NR, w3t, Cin, Cin, m0, n0, 0, SC, bufs,
                                             acc, [](const float4&) {});
    // acc[mt][nt][i]: row m0 + 32*wm + 16*mt + lane/4 + 8*(i/2), column n0 +
    // 32*wn + 8*nt + 2*(lane%4) + i%2, rounded once to bf16
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + 32 * wm + 16 * mt + lane / 4 + 8 * (i / 2);
          const int c = n0 + 32 * wn + 8 * nt + 2 * (lane % 4) + i % 2;
          if (r < NR && c < Cin) dx[(size_t)r * Cin + c] = __float2bfloat16_rn(acc[mt][nt][i]);
        }
    return;
  }
  const int b = blockIdx.x - n_dx, tiles = cdiv(SC, kBM) * tiles_n;
  const int grp = b / tiles;
  m0 = ((b % tiles) / tiles_n) * kBM;  // packed output channels o
  n0 = ((b % tiles) % tiles_n) * kBN;  // input channels
  const int k_begin = grp * group_rows;  // rows of the group
  const bool sums_b = n0 == 0;           // this block also sums db3's columns
  // db3: columns m0 + 4 * (tid % 16) .. + 3 over rows tid / 16 + 8 i of each
  // chunk, in f32 before the rounding
  float4 bsum = make_float4(0.f, 0.f, 0.f, 0.f);
  mma_bf16::tile_product_bf16<true, kVec>(
      dx3s, SC, SC, x, Cin, Cin, m0, n0, k_begin, imin(NR, k_begin + group_rows), bufs, acc,
      [&](const float4& v) {
        if (sums_b) {
          bsum.x += v.x;
          bsum.y += v.y;
          bsum.z += v.z;
          bsum.w += v.w;
        }
      });
  float* out = partials + (size_t)grp * ((size_t)SC * Cin + SC);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + 32 * wm + 16 * mt + lane / 4 + 8 * (i / 2);
        const int c = n0 + 32 * wn + 8 * nt + 2 * (lane % 4) + i % 2;
        if (r < SC && c < Cin) out[(size_t)r * Cin + c] = acc[mt][nt][i];
      }
  if (sums_b) {
    colsum[tid] = bsum;
    __syncthreads();
    // column m0 + c: the 8 threads tid % 16 == c / 4, in order of tid / 16
    if (tid < kBM && m0 + tid < SC) {
      float sum = 0.f;
      for (int h = 0; h < kPT / 16; ++h) {
        const float4 v = colsum[h * 16 + tid / 4];
        sum += (tid % 4 == 0 ? v.x : tid % 4 == 1 ? v.y : tid % 4 == 2 ? v.z : v.w);
      }
      out[(size_t)SC * Cin + m0 + tid] = sum;
    }
  }
}

// Sums the groups' partials in group order: dw3t [SC][Cin], then db3 [SC],
// each rounded once to TO.
template <typename TO>
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_conv3_reduce(const float* __restrict__ partials, int G, int SC, int Cin,
                             TO* __restrict__ dw3t, TO* __restrict__ db3) {
  const size_t per = (size_t)SC * Cin + SC;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= per) return;
  float sum = 0.f;
  for (int b = 0; b < G; ++b) sum += partials[(size_t)b * per + i];
  if (i < (size_t)SC * Cin) {
    Act<TO>::store(dw3t + i, sum);
  } else {
    Act<TO>::store(db3 + (i - (size_t)SC * Cin), sum);
  }
}

bool dims_ok(int N, int S, int T, int V, int R, int C, int Cin) {
  return dx3::dims_ok(N, S, T, V, R, C) && Cin >= 1 &&
         (long long)N * T * V * S * C < (1ll << 31);
}

// floats of scratch: dx3s, then the partials (16-byte aligned)
long long dx3_floats(int N, int S, int T, int V, int C) {
  return ((long long)N * T * V * S * C + 3) / 4 * 4;
}

}  // namespace

// Floats of device scratch (dx3s and the row groups' partial sums) that
// unit_ctr_gc_bwd_conv3_f32 and unit_ctr_gc_bwd_conv3_bf16 need (f32 in
// both); -1 where they do not take the shape.
extern "C" long long unit_ctr_gc_bwd_conv3_scratch_floats(int N, int S, int T, int V, int R,
                                                          int C, int Cin) {
  if (!dims_ok(N, S, T, V, R, C, Cin)) return -1;
  const int SC = S * C;
  const Groups grp = groups_of((long long)N * T * V, SC, Cin);
  return dx3_floats(N, S, T, V, C) + (long long)grp.count * ((long long)SC * Cin + SC);
}

// All tensors contiguous f32 on the device, g 16-byte aligned, w4s/b4s
// 16-byte aligned: x1s, x2s (N,S,V,R); g (N,T,V,C); w4s (S,R,C); b4s (S,C);
// alpha (1,); As (S,V,V); x (N,T,V,Cin); w3t (S*C,Cin), conv3's weight ->
// dx (N,T,V,Cin); dw3t (S*C,Cin); db3 (S*C,); scratch of
// unit_ctr_gc_bwd_conv3_scratch_floats floats, 16-byte aligned; C % 4 == 0
// and R <= 32. Launches on `stream` and returns the first non-zero
// cudaGetLastError() (0 = ok).
extern "C" int unit_ctr_gc_bwd_conv3_f32(
    const float* x1s, const float* x2s, const float* g, const float* w4s,
    const float* b4s, const float* alpha, const float* As, const float* x,
    const float* w3t, float* dx, float* dw3t, float* db3, float* scratch,
    int N, int S, int T, int V, int R, int C, int Cin, void* stream) {
  if (!dims_ok(N, S, T, V, R, C, Cin)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dx3s = scratch;
  float* partials = scratch + dx3_floats(N, S, T, V, C);
  int err = dx3::run<PhaseA, float>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C,
                                    st);
  if (err != cudaSuccess) return err;
  const int NR = N * T * V, SC = S * C;
  const Groups grp = groups_of(NR, SC, Cin);
  const int n_dx = cdiv(NR, kBM) * cdiv(Cin, kBN);
  const int blocks = n_dx + grp.count * cdiv(SC, kBM) * cdiv(Cin, kBN);
  const int smem = mm::tile_smem_bytes<kBK>() + kPT * (int)sizeof(float);
  auto products = Cin % 4 == 0 ? unit_ctr_gc_bwd_conv3_products<true>
                               : unit_ctr_gc_bwd_conv3_products<false>;
  err = cudaFuncSetAttribute(products, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  products<<<blocks, kPT, smem, st>>>(dx3s, x, w3t, dx, partials, NR, SC, Cin, grp.rows, n_dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per = (long long)SC * Cin + SC;
  unit_ctr_gc_bwd_conv3_reduce<float><<<cdiv(per, kThreads), kThreads, 0, st>>>(
      partials, grp.count, SC, Cin, dw3t, db3);
  return cudaGetLastError();
}

// As unit_ctr_gc_bwd_conv3_f32 with x1s, x2s, g, x, w3t, dx, dw3t and db3
// bf16 (g 8-byte aligned), the parameters and the scratch f32: the JAX
// kernel's bf16 body, as this file's header says.
extern "C" int unit_ctr_gc_bwd_conv3_bf16(
    const __nv_bfloat16* x1s, const __nv_bfloat16* x2s, const __nv_bfloat16* g,
    const float* w4s, const float* b4s, const float* alpha, const float* As,
    const __nv_bfloat16* x, const __nv_bfloat16* w3t, __nv_bfloat16* dx,
    __nv_bfloat16* dw3t, __nv_bfloat16* db3, float* scratch, int N, int S, int T, int V,
    int R, int C, int Cin, void* stream) {
  if (!dims_ok(N, S, T, V, R, C, Cin)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dx3s = scratch;
  float* partials = scratch + dx3_floats(N, S, T, V, C);
  int err = dx3::run<PhaseA, __nv_bfloat16>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V,
                                            R, C, st);
  if (err != cudaSuccess) return err;
  const int NR = N * T * V, SC = S * C;
  const Groups grp = groups_of(NR, SC, Cin);
  const int n_dx = cdiv(NR, kBM) * cdiv(Cin, kBN);
  const int blocks = n_dx + grp.count * cdiv(SC, kBM) * cdiv(Cin, kBN);
  const int smem = mma_bf16::kTileSmemBytes + kPT * (int)sizeof(float4);
  const bool vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w3t) % 16 == 0;
  auto products = vec ? unit_ctr_gc_bwd_conv3_products_bf16<true>
                      : unit_ctr_gc_bwd_conv3_products_bf16<false>;
  err = cudaFuncSetAttribute(products, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  products<<<blocks, kPT, smem, st>>>(dx3s, x, w3t, dx, partials, NR, SC, Cin, grp.rows, n_dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per = (long long)SC * Cin + SC;
  unit_ctr_gc_bwd_conv3_reduce<__nv_bfloat16><<<cdiv(per, kThreads), kThreads, 0, st>>>(
      partials, grp.count, SC, Cin, dw3t, db3);
  return cudaGetLastError();
}
