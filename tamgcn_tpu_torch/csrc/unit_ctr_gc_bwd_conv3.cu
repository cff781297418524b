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
// w4s, b4s, alpha and As: the x3 gradient is f32 and enters both products
// rounded once to bf16, db3 sums it unrounded. At the deep shape the
// operations bound it: ~3.3 GFLOP of bf16 products, ~3.3 us at the 989
// TFLOP/s bf16 peak, beside ~7 MB of bf16 bytes (~2.1 us) and phase A's
// ~1 us. The design before this one staged phase B's A operand from the f32
// scratch through registers (rounded there, db3 summed there) into 64 x 64
// tiles behind one barrier a chunk of 32 k: twice the bytes of that operand,
// and every warp spent its issue slots on the copy.
//   Phase A, whole-V (V <= 24): K2-bf16's body under K6's name writes dx3s
//   already rounded to bf16 (the same values as rounding it at staging) to
//   the scratch, half the bytes, and in its epilogue each block sums its
//   channels' columns over its rows (all frames and joints of one sample)
//   in f32 before the rounding, in a fixed order: db3's partials, one row a
//   sample. Past V = 24 the joint-tiled body writes f32 and a rounding pass
//   (unit_ctr_gc_bwd_conv3_round) writes the bf16 copy and the column sums
//   of each 64 rows.
//   Phase B reads only bf16: 128 x 64 output tiles of 8 warps (each 32 x 32,
//   mma.sync m16n8k16 bf16 with f32 accumulation, fragments by ldmatrix),
//   both operands copied by cp.async into a ring of 4 chunks of 64 k, three
//   in flight while the warps multiply the fourth (mma_bf16.cuh); the dw3
//   groups are as many as fill one wave of two blocks an SM with the dx
//   tiles (groups_bf16), so that no second, short wave trails. Where Cin
//   % 8 != 0 (or x, w3t are not 16-byte aligned) x's and w3t's values are
//   loaded one at a time into the ring; where S*C % 8 != 0 dx3s's copies are
//   8 bytes.
//   The last launch sums dw3's group partials in group order and db3's
//   column partials in row order, and rounds each once to bf16. Nothing uses
//   atomics: two launches give bitwise equal gradients.
// What it leaves: mma.sync, not wgmma; dx3s's round trip through L2.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "unit_ctr_gc_dx3.cuh"

namespace {

using namespace unit_ctr_gc;
namespace mm = mma_tf32x3;

// ---- phase A: K2's kernels under K6's names ----

// floats of the scratch that hold the bf16 dx3s (N*T*V*S*C values), a
// multiple of 4: the column partials of db3 follow, 16-byte aligned
__host__ __device__ inline long long dx3h_floats(int N, int S, int T, int V, int C) {
  return ((long long)N * T * V * S * C + 7) / 8 * 4;
}

// The whole-V body. TO float: dx3s in f32 (the f32 form). TO bf16 (the bf16
// form): dx3s rounded once to bf16, and db3's column partials of the
// unrounded values, one row per sample, right after it in the scratch
// (colsum [N][S*C], N = gridDim.z).
template <int RP, int JT, typename TA, typename TO>
__global__ void __launch_bounds__(kThreads, 2)
unit_ctr_gc_bwd_conv3_kernel(const TA* __restrict__ x1s, const TA* __restrict__ x2s,
                             const TA* __restrict__ g, const float* __restrict__ w4s,
                             const float* __restrict__ b4s, const float* __restrict__ alpha,
                             const float* __restrict__ As, TO* __restrict__ dx3s, int S,
                             int T, int V, int R, int C) {
  if constexpr (sizeof(TO) == 4) {
    whole::run<false, RP, JT, TA, TA, TO>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, S, T, V, R,
                                          C);
  } else {
    float* colsum = reinterpret_cast<float*>(dx3s) + dx3h_floats(gridDim.z, S, T, V, C);
    constexpr Stage1 kS1 = sizeof(TA) == 4 ? Stage1::kF32 : Stage1::kBf16;
    whole::run<false, RP, JT, TA, TA, TO, kS1, true>(
        x1s, x2s, g, w4s, b4s, alpha, As, dx3s, S, T, V, R, C, colsum);
  }
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
  template <int RP, int JT, typename TA, typename TO>
  static int whole(dim3 grid, size_t smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* g, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, TO* dx3s, int S, int T, int V, int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_bwd_conv3_kernel<RP, JT, TA, TO>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    unit_ctr_gc_bwd_conv3_kernel<RP, JT, TA, TO><<<grid, kThreads, smem, st>>>(
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

// ---- the bf16 form's phase B: 128 x 64 tiles (mma_bf16.cuh) ----

constexpr int kHM = mma_bf16::kTileM, kHN = mma_bf16::kTileN, kHK = mma_bf16::kKC;
constexpr int kHBlocks = 264;   // blocks of phase B a launch aims for: one wave, two an SM
constexpr int kRoundRows = 64;  // rows of one column partial of the rounding pass
// rows of a dw3 group at most: its MMAs sum in their accumulators, so that a
// group's sum truncates once a k step of 16 rows (mma_bf16.cuh)
constexpr int kGroupRowsMax = 1024;

// The rows of each dw3 group (a multiple of kHK) and the number of groups:
// as many groups as the dw3 tiles and the dx tiles together fit into
// kHBlocks (one at least), at least 4 chunks of rows each, at most
// kGroupRowsMax rows each.
__host__ __device__ inline Groups groups_bf16(long long NR, int SC, int Cin) {
  const int tiles = cdiv(SC, kHM) * cdiv(Cin, kHN);
  const int n_dx = cdiv(NR, kHM) * cdiv(Cin, kHN);
  const int want = imax(imax(1, cdiv(NR, kGroupRowsMax)),
                        imin(imax(tiles, kHBlocks - n_dx) / tiles, cdiv(NR, 4 * kHK)));
  const int rows = cdiv(cdiv(NR, want), kHK) * kHK;
  return Groups{rows, cdiv(NR, rows)};
}

// The rows of db3's column partials: one per sample from the whole-V body,
// one per kRoundRows rows from the rounding pass after the joint-tiled one.
__host__ __device__ inline int colsum_rows(int N, int T, int V) {
  return whole::takes(V) ? N : cdiv((long long)N * T * V, kRoundRows);
}

// The bf16 form's scratch, in floats: dx3s in bf16, db3's column partials
// [colsum_rows][SC], dw3's group partials [G][SC*Cin]; past V = 24 also
// dx3s in f32 (the joint-tiled body's output, which the rounding pass reads).
struct Bf16Scratch {
  long long colsum, partials, dx3f, end;
};
__host__ inline Bf16Scratch bf16_scratch(int N, int S, int T, int V, int C, int Cin) {
  const long long NR = (long long)N * T * V, SC = (long long)S * C;
  Bf16Scratch o;
  o.colsum = dx3h_floats(N, S, T, V, C);
  o.partials = o.colsum + (colsum_rows(N, T, V) * SC + 3) / 4 * 4;
  o.dx3f = o.partials + (long long)groups_bf16(NR, (int)SC, Cin).count * SC * Cin;
  o.end = o.dx3f + (whole::takes(V) ? 0 : NR * SC);
  return o;
}

// dx3h = bf16(dx3f) and, per kRoundRows rows (blockIdx.x) and column (one
// a thread), the column sums of the unrounded values in row order
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_conv3_round(const float* __restrict__ dx3f, __nv_bfloat16* __restrict__ dx3h,
                            float* __restrict__ colsum, int NR, int SC) {
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= SC) return;
  const int r0 = blockIdx.x * kRoundRows, r1 = imin(NR, r0 + kRoundRows);
  float sum = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float v = dx3f[(size_t)r * SC + col];
    dx3h[(size_t)r * SC + col] = __float2bfloat16_rn(v);
    sum += v;
  }
  colsum[(size_t)blockIdx.x * SC + col] = sum;
}

// dx (NR, Cin) in bf16 = dx3h @ w3t, and the G groups' dw3t (SC, Cin) =
// dx3h^T x partials in f32 ([G][SC*Cin]): blocks 0 .. n_dx-1 the dx tiles,
// row tile major, then the dw3 tiles, group major. Both operands bf16,
// copied asynchronously (mma_bf16.cuh: tile_product_bf16). kVecA: SC % 8 ==
// 0 (16-byte copies of dx3h's rows); kVecB: Cin % 8 == 0 and x, w3t 16-byte
// aligned (16-byte copies of their rows).
template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(mma_bf16::kTileThreads)
unit_ctr_gc_bwd_conv3_products_bf16(const __nv_bfloat16* __restrict__ dx3h,
                                    const __nv_bfloat16* __restrict__ x,
                                    const __nv_bfloat16* __restrict__ w3t,
                                    __nv_bfloat16* __restrict__ dx,
                                    float* __restrict__ partials, int NR, int SC, int Cin,
                                    int group_rows, int n_dx) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);
  constexpr int kMT = mma_bf16::kMT, kWM = mma_bf16::kWarpM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / mma_bf16::kWarpsN, wn = warp % mma_bf16::kWarpsN;
  const int tiles_n = cdiv(Cin, kHN);
  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const bool is_dx = (int)blockIdx.x < n_dx;
  int m0, n0, rows;
  if (is_dx) {
    m0 = (blockIdx.x / tiles_n) * kHM;  // rows
    n0 = (blockIdx.x % tiles_n) * kHN;  // input channels
    rows = NR;
    mma_bf16::tile_product_bf16<false, kVecA, kVecB>(dx3h, SC, NR, w3t, Cin, Cin, m0, n0, 0, SC,
                                                     ring, acc);
  } else {
    const int b = blockIdx.x - n_dx, tiles = cdiv(SC, kHM) * tiles_n;
    const int grp = b / tiles;
    m0 = ((b % tiles) / tiles_n) * kHM;  // packed output channels o
    n0 = ((b % tiles) % tiles_n) * kHN;  // input channels
    rows = SC;
    const int k_begin = grp * group_rows;  // rows of the group
    mma_bf16::tile_product_bf16<true, kVecA, kVecB>(dx3h, SC, SC, x, Cin, Cin, m0, n0, k_begin,
                                                    imin(NR, k_begin + group_rows), ring, acc);
    partials += (size_t)grp * SC * Cin;
  }
  // the tile through the ring, then whole rows: acc[mt][nt][i] is row
  // kWM*wm + 16*mt + lane/4 + 8*(i/2), column 32*wn + 8*nt + 2*(lane%4) + i%2
  // of the tile; dx rounded once to bf16 (row stride kHN + 8), the dw3
  // partials in f32 (kHN + 4). Rows and columns past the ends are not
  // written; 16-byte stores where Cin % 8 == 0 (dx) or Cin % 4 == 0 (dw3).
  __syncthreads();  // every warp is done with the ring
  constexpr int kLdO = kHN + 8, kLdP = kHN + 4;
  __nv_bfloat16* tile_h = ring;
  float* tile_f = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = kWM * wm + 16 * mt + lane / 4 + 8 * h;
        const int c = 32 * wn + 8 * nt + 2 * (lane % 4);
        if (is_dx) {
          *reinterpret_cast<__nv_bfloat162*>(tile_h + r * kLdO + c) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else {
          *reinterpret_cast<float2*>(tile_f + r * kLdP + c) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
  __syncthreads();
  const int per_row = is_dx ? kHN / 8 : kHN / 4;  // 16-byte units of a tile row
  const bool vec = Cin % (is_dx ? 8 : 4) == 0;
  for (int q = threadIdx.x; q < kHM * per_row; q += mma_bf16::kTileThreads) {
    const int r = q / per_row, c = (q % per_row) * (is_dx ? 8 : 4);
    if (m0 + r >= rows || n0 + c >= Cin) continue;
    const size_t at = (size_t)(m0 + r) * Cin + n0 + c;
    if (is_dx) {
      if (vec) {
        *reinterpret_cast<uint4*>(dx + at) = *reinterpret_cast<const uint4*>(tile_h + r * kLdO + c);
      } else {
        for (int e = 0; e < 8 && n0 + c + e < Cin; ++e) dx[at + e] = tile_h[r * kLdO + c + e];
      }
    } else {
      if (vec) {
        *reinterpret_cast<float4*>(partials + at) =
            *reinterpret_cast<const float4*>(tile_f + r * kLdP + c);
      } else {
        for (int e = 0; e < 4 && n0 + c + e < Cin; ++e) partials[at + e] = tile_f[r * kLdP + c + e];
      }
    }
  }
}

// Sums dw3t's G group partials in group order and db3's column partials in
// row order, each rounded once to bf16.
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_conv3_reduce_bf16(const float* __restrict__ partials, int G,
                                  const float* __restrict__ colsum, int P, int SC, int Cin,
                                  __nv_bfloat16* __restrict__ dw3t,
                                  __nv_bfloat16* __restrict__ db3) {
  const size_t n_w = (size_t)SC * Cin;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  float sum = 0.f;
  if (i < n_w) {
    for (int b = 0; b < G; ++b) sum += partials[(size_t)b * n_w + i];
    dw3t[i] = __float2bfloat16_rn(sum);
  } else if (i < n_w + SC) {
    const size_t o = i - n_w;
    for (int p = 0; p < P; ++p) sum += colsum[(size_t)p * SC + o];
    db3[o] = __float2bfloat16_rn(sum);
  }
}

// the bf16 form's phase A in the whole-V design: dx3s in bf16 and db3's
// column partials (unit_ctr_gc_bwd_conv3_kernel<.., __nv_bfloat16>)
template <int RP>
int phase_a_bf16(const __nv_bfloat16* x1s, const __nv_bfloat16* x2s, const __nv_bfloat16* g,
                 const float* w4s, const float* b4s, const float* alpha, const float* As,
                 __nv_bfloat16* dx3h, int N, int S, int T, int V, int R, int C,
                 cudaStream_t st) {
  return whole::launch<PhaseA, false, RP>(x1s, x2s, g, w4s, b4s, alpha, As, dx3h, N, S, T, V, R,
                                          C, st);
}

// Sums the groups' partials in group order: dw3t [SC][Cin], then db3 [SC].
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_conv3_reduce(const float* __restrict__ partials, int G, int SC, int Cin,
                             float* __restrict__ dw3t, float* __restrict__ db3) {
  const size_t per = (size_t)SC * Cin + SC;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= per) return;
  float sum = 0.f;
  for (int b = 0; b < G; ++b) sum += partials[(size_t)b * per + i];
  if (i < (size_t)SC * Cin) {
    dw3t[i] = sum;
  } else {
    db3[i - (size_t)SC * Cin] = sum;
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

// Floats of device scratch (dx3s and the partial sums) that
// unit_ctr_gc_bwd_conv3_f32 and unit_ctr_gc_bwd_conv3_bf16 need (f32 in
// both, the larger of the two); -1 where they do not take the shape.
extern "C" long long unit_ctr_gc_bwd_conv3_scratch_floats(int N, int S, int T, int V, int R,
                                                          int C, int Cin) {
  if (!dims_ok(N, S, T, V, R, C, Cin)) return -1;
  const int SC = S * C;
  const Groups grp = groups_of((long long)N * T * V, SC, Cin);
  const long long f32 = dx3_floats(N, S, T, V, C) + (long long)grp.count * ((long long)SC * Cin + SC);
  const long long bf16 = bf16_scratch(N, S, T, V, C, Cin).end;
  return f32 > bf16 ? f32 : bf16;
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
  unit_ctr_gc_bwd_conv3_reduce<<<cdiv(per, kThreads), kThreads, 0, st>>>(
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
  const int NR = N * T * V, SC = S * C;
  const Bf16Scratch sc = bf16_scratch(N, S, T, V, C, Cin);
  __nv_bfloat16* dx3h = reinterpret_cast<__nv_bfloat16*>(scratch);
  float* colsum = scratch + sc.colsum;
  float* partials = scratch + sc.partials;
  int err;
  if (whole::takes(V)) {
    err = R <= 8    ? phase_a_bf16<8>(x1s, x2s, g, w4s, b4s, alpha, As, dx3h, N, S, T, V, R, C, st)
          : R <= 16 ? phase_a_bf16<16>(x1s, x2s, g, w4s, b4s, alpha, As, dx3h, N, S, T, V, R, C, st)
                    : phase_a_bf16<32>(x1s, x2s, g, w4s, b4s, alpha, As, dx3h, N, S, T, V, R, C, st);
  } else {
    // the joint-tiled body writes f32; a pass rounds it and sums its columns
    float* dx3f = scratch + sc.dx3f;
    err = dx3::run<PhaseA, __nv_bfloat16>(x1s, x2s, g, w4s, b4s, alpha, As, dx3f, N, S, T, V, R,
                                          C, st);
    if (err != cudaSuccess) return err;
    unit_ctr_gc_bwd_conv3_round<<<dim3(cdiv(NR, kRoundRows), cdiv(SC, kThreads)), kThreads, 0,
                                  st>>>(dx3f, dx3h, colsum, NR, SC);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const Groups grp = groups_bf16(NR, SC, Cin);
  const int n_dx = cdiv(NR, kHM) * cdiv(Cin, kHN);
  const int blocks = n_dx + grp.count * cdiv(SC, kHM) * cdiv(Cin, kHN);
  const int smem = mma_bf16::kTileSmemBytes;
  const bool vec_b = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w3t) % 16 == 0;
  auto products = SC % 8 == 0 ? (vec_b ? unit_ctr_gc_bwd_conv3_products_bf16<true, true>
                                       : unit_ctr_gc_bwd_conv3_products_bf16<true, false>)
                              : (vec_b ? unit_ctr_gc_bwd_conv3_products_bf16<false, true>
                                       : unit_ctr_gc_bwd_conv3_products_bf16<false, false>);
  err = cudaFuncSetAttribute(products, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  products<<<blocks, mma_bf16::kTileThreads, smem, st>>>(dx3h, x, w3t, dx, partials, NR, SC, Cin,
                                                         grp.rows, n_dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per = (long long)SC * Cin + SC;
  unit_ctr_gc_bwd_conv3_reduce_bf16<<<cdiv(per, kThreads), kThreads, 0, st>>>(
      partials, grp.count, colsum, colsum_rows(N, T, V), SC, Cin, dw3t, db3);
  return cudaGetLastError();
}
