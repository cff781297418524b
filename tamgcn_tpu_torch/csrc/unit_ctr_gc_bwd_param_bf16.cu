// Unit CTR-GC backward, the parameter gradients (K3), bf16 form, for Hopper
// (sm_90a): bf16 activations (x1s, x2s, g, x3s in; dx1s, dx2s out, rounded
// once) with f32 parameters and f32 parameter gradients.
//
// Replaces the bf16 body of tamgcn_tpu/ops/pallas/ctr_gc.py:
// _unit_bwd_param_kernel_flat (launched by _unit_param_grads), which computes
// what unit_ctr_gc_bwd_param.cu's header sets out on the widened activations:
// dm = sum_t g x3s as f32 sums of exact products of bf16 values (phase B,
// ctr_gc.py:746-763), then D = tanh(x1s - x2s), P = D^T dm, DD = dm w4^T and
// the sums of phase C (ctr_gc.py:765-815) in f32.
//
// What bounds it on this card. At the deep NW-UCLA shape (N=16, T=13, V=20,
// C=256, R=32) it reads ~8.5 MB of bf16 g and x3s (~2.5 us at 3.35 TB/s) and
// does 0.128 GFLOP of dm (bf16 products: 0.13 us at 989 TFLOP/s) and 0.629
// GFLOP of P and DD (f32 products: 3.8 us as 3xTF32 at 165 TFLOP/s). The
// f32 design it replaces (unit_ctr_gc_bwd_param.cu on the widened values)
// ran all of it as FFMA on the CUDA cores, at ~6% of their rate: its dm
// loop read shared memory more than it computed.
//
// What the design does about it. The block split and the partials are the
// f32 kernel's (unit_ctr_gc_param.cuh): a block per
// (sample n, subset s, tile of J <= 20 joints u, tile of 16 channels), any V
// and C, R <= 32; it walks the tiles of J joints v. Per v tile:
//   1. dm on the tensor cores. Per channel, dm_c (u x v) is the product
//      g_c^T (u x t) x3s_c (t x v): mma.sync m16n8k16 bf16 with f32
//      accumulation, the products exact as in the JAX body, the joints padded
//      to 16 or 32, warp w takes channels 2w and 2w + 1. g and x3s are
//      channel-contiguous (NTVC), and a fragment pairs two frames of one
//      channel: each chunk of 16 frames is loaded 16 bytes (8 channels) a
//      thread, two frames at once, and stored transposed to [channel][joint]
//      [frame] with the two frames of a channel in one 32-bit word, rows of
//      48 bytes, so that ldmatrix reads the fragments without bank conflicts.
//      (Chunks of 32 frames spilled registers and were no faster.)
//   2. dm to shared memory as [pair (u, v)][channel]; D = tanh(x1_u - x2_v)
//      (accurate tanhf) over the tile's pairs beside it; dA's channel sums and
//      sum(dm) from dm. Where V fits one joint tile (V <= 20) and R > 8, D
//      is the same for all C / 16 channel tiles of an (n, s): a first launch
//      computes it once (f32, to the scratch; 2.4 MB at the deep shape, read
//      from L2) and each block copies it by cp.async while it writes dm.
//   3. P^T (channels x r) += dm^T D over the pairs, and DD (pairs x r) = dm
//      w4^T over the tile's 16 channels, both on the tensor cores as 3xTF32
//      (mma.sync m16n8k8; mma_tf32x3.cuh: each f32 operand split into its
//      TF32 part and remainder, three products a term), the f32 grade the
//      JAX body computes them at; P's pair steps are split over the warps,
//      each summing its own share in a fixed order into its accumulators;
//      w4's TF32 parts are split once a block. dpre = DD (1 - D^2) goes to D's place; its sums over v
//      (dx1) and u (dx2) follow as in the f32 kernel.
// The partials are the f32 kernel's. A reduce kernel of its own sums them:
// a thread an output, but 32 threads for each of dA's (whose sums run over N
// * C / 16 partials), each a fixed slice of its terms in four running sums,
// combined in order; only the dw4/db4 blocks take the dalpha ticket. The f32 kernel's
// reduce runs one thread an output, 12-14 us a launch. No sum depends on
// the order in which blocks finish: two launches give bitwise equal
// gradients. The C launcher counts its launches where it launches the main
// kernel (unit_ctr_gc_bwd_param_bf16_launched).
// What it leaves: past V = 20 (and at R <= 8) D is built again by each of
// the C / 16 channel tiles of an (n, s, u tile), R * J * J tanhf a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "unit_ctr_gc_common.cuh"
#include "unit_ctr_gc_param.cuh"

namespace {

using namespace unit_ctr_gc::param;
using unit_ctr_gc::kThreads;
using mma_tf32x3::mma_tf32;
using mma_tf32x3::split;

constexpr int kWarps = kThreads / 32;
constexpr int kTC = 16;        // frames per staged chunk: one k step of m16n8k16
constexpr int kLdT = kTC + 8;  // bf16 row stride of a staged [channel][joint] row: 48 bytes
constexpr int kDMS = 20;       // row stride of DM [pair][channel]
// the reduce kernel: a block takes kThreads outputs of dw4s/db4s or
// dx1s/dx2s (N * ceil(V / 20) and C / 16 * ceil(V / 20) terms: a thread
// each), or kRedOutsA of dAs, whose sums are the long ones (N * C / 16
// terms; kThreads / kRedOutsA threads each)
constexpr int kRedOuts = kThreads, kRedOutsA = 8;
static_assert(kCT == 2 * kWarps, "warp w owns channels 2w and 2w + 1 of the dm product");

long long g_launched = 0;  // launches of the main kernel

// The row stride of D [pair][r]: 8 or 24 modulo 32, so that a fragment's
// reads (row t4, column g) hit 32 distinct banks; of W [channel][r] in
// (hi, lo) pairs: 4 modulo 8, so that a half warp's 8-byte reads do.
__host__ __device__ constexpr int d_stride(int RP) { return RP == 32 ? 40 : RP == 16 ? 24 : 8; }
__host__ __device__ constexpr int w_stride(int RP) { return RP + 4; }

__host__ inline int rp_of(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : 32; }

// Whether the launch takes D from the first launch: one joint tile, R > 8.
__host__ inline bool pre_d(int V, int R) { return tiling(V).nt == 1 && R > 8; }

// The reduce kernel's blocks: first those of dw4s and db4s (S*(R*C + C)
// outputs, the dalpha terms), then of dAs (S*V*V), then of dx1s and dx2s
// (2*N*S*V*R).
struct RedBlocks {
  int p, a, x;
};
__host__ __device__ inline RedBlocks red_blocks(int N, int S, int V, int R, int C) {
  const long long np = (long long)S * ((long long)R * C + C), na = (long long)S * V * V;
  const long long nx = 2ll * N * S * V * R;
  return {(int)((np + kRedOuts - 1) / kRedOuts), (int)((na + kRedOutsA - 1) / kRedOutsA),
          (int)((nx + kRedOuts - 1) / kRedOuts)};
}
__host__ inline int reduce_blocks(int N, int S, int V, int R, int C) {
  const RedBlocks rb = red_blocks(N, S, V, R, C);
  return rb.p + rb.a + rb.x;
}

// The scratch, in floats: the partials, the reduce blocks' dalpha terms, the
// ticket counter; with pre_d, D [N][S][V*V][RP] after them, 16-byte aligned.
struct Scratch {
  long long terms, done, d, end;
};
__host__ inline Scratch scratch_of(int N, int S, int V, int R, int C) {
  Scratch o;
  o.terms = (long long)parts(N, S, V, R, C).end;
  o.done = o.terms + reduce_blocks(N, S, V, R, C);
  o.d = (o.done + 1 + 3) / 4 * 4;
  o.end = o.d + (pre_d(V, R) ? (long long)N * S * V * V * rp_of(R) : 0);
  return o;
}

// the pairs (u, v) of a J x J tile, padded to whole m16 tiles of DD
__host__ __device__ inline int pairs_padded(int J) { return (J * J + 15) / 16 * 16; }

// Shared memory, in floats: the region (the staged chunks of g and x3s; then
// D and dpre beside dm; then the cross-warp sums of P and sum(dm)), W, E,
// DX1: 108 KB at R = 32 and V = 20, two blocks an SM.
template <int RP, int JM>
__host__ __device__ inline int region_floats(int J) {
  constexpr int JP = 16 * JM;
  const int chunks = kCT * JP * kLdT;  // two bf16 chunks
  const int d = pairs_padded(J) * (d_stride(RP) + kDMS);
  const int red = kWarps * kCT * RP + kThreads;
  const int m = chunks > d ? chunks : d;
  return m > red ? m : red;
}
template <int RP, int JM>
__host__ inline size_t smem_bytes(int J) {
  return sizeof(float) *
         ((size_t)region_floats<RP, JM>(J) + 2 * kCT * w_stride(RP) + 3 * kJmax * RP);
}

// 8 channels (16 bytes) of a row of g or x3s at p, zero where !ok; without
// kVec one value at a time, the channels from `left` on zero
template <bool kVec>
__device__ inline uint4 load8(const __nv_bfloat16* p, bool ok, int left) {
  if constexpr (kVec) {
    return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = ok && 2 * k < left ? *reinterpret_cast<const uint16_t*>(p + 2 * k) : 0u;
      const uint32_t hi =
          ok && 2 * k + 1 < left ? *reinterpret_cast<const uint16_t*>(p + 2 * k + 1) : 0u;
      w[k] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One chunk of kTC frames (tb ..) of g (joints u0 .., nu of them, row stride
// C) and of x3s (joints v0 .., nv, row stride S*C, subset s) into Gc and Xc
// [kCT][JP][kLdT] transposed, zero past T, the joints and C. An item is
// (tensor, frame pair, joint, 8 channels): two 16-byte loads, eight 32-bit
// stores of (frame, frame + 1) pairs. A thread issues the loads of all its
// items (both tensors) before it stores any, so that a chunk waits for one
// load latency.
template <int JP, bool kVec>
__device__ inline void stage(uint32_t* Gc, uint32_t* Xc, const __nv_bfloat16* __restrict__ g,
                             const __nv_bfloat16* __restrict__ x3s, int n, int S, int T, int V,
                             int tb, int u0, int nu, int v0, int nv, int s, int c0, int C) {
  constexpr int kPairs = kTC / 2;
  constexpr int kItems = 2 * kPairs * JP / kThreads;  // of each tensor
  static_assert(2 * kPairs * JP % kThreads == 0, "whole items per thread");
  uint4 lo[2][kItems], hi[2][kItems];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int h = i & 1, tp = (i >> 1) % kPairs, j = i / (2 * kPairs);
      const int t = tb + 2 * tp, c = c0 + 8 * h;
      const bool ok = j < (x ? nv : nu) && c < C;
      const size_t ld = x ? (size_t)S * C : (size_t)C;
      const __nv_bfloat16* p = (x ? x3s + (size_t)s * C : g) +
                               (((size_t)n * T + t) * V + (x ? v0 : u0) + j) * ld + c;
      lo[x][k] = load8<kVec>(p, ok && t < T, C - c);
      hi[x][k] = load8<kVec>(p + (size_t)V * ld, ok && t + 1 < T, C - c);
    }
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int h = i & 1, tp = (i >> 1) % kPairs, j = i / (2 * kPairs);
      const uint32_t a[4] = {lo[x][k].x, lo[x][k].y, lo[x][k].z, lo[x][k].w};
      const uint32_t b[4] = {hi[x][k].x, hi[x][k].y, hi[x][k].z, hi[x][k].w};
      uint32_t* row = (x ? Xc : Gc) + ((8 * h) * JP + j) * (kLdT / 2) + tp;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        row[(2 * m) * JP * (kLdT / 2)] = __byte_perm(a[m], b[m], 0x5410);
        row[(2 * m + 1) * JP * (kLdT / 2)] = __byte_perm(a[m], b[m], 0x7632);
      }
    }
}

// acc += the three TF32 products of one f32 term (lo*hi + hi*lo + hi*hi),
// B given by its (hi, lo) parts
__device__ inline void mma3(float (&acc)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                            uint32_t h0, uint32_t l0, uint32_t h1, uint32_t l1) {
  mma_tf32(acc, alo, h0, h1);
  mma_tf32(acc, ahi, l0, l1);
  mma_tf32(acc, ahi, h0, h1);
}
__device__ inline void mma3(float (&acc)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                            float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma3(acc, ahi, alo, h0, l0, h1, l1);
}

// D of every (n, s, u, v) for V <= kJmax: Dg[((n*S + s)*V*V + u*V + v)*RP +
// r] = tanh(x1s[n,s,u,r] - x2s[n,s,v,r]) for r < R, zero to RP
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_param_bf16_tanh(const __nv_bfloat16* __restrict__ x1s,
                                const __nv_bfloat16* __restrict__ x2s, float* __restrict__ Dg,
                                int total, int V, int R, int RP) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int r = i % RP, pv = i / RP, VV = V * V;
  const int ns = pv / VV, p = pv % VV, u = p / V, v = p % V;
  Dg[i] = r < R ? tanhf(__bfloat162float(x1s[(ns * V + u) * R + r]) -
                        __bfloat162float(x2s[(ns * V + v) * R + r]))
                : 0.f;
}

template <int RP, int JM, bool kVec, bool kPreD>
__global__ void __launch_bounds__(kThreads, 2)
unit_ctr_gc_bwd_param_bf16_kernel(const __nv_bfloat16* __restrict__ x1s,
                                  const __nv_bfloat16* __restrict__ x2s,
                                  const __nv_bfloat16* __restrict__ g,
                                  const __nv_bfloat16* __restrict__ x3s,
                                  const float* __restrict__ w4s, float* __restrict__ part,
                                  unsigned int* __restrict__ done, const float* __restrict__ Dg,
                                  int N, int S, int T, int V, int R, int C) {
  constexpr int JP = 16 * JM;  // joints of a tile, padded for the dm product
  constexpr int kNV = JM == 2 ? 3 : 2;  // n8 tiles of v: 24 >= J (J <= 20) or 16
  constexpr int DS = d_stride(RP), WS = w_stride(RP);
  constexpr int kNT = RP / 8;  // n8 tiles of r
  extern __shared__ float4 smem4[];
  const Tiling tl = tiling(V);
  const int J = tl.J, PJ = J * J, PP = pairs_padded(J);
  const int KC = channel_tiles(C);
  // the region: Gc, Xc [kCT][JP][kLdT] bf16, the chunk of g (u) and of x3s
  // (v), as 32-bit (frame, frame + 1) words; then D [PP][DS], D = tanh(x1_u
  // - x2_v) and then dpre, and DM [PP][kDMS], dm of the tile; after the last
  // v tile, Red [kWarps][kCT][RP] and Rs [kThreads], the warps' P^T and the
  // threads' sum(dm)
  float* region = reinterpret_cast<float*>(smem4);
  uint32_t* Gc = reinterpret_cast<uint32_t*>(region);
  uint32_t* Xc = Gc + kCT * JP * (kLdT / 2);
  float* D = region;
  float* DM = region + PP * DS;
  // [kCT][WS]: w4s[s] of the channels, as (hi, lo) TF32 parts
  float2* W = reinterpret_cast<float2*>(region + region_floats<RP, JM>(J));
  float* E = reinterpret_cast<float*>(W + kCT * WS);  // [2][kJmax][RP]: x1 rows, x2 rows
  float* DX1 = E + 2 * kJmax * RP;                  // [kJmax][RP]: sum_v dpre so far

  const int ut = blockIdx.x / KC, kc = blockIdx.x % KC;
  const int s = blockIdx.y, n = blockIdx.z;
  const int u0 = ut * J, c0 = kc * kCT;
  const int nu = min(J, V - u0);  // joints of the u tile that exist
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const Parts pt = parts(N, S, V, R, C);

  // the reduce kernel's ticket counter starts at 0
  if (blockIdx.x == 0 && s == 0 && n == 0 && tid == 0) *done = 0;
  for (int i = tid; i < kJmax * RP; i += kThreads) DX1[i] = 0.f;

  float pacc[kNT][4];  // P^T (channels gq, gq + 8 x r) of this warp's pair steps
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) pacc[nt][i] = 0.f;
  float psum = 0.f;  // sum(dm) of channel tid % kCT over pairs tid / kCT + 16 i

  for (int v0 = 0; v0 < V; v0 += J) {
    const int nv = min(J, V - v0);
    // ---- 1. dm of the tile on the tensor cores ----
    float acc[2][JM][kNV][4];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int mt = 0; mt < JM; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNV; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[ch][mt][nt][i] = 0.f;
    if constexpr (!kPreD) {
      // E: the x1 rows of the u tile and the x2 rows of the v tile, while
      // the chunks load (D of the last v tile was built before its barriers)
      const __nv_bfloat16* x1 = x1s + ((size_t)n * S + s) * V * R;
      const __nv_bfloat16* x2 = x2s + ((size_t)n * S + s) * V * R;
      for (int i = tid; i < 2 * J * RP; i += kThreads) {
        const int r = i % RP, row = i / RP;  // row < J: x1 of u0 + row
        const bool x1row = row < J;
        const int j = x1row ? row : row - J;
        const bool ok = r < R && j < (x1row ? nu : nv);
        E[(x1row ? 0 : kJmax * RP) + j * RP + r] =
            ok ? __bfloat162float(x1row ? x1[(u0 + j) * R + r] : x2[(v0 + j) * R + r]) : 0.f;
      }
    }
    for (int tb = 0; tb < T; tb += kTC) {
      __syncthreads();  // the region's last readers (the chunk, or dpre) are done
      stage<JP, kVec>(Gc, Xc, g, x3s, n, S, T, V, tb, u0, nu, v0, nv, s, c0, C);
      __syncthreads();
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int ks = 0; ks < kTC / 16; ++ks) {
        const int c = 2 * warp + ch;
        const __nv_bfloat16* ga =
            reinterpret_cast<const __nv_bfloat16*>(Gc) + c * JP * kLdT + ks * 16;
        const __nv_bfloat16* xa =
            reinterpret_cast<const __nv_bfloat16*>(Xc) + c * JP * kLdT + ks * 16;
        uint32_t af[JM][4];
#pragma unroll
        for (int mt = 0; mt < JM; ++mt) {
          // (u 0-7, t 0-7), (u 8-15, t 0-7), (u 0-7, t 8-15), (u 8-15, t 8-15)
          mma_bf16::ldmatrix4<false>(af[mt], ga + (mt * 16 + (lane & 15)) * kLdT + (lane >> 4) * 8);
        }
#pragma unroll
        for (int np = 0; np < JM; ++np) {
          // (v 0-7, t 0-7), (v 0-7, t 8-15), (v 8-15, t 0-7), (v 8-15, t 8-15):
          // the B fragments of two n8 tiles (the second past kNV unused)
          uint32_t b[4];
          mma_bf16::ldmatrix4<false>(
              b, xa + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdT + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < JM; ++mt) {
            mma_bf16::mma(acc[ch][mt][2 * np], af[mt], b[0], b[1]);
            if (2 * np + 1 < kNV) mma_bf16::mma(acc[ch][mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the chunks are read: D and DM take the region
    for (int i = PJ * kDMS + tid; i < PP * kDMS; i += kThreads) DM[i] = 0.f;  // pairs past J*J
    if (v0 == 0) {
      // W, first read by DD after this tile's barriers below
      for (int i = tid; i < kCT * WS; i += kThreads) {
        const int c = i / WS, r = i % WS;
        uint32_t hi, lo;
        split((r < R && c0 + c < C) ? w4s[((size_t)s * R + r) * C + c0 + c] : 0.f, hi, lo);
        W[i] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
      }
    }
    if constexpr (kPreD) {
      // D from the first launch (one joint tile: p = u V + v), on its way
      // while dm is written and summed
      const float* src = Dg + ((size_t)n * S + s) * PJ * RP;
      for (int q = tid; q < PP * (RP / 4); q += kThreads) {
        const int p = q / (RP / 4), r4 = 4 * (q % (RP / 4));
        mma_tf32x3::copy16(D + p * DS + r4, p < PJ ? src + p * RP + r4 : src, p < PJ);
      }
      mma_tf32x3::commit();
    }
    // ---- 2. DM, E, then D, dA's channel sums and sum(dm) ----
    // acc[ch][mt][nt][i]: u = 16 mt + gq + 8 (i / 2), v = 8 nt + 2 t4 + i % 2;
    // zero past nu and nv (their rows were staged as zeros)
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int mt = 0; mt < JM; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNV; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int u = 16 * mt + gq + 8 * (i / 2), v = 8 * nt + 2 * t4 + i % 2;
            if (u < J && v < J) DM[(u * J + v) * kDMS + 2 * warp + ch] = acc[ch][mt][nt][i];
          }
    __syncthreads();
    if constexpr (!kPreD) {
      // D[p][r] for the pairs p = u J + v, walked without a division: thread
      // tid keeps r = tid % RP and steps kThreads / RP pairs at a time
      constexpr int kStep = kThreads / RP;
      const int r = tid % RP;
      const int du = kStep / J, dv = kStep % J;
      int p = tid / RP, u = p / J, v = p % J;
      const float* E2 = E + kJmax * RP;
      for (; p < PP; p += kStep) {
        D[p * DS + r] = p < PJ ? tanhf(E[u * RP + r] - E2[v * RP + r]) : 0.f;
        u += du;
        v += dv;
        if (v >= J) {
          v -= J;
          ++u;
        }
      }
    }
    for (int p = tid; p < PJ; p += kThreads) {
      const int iu = p / J, iv = p % J;
      if (iu < nu && iv < nv) {
        // from channel p % kCT on, so that a warp's 32 pairs spread over the banks
        float sum = 0.f;
#pragma unroll
        for (int cc = 0; cc < kCT; ++cc) sum += DM[p * kDMS + (cc + p) % kCT];
        part[pt.a + (((size_t)n * KC + kc) * S + s) * V * V + (size_t)(u0 + iu) * V + v0 + iv] =
            sum;
      }
    }
    for (int p = tid / kCT; p < PJ; p += kThreads / kCT) psum += DM[p * kDMS + tid % kCT];
    if constexpr (kPreD) mma_tf32x3::wait<0>();  // this thread's copies of D are in
    __syncthreads();
    // ---- 3. P^T += dm^T D: warp w takes the pair steps w, w + 8, ... ----
    {
      for (int ks = warp; ks < PP / 8; ks += kWarps) {
        const float* m0 = DM + (ks * 8 + t4) * kDMS;
        const float* m1 = m0 + 4 * kDMS;
        // A = dm^T: (channel gq, pair t4), (gq + 8, t4), (gq, t4 + 4), (gq + 8, t4 + 4)
        const float av[4] = {m0[gq], m0[gq + 8], m1[gq], m1[gq + 8]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(av[i], ahi[i], alo[i]);
        const float* d0 = D + (ks * 8 + t4) * DS + gq;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mma3(pacc[nt], ahi, alo, d0[8 * nt], d0[4 * DS + 8 * nt]);
        }
      }
    }
    __syncthreads();  // P has read D: dpre takes its place
    // ---- DD = dm w4^T, warp w takes the m16 pair tiles w, w + 8, ...; then
    // dpre = DD (1 - D^2) in D's place ----
    for (int mt = warp; mt < PP / 16; mt += kWarps) {
      const int m0 = mt * 16;
      float dd[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dd[nt][i] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < kCT; k0 += 8) {
        // A = dm: (pair gq, channel t4), (gq + 8, t4), (gq, t4 + 4), (gq + 8, t4 + 4)
        const float* a0 = DM + (m0 + gq) * kDMS + k0 + t4;
        const float av[4] = {a0[0], a0[8 * kDMS], a0[4], a0[8 * kDMS + 4]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(av[i], ahi[i], alo[i]);
        const float2* w0 = W + (k0 + t4) * WS + gq;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float2 b0 = w0[8 * nt], b1 = w0[4 * WS + 8 * nt];
          mma3(dd[nt], ahi, alo, __float_as_uint(b0.x), __float_as_uint(b0.y),
               __float_as_uint(b1.x), __float_as_uint(b1.y));
        }
      }
      // dd[nt][i]: pair m0 + gq + 8 (i / 2), r = 8 nt + 2 t4 + i % 2
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* dp = reinterpret_cast<float2*>(D + (m0 + gq + 8 * h) * DS + 8 * nt + 2 * t4);
          const float2 d = *dp;
          *dp = make_float2(dd[nt][2 * h] * (1.f - d.x * d.x), dd[nt][2 * h + 1] * (1.f - d.y * d.y));
        }
    }
    __syncthreads();
    // dx1: DX1[u][r] += sum_v dpre; dx2: the partial sum_u dpre
    for (int i = tid; i < 2 * J * RP; i += kThreads) {
      const int r = i % RP, row = i / RP;
      if (r >= R) continue;
      if (row < J) {
        if (row >= nu) continue;
        float sum = 0.f;
        for (int iv = 0; iv < nv; ++iv) sum += D[(row * J + iv) * DS + r];
        DX1[row * RP + r] += sum;
      } else {
        const int iv = row - J;
        if (iv >= nv) continue;
        float sum = 0.f;
        for (int iu = 0; iu < nu; ++iu) sum += D[(iu * J + iv) * DS + r];
        part[pt.x2 + ((((size_t)n * S + s) * KC + kc) * tl.nt + ut) * V * R +
             (size_t)(v0 + iv) * R + r] = sum;
      }
    }
  }
  __syncthreads();
  // ---- the block's partials of dx1, P and sum(dm) ----
  for (int i = tid; i < nu * R; i += kThreads) {
    const int iu = i / R, r = i % R;
    part[pt.x1 + (((size_t)n * S + s) * KC + kc) * V * R + (size_t)(u0 + iu) * R + r] =
        DX1[iu * RP + r];
  }
  float* Red = region;                          // [kWarps][kCT][RP]
  float* Rs = region + kWarps * kCT * RP;       // [kThreads]
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = gq + 8 * (i / 2), r = 8 * nt + 2 * t4 + i % 2;
      Red[(warp * kCT + c) * RP + r] = pacc[nt][i];
    }
  Rs[tid] = psum;
  __syncthreads();
  float* pP = part + pt.p + (((size_t)n * S + s) * tl.nt + ut) * ((size_t)R * C + C);
  for (int i = tid; i < kCT * RP; i += kThreads) {
    const int c = i / RP, r = i % RP;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += Red[(w * kCT + c) * RP + r];
    if (r < R && c0 + c < C) pP[(size_t)r * C + c0 + c] = sum;
  }
  if (tid < kCT && c0 + tid < C) {
    float sum = 0.f;
    for (int gi = 0; gi < kThreads / kCT; ++gi) sum += Rs[gi * kCT + tid];
    pP[(size_t)R * C + c0 + tid] = sum;
  }
}

// The sum of `count` terms, term m at at(m), of which this thread takes m =
// j, j + step, ...: four running sums (fixed, independent chains), combined
// in order.
template <class At>
__device__ inline float slice_sum(int j, int step, int count, At at) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int m = j;
  for (; m + 3 * step < count; m += 4 * step) {
    s0 += at(m);
    s1 += at(m + step);
    s2 += at(m + 2 * step);
    s3 += at(m + 3 * step);
  }
  for (; m < count; m += step) s0 += at(m);
  return (s0 + s1) + (s2 + s3);
}

// Sums the partials into dw4s = a * P and db4s = a * sum, dAs, dx1s and dx2s
// (times a and -a, rounded once to bf16), each output by one thread, or for
// dAs by the threads of one block (red_blocks), thread j summing a fixed
// slice of the output's terms and the slices then added in order. The dw4s/db4s blocks also sum their
// outputs' dalpha terms (w4 * P + b4 * sum) in output order, and the last of
// them to finish adds those up in block order into dalpha.
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_param_bf16_reduce(const float* __restrict__ part, const float* __restrict__ w4s,
                                  const float* __restrict__ b4s,
                                  const float* __restrict__ alpha,
                                  __nv_bfloat16* __restrict__ dx1s,
                                  __nv_bfloat16* __restrict__ dx2s, float* __restrict__ dw4s,
                                  float* __restrict__ db4s, float* __restrict__ dAs,
                                  float* __restrict__ dalpha_part,
                                  unsigned int* __restrict__ done, float* __restrict__ dalpha,
                                  int N, int S, int V, int R, int C) {
  __shared__ float red[kThreads];
  __shared__ bool last;
  const Tiling tl = tiling(V);
  const int KC = channel_tiles(C), nt = tl.nt;
  const Parts pt = parts(N, S, V, R, C);
  const RedBlocks rb = red_blocks(N, S, V, R, C);
  const size_t VR = (size_t)V * R, VV = (size_t)V * V, RC = (size_t)R * C;
  const size_t nx = (size_t)N * S * VR;
  const int b = blockIdx.x;
  const int kind = b < rb.p ? 0 : b < rb.p + rb.a ? 1 : 2;  // dw4s/db4s, dAs, dx1s/dx2s
  const int outs = kind == 1 ? kRedOutsA : kRedOuts, slices = kThreads / outs;
  const int o = threadIdx.x % outs, j = threadIdx.x / outs;
  const float a = alpha[0];
  float sum = 0.f;
  size_t i = 0;  // the output within its kind
  bool ok = false;
  if (kind == 0) {  // dw4s, db4s [s, k] over samples and u tiles
    i = (size_t)b * kRedOuts + o;
    ok = i < (size_t)S * (RC + C);
    const size_t s = i / (RC + C), k = i % (RC + C);
    if (ok) {
      sum = slice_sum(j, slices, N * nt, [&](int m) {
        return part[pt.p + (((size_t)(m / nt) * S + s) * nt + m % nt) * (RC + C) + k];
      });
    }
  } else if (kind == 1) {  // dAs[s, k] over samples and channel tiles
    i = (size_t)(b - rb.p) * kRedOutsA + o;
    ok = i < (size_t)S * VV;
    const size_t s = i / VV, k = i % VV;
    if (ok) {
      sum = slice_sum(j, slices, N * KC,
                      [&](int m) { return part[pt.a + ((size_t)m * S + s) * VV + k]; });
    }
  } else {  // dx1s[ns, k] over the channel tiles; dx2s over the channel and u tiles
    i = (size_t)(b - rb.p - rb.a) * kRedOuts + o;
    ok = i < 2 * nx;
    if (ok && i < nx) {
      const size_t ns = i / VR, k = i % VR;
      sum = slice_sum(j, slices, KC,
                      [&](int m) { return part[pt.x1 + (ns * KC + m) * VR + k]; });
    } else if (ok) {
      const size_t ns = (i - nx) / VR, k = (i - nx) % VR;
      sum = slice_sum(j, slices, KC * nt,
                      [&](int m) { return part[pt.x2 + (ns * KC * nt + m) * VR + k]; });
    }
  }
  red[j * outs + o] = sum;
  __syncthreads();
  float term = 0.f;
  if (j == 0 && ok) {
    float total = 0.f;
    for (int q = 0; q < slices; ++q) total += red[q * outs + o];
    if (kind == 0) {
      const size_t s = i / (RC + C), k = i % (RC + C);
      if (k < RC) {
        dw4s[s * RC + k] = a * total;
        term = w4s[s * RC + k] * total;
      } else {
        db4s[s * C + k - RC] = a * total;
        term = b4s[s * C + k - RC] * total;
      }
    } else if (kind == 1) {
      dAs[i] = total;
    } else if (i < nx) {
      dx1s[i] = __float2bfloat16_rn(a * total);
    } else {
      dx2s[i - nx] = __float2bfloat16_rn(-a * total);
    }
  }
  if (kind != 0) return;
  // the block's dalpha terms (a thread an output: slices == 1), by a tree
  __syncthreads();  // red is read
  red[threadIdx.x] = term;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float t = red[0];
    dalpha_part[b] = t;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(done, 1u) == (unsigned int)rb.p - 1;
  }
  __syncthreads();
  if (!last) return;
  // every dw4s/db4s block's term is written: each thread sums a fixed,
  // strided set of them (read past L1), then a tree
  float t = 0.f;
  for (int q = threadIdx.x; q < rb.p; q += kThreads) t += __ldcg(dalpha_part + q);
  red[threadIdx.x] = t;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dalpha[0] = red[0];
}

template <int RP, int JM, bool kVec, bool kPreD>
int launch(const __nv_bfloat16* x1s, const __nv_bfloat16* x2s, const __nv_bfloat16* g,
           const __nv_bfloat16* x3s, const float* w4s, float* scratch, int N, int S, int T,
           int V, int R, int C, cudaStream_t stream) {
  const Tiling tl = tiling(V);
  const Scratch sc = scratch_of(N, S, V, R, C);
  float* Dg = scratch + sc.d;
  cudaError_t err;
  if constexpr (kPreD) {
    const int total = N * S * V * V * RP;
    unit_ctr_gc_bwd_param_bf16_tanh<<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        x1s, x2s, Dg, total, V, R, RP);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = smem_bytes<RP, JM>(tl.J);
  auto kernel = unit_ctr_gc_bwd_param_bf16_kernel<RP, JM, kVec, kPreD>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  unsigned int* done = reinterpret_cast<unsigned int*>(scratch + sc.done);
  const dim3 grid(tl.nt * channel_tiles(C), S, N);
  kernel<<<grid, kThreads, smem, stream>>>(x1s, x2s, g, x3s, w4s, scratch, done, Dg, N, S, T, V,
                                           R, C);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launched;
  return err;
}

template <int RP, int JM>
int launch_vec(const __nv_bfloat16* x1s, const __nv_bfloat16* x2s, const __nv_bfloat16* g,
               const __nv_bfloat16* x3s, const float* w4s, float* scratch, int N, int S, int T,
               int V, int R, int C, cudaStream_t stream) {
  // 16-byte loads: 8 channels of a row, rows of whole 16-byte units
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x3s) % 16 == 0;
  if constexpr (RP > 8) {
    if (pre_d(V, R)) {
      return vec ? launch<RP, JM, true, true>(x1s, x2s, g, x3s, w4s, scratch, N, S, T, V, R, C,
                                              stream)
                 : launch<RP, JM, false, true>(x1s, x2s, g, x3s, w4s, scratch, N, S, T, V, R, C,
                                               stream);
    }
  }
  return vec ? launch<RP, JM, true, false>(x1s, x2s, g, x3s, w4s, scratch, N, S, T, V, R, C,
                                           stream)
             : launch<RP, JM, false, false>(x1s, x2s, g, x3s, w4s, scratch, N, S, T, V, R, C,
                                            stream);
}

template <int RP>
int launch_rp(const __nv_bfloat16* x1s, const __nv_bfloat16* x2s, const __nv_bfloat16* g,
              const __nv_bfloat16* x3s, const float* w4s, float* scratch, int N, int S, int T,
              int V, int R, int C, cudaStream_t stream) {
  return tiling(V).J <= 16
             ? launch_vec<RP, 1>(x1s, x2s, g, x3s, w4s, scratch, N, S, T, V, R, C, stream)
             : launch_vec<RP, 2>(x1s, x2s, g, x3s, w4s, scratch, N, S, T, V, R, C, stream);
}

}  // namespace

// Floats of device scratch that unit_ctr_gc_bwd_param_bf16 needs.
extern "C" long long unit_ctr_gc_bwd_param_bf16_scratch_floats(int N, int S, int V, int R,
                                                               int C) {
  return scratch_of(N, S, V, R, C).end;
}

// Launches of unit_ctr_gc_bwd_param_bf16's main kernel so far, counted where
// it launches.
extern "C" long long unit_ctr_gc_bwd_param_bf16_launched() { return g_launched; }

// As unit_ctr_gc_bwd_param_f32 (unit_ctr_gc_bwd_param.cu) with x1s, x2s, g,
// x3s, dx1s and dx2s bf16; the parameters, dw4s, db4s, dalpha, dAs and the
// scratch f32 (unit_ctr_gc_bwd_param_bf16_scratch_floats floats); R <= 32,
// any V and C. Launches on `stream` and returns the first non-zero
// cudaGetLastError() (0 = ok).
extern "C" int unit_ctr_gc_bwd_param_bf16(
    const __nv_bfloat16* x1s, const __nv_bfloat16* x2s, const __nv_bfloat16* g,
    const __nv_bfloat16* x3s, const float* w4s, const float* b4s, const float* alpha,
    __nv_bfloat16* dx1s, __nv_bfloat16* dx2s, float* dw4s, float* db4s, float* dalpha,
    float* dAs, float* scratch, int N, int S, int T, int V, int R, int C, void* stream) {
  if (N < 1 || N > 65535 || S < 1 || S > 65535 || T < 1 || V < 1 || R < 1 || C < 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (R <= 8) {
    err = launch_rp<8>(x1s, x2s, g, x3s, w4s, scratch, N, S, T, V, R, C, st);
  } else if (R <= 16) {
    err = launch_rp<16>(x1s, x2s, g, x3s, w4s, scratch, N, S, T, V, R, C, st);
  } else if (R <= 32) {
    err = launch_rp<32>(x1s, x2s, g, x3s, w4s, scratch, N, S, T, V, R, C, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const Scratch sc = scratch_of(N, S, V, R, C);
  unit_ctr_gc_bwd_param_bf16_reduce<<<reduce_blocks(N, S, V, R, C), kThreads, 0, st>>>(
      scratch, w4s, b4s, alpha, dx1s, dx2s, dw4s, db4s, dAs, scratch + sc.terms,
      reinterpret_cast<unsigned int*>(scratch + sc.done), dalpha, N, S, V, R, C);
  return cudaGetLastError();
}
