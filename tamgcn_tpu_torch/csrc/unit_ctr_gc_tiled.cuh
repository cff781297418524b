// The joint-tiled design of the unit CTR-GC forward (K1) and x3 gradient
// (K2), for V where M of a channel tile for all V x V joint pairs does not
// fit a block's shared memory (V = 256 needs 4 MB at 16 channels).
//
// A block owns one sample n, one tile of kJ "own" joints (u for K1, v for
// K2), one tile of kCT channels and, for K2, one subset s. It walks the tiles
// of the summed joint (v for K1, u for K2) and, for K1, the subsets; at each
// step it builds the M tile of (s, u tile, v tile, channel tile) in shared
// memory (tile_m) and stages the matching chunk of kTF frames of x3s (K1)
// or g (K2), then accumulates its outputs in registers (accumulate). It
// writes each output once and uses no atomics. Where T > kTF it walks the
// frames in chunks and builds the M tiles again for each chunk.
//
// M is computed with the arithmetic of unit_ctr_gc_common.cuh:build_m (the
// same tanh, the same operand rounding in bf16 and the same FMA order over
// r), so an M value is bitwise the one the whole-V design builds; only the
// order of the sum over the summed joint differs. The activations are float
// or __nv_bfloat16 (Act<TA>); shared memory holds f32 in both.
#pragma once

#include "unit_ctr_gc_common.cuh"

namespace unit_ctr_gc {
namespace tiled {

constexpr int kJ = 16;    // joints per tile, each side
constexpr int kCT = 16;   // channels per tile
constexpr int kTF = 32;   // frames per chunk
constexpr int kOwn = 8;   // own joints per thread
constexpr int kFr = 4;    // frames per thread
constexpr int kXS = kJ * kCT + 4;  // frame stride of the staged chunk: the
                                   // two channel groups of a warp read frames
                                   // 4 apart, 16 banks apart
static_assert(kThreads == kCT * (kJ / kOwn) * (kTF / kFr), "one item a thread");

// shared memory, in floats: X [kTF][kXS], M [kJ][kJ][kCT], D [kJ*kJ][RP+1],
// W [RP][kCT], E [2][kJ][RP]
__host__ __device__ inline int smem_floats(int RP) {
  return kTF * kXS + kJ * kJ * kCT + round4(kJ * kJ * (RP + 1)) + RP * kCT +
         2 * kJ * RP;
}

// Stages kTF frames from tb of rows j0 .. j0+kJ of src (row (n, t, j) at
// src + ((n*T + t)*V + j)*ld, channels coff .. coff+kCT) into
// X [t][j][c], zero where t >= T, j >= V or the channel >= C (cend - coff
// channels exist). Channels in fours: ld, coff and C are multiples of 4.
template <typename TA>
__device__ inline void stage_chunk(const TA* __restrict__ src, float* X,
                                   int n, int tb, int j0, int T, int V,
                                   size_t ld, int coff, int nch) {
  constexpr int kQ = kCT / 4;
  constexpr int kItems = kTF * kJ * kQ;
  const int tid = threadIdx.x;
  for (int base = tid; base < kItems; base += kThreads * kBatch) {
    float4 val[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads;
      const int q = i % kQ, j = (i / kQ) % kJ, t = i / (kQ * kJ);
      val[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < kItems && tb + t < T && j0 + j < V && 4 * q < nch) {
        val[k] = Act<TA>::load4(
            src + (((size_t)n * T + tb + t) * V + j0 + j) * ld + coff + 4 * q);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads;
      const int q = i % kQ, j = (i / kQ) % kJ, t = i / (kQ * kJ);
      if (i < kItems) {
        *reinterpret_cast<float4*>(X + t * kXS + j * kCT + 4 * q) = val[k];
      }
    }
  }
}

// The M tile of subset s, joints u0 .. u0+kJ and v0 .. v0+kJ, channels
// c0 .. c0+kCT: M_s[u,v,c] at M + (iu*su + iv*sv)*kCT + c (iu = u - u0,
// iv = v - v0), zero where u >= V or v >= V. Run by all threads; the caller
// synchronises before (the previous reads of D, E, W and M are done) and
// after (before it reads M). D and W hold stage 1's operands
// (Act<TA>::operand).
template <int RP, typename TA>
__device__ inline void tile_m(const TA* __restrict__ x1s,
                              const TA* __restrict__ x2s,
                              const float* __restrict__ w4s,
                              const float* __restrict__ b4s, float a,
                              const float* __restrict__ As, float* D, float* W,
                              float* E, float* M, int n, int s, int S, int u0,
                              int v0, int V, int R, int C, int c0, int su,
                              int sv) {
  const int tid = threadIdx.x;
  constexpr int kPairs = kJ * kJ;
  // E: the x1 rows of the u tile, then the x2 rows of the v tile, zero-padded
  // to RP; W: w4s[s] of the channel tile
  {
    const TA* x1 = x1s + ((size_t)n * S + s) * V * R;
    const TA* x2 = x2s + ((size_t)n * S + s) * V * R;
    for (int i = tid; i < 2 * kJ * RP; i += kThreads) {
      const int r = i % RP, row = i / RP;  // row < kJ: x1 of u0 + row
      const int j = row < kJ ? u0 + row : v0 + row - kJ;
      E[i] = (r < R && j < V) ? Act<TA>::load((row < kJ ? x1 : x2) + j * R + r) : 0.f;
    }
    for (int i = tid; i < RP * kCT; i += kThreads) {
      const int r = i / kCT, c = c0 + i % kCT;
      W[i] = (r < R && c < C) ? Act<TA>::operand(w4s[((size_t)s * R + r) * C + c]) : 0.f;
    }
  }
  __syncthreads();
  // D [pair][RP+1] = tanh(x1_u - x2_v), as build_d computes it
  for (int base = tid; base < kPairs * RP; base += kThreads * kBatch) {
    float val[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = min(base + k * kThreads, kPairs * RP - 1);
      const int r = i % RP, p = i / RP;
      val[k] = Act<TA>::operand(tanhf(E[(p / kJ) * RP + r] - E[(kJ + p % kJ) * RP + r]));
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads;
      if (i < kPairs * RP) D[(i / RP) * (RP + 1) + i % RP] = val[k];
    }
  }
  __syncthreads();
  // M = (D @ W + b) * a + A: each thread 4 channels of 4 pairs, per r one
  // 16-byte load of W (shared by the warp's lanes) and 4 values of D (rows
  // padded to RP+1, so the 8 pairs a warp reads sit in different banks)
  constexpr int kQ = kCT / 4;
  constexpr int kLanes = kThreads / kQ;
  constexpr int kPer = kPairs / kLanes;
  const int q = tid % kQ, lane = tid / kQ;
  const int c4 = c0 + 4 * q;
  const bool ok4 = c4 < C;  // C % 4 == 0: all 4 channels or none
  float4 acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int r = 0; r < RP; ++r) {
    const float4 w = *reinterpret_cast<const float4*>(W + r * kCT + 4 * q);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      acc[k] = fma4(D[(lane + k * kLanes) * (RP + 1) + r], w, acc[k]);
    }
  }
  const float4 b = ok4 ? *reinterpret_cast<const float4*>(b4s + (size_t)s * C + c4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* A = As + (size_t)s * V * V;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = lane + k * kLanes;
    const int iu = p / kJ, iv = p % kJ;
    const int u = u0 + iu, v = v0 + iv;
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < V && v < V) {
      const float Auv = A[u * V + v];
      m = make_float4(fmaf(acc[k].x + b.x, a, Auv), fmaf(acc[k].y + b.y, a, Auv),
                      fmaf(acc[k].z + b.z, a, Auv), fmaf(acc[k].w + b.w, a, Auv));
    }
    *reinterpret_cast<float4*>(M + (iu * su + iv * sv) * kCT + 4 * q) = m;
  }
}

// This thread's item of a step: channel tid % kCT, own joints own0 .. own0 +
// kOwn and frames f0 .. f0 + kFr of the chunk.
struct Item {
  int c, own0, f0;
  __device__ Item()
      : c(threadIdx.x % kCT),
        own0(((threadIdx.x / kCT) / (kTF / kFr)) * kOwn),
        f0(((threadIdx.x / kCT) % (kTF / kFr)) * kFr) {}
};

// acc[j][i] += sum_k M[(own0 + i)*kJ + k][c] * X[f0 + j][k][c]: M stored
// [own][summed][c], X [t][summed][c].
__device__ inline void accumulate(const float* M, const float* X, Item it,
                                  float (&acc)[kFr][kOwn]) {
#pragma unroll 4
  for (int k = 0; k < kJ; ++k) {
    float m[kOwn], x[kFr];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) m[i] = M[((it.own0 + i) * kJ + k) * kCT + it.c];
#pragma unroll
    for (int j = 0; j < kFr; ++j) x[j] = X[(it.f0 + j) * kXS + k * kCT + it.c];
#pragma unroll
    for (int j = 0; j < kFr; ++j) {
#pragma unroll
      for (int i = 0; i < kOwn; ++i) acc[j][i] = fmaf(x[j], m[i], acc[j][i]);
    }
  }
}

// Writes acc to dst + ((n*T + t)*V + own)*ld + coff + c for the frames
// t = tb + f0 + j < T, own joints own0_tile + own0 + i < V and channels
// c0 + c < C (coff includes c0), each rounded once to TA.
template <typename TA>
__device__ inline void write_out(TA* __restrict__ dst, const float (&acc)[kFr][kOwn],
                                 Item it, int n, int tb, int own_tile0, int T,
                                 int V, size_t ld, int coff, bool c_ok) {
  if (!c_ok) return;
#pragma unroll
  for (int j = 0; j < kFr; ++j) {
    const int t = tb + it.f0 + j;
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int own = own_tile0 + it.own0 + i;
      if (t < T && own < V) {
        Act<TA>::store(dst + (((size_t)n * T + t) * V + own) * ld + coff + it.c, acc[j][i]);
      }
    }
  }
}

}  // namespace tiled
}  // namespace unit_ctr_gc
