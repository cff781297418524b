// The x3 gradient of the unit CTR-GC op (K2's work), shared by K2
// (unit_ctr_gc_bwd_dx3.cu) and the first phase of K6
// (unit_ctr_gc_bwd_conv3.cu): the whole-V design's body and the choice
// between it and the joint-tiled design (unit_ctr_gc_tiled.cuh), with its
// grid, shared memory and tensor map. Each source defines its own kernels
// (so that a profile names them apart) and launches them through a class L
// with two static member templates:
//   L::whole<RP, TA>(grid, smem, stream, x1s, x2s, g, w4s, b4s, alpha, As,
//                    dx3s, S, T, V, R, C, CT, VP)
//   L::tiled<RP, TF, TA>(grid, smem, stream, x1s, x2s, g, w4s, b4s, alpha,
//                        As, dx3s, xmap, S, T, V, R, C)
// each of which sets the kernel's shared memory, launches it and returns
// cudaGetLastError(). What the designs do and what bounds them:
// unit_ctr_gc_bwd_dx3.cu's header.
#pragma once

#include <cuda_runtime.h>

#include "unit_ctr_gc_common.cuh"
#include "unit_ctr_gc_tiled.cuh"

namespace unit_ctr_gc {
namespace dx3 {

constexpr int kVV = 5;  // joints v per thread in stage 2
constexpr int kTT = 2;  // frames t per thread in stage 2

// shared memory, in floats: D/G region, then M, then E
__host__ __device__ inline int region0(int V, int CT, int RP) {
  return round4(imax(V * V * (RP + 1), kTC * V * CT));
}

// The whole-V design, run by a block of kThreads threads: sample n =
// blockIdx.y, channels blockIdx.x * CT .. + CT.
template <int RP, typename TA>
__device__ inline void whole_v(const TA* __restrict__ x1s, const TA* __restrict__ x2s,
                               const TA* __restrict__ g, const float* __restrict__ w4s,
                               const float* __restrict__ b4s, const float* __restrict__ alpha,
                               const float* __restrict__ As, TA* __restrict__ dx3s, int S,
                               int T, int V, int R, int C, int CT, int VP) {
  extern __shared__ float4 smem4[];
  // D [V*V][RP+1]: tanh(x1_u - x2_v) of one subset, in stage 1; stage 2
  // reuses its space for the g chunk Gs [kTC][V][CT].
  // M [S][V][VP][CT]: the refined adjacency of the channel tile, v padded.
  // E [2][V][RP]: the x1/x2 rows of one subset, zero-padded to RP.
  float* D = reinterpret_cast<float*>(smem4);
  float* Gs = D;
  float* M = D + region0(V, CT, RP);
  float* E = M + S * V * VP * CT;

  const int n = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  const int tid = threadIdx.x;
  const float a = alpha[0];

  // ---- stage 1: M_s[u,v,c] for the channel tile, all subsets ----
  build_m<RP, TA>(x1s, x2s, w4s, b4s, a, As, D, E, M, V * VP, VP, n, c0, S, V,
                  R, C, CT);
  // zero the padded joint columns v in [V, VP): stage 2 reads them
  const int pad = (VP - V) * CT;
  for (int i = tid; i < S * V * pad; i += kThreads) {
    M[((i / pad) * VP + V) * CT + i % pad] = 0.f;
  }

  // ---- stage 2: dx3s[n,t,v,s*C+c] = sum_u M_s[u,v,c] * g[n,t,u,c] ----
  const int c = tid % CT;  // this thread's channel
  const int grp = tid / CT;
  const int G = kThreads / CT;
  const int cg = c0 + c;
  const int nvg = VP / kVV;
  const int nitems = S * nvg * (kTC / kTT);
  const size_t SC = (size_t)S * C;
  const int CT4 = CT / 4;
  const int gsize4 = kTC * V * CT4;  // 16-byte groups of channels
  for (int tb = 0; tb < T; tb += kTC) {
    __syncthreads();  // M is complete, and the previous chunk is consumed
    for (int base = tid; base < gsize4; base += kThreads * kBatch) {
      float4 val[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kThreads;
        const int rest = i / CT4;
        const int u = rest % V;
        const int t = tb + rest / V;
        const int cx = c0 + 4 * (i % CT4);
        val[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < gsize4 && t < T && cx < C) {
          val[k] = Act<TA>::load4(g + (((size_t)n * T + t) * V + u) * C + cx);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kThreads;
        if (i < gsize4) reinterpret_cast<float4*>(Gs)[i] = val[k];
      }
    }
    __syncthreads();
    for (int item = grp; item < nitems; item += G) {
      const int v0 = (item % nvg) * kVV;
      const int rest = item / nvg;
      const int s = rest % S;
      const int j0 = (rest / S) * kTT;  // frame within the chunk
      float acc[kTT][kVV];
#pragma unroll
      for (int j = 0; j < kTT; ++j) {
#pragma unroll
        for (int i = 0; i < kVV; ++i) acc[j][i] = 0.f;
      }
#pragma unroll 4
      for (int u = 0; u < V; ++u) {
        const float* mrow = M + ((s * V + u) * VP + v0) * CT + c;
        const float* grow = Gs + (j0 * V + u) * CT + c;
        float m[kVV];
#pragma unroll
        for (int i = 0; i < kVV; ++i) m[i] = mrow[i * CT];
        float x[kTT];
#pragma unroll
        for (int j = 0; j < kTT; ++j) x[j] = grow[j * V * CT];
#pragma unroll
        for (int j = 0; j < kTT; ++j) {
#pragma unroll
          for (int i = 0; i < kVV; ++i) acc[j][i] = fmaf(x[j], m[i], acc[j][i]);
        }
      }
      if (cg < C) {
#pragma unroll
        for (int j = 0; j < kTT; ++j) {
          const int t = tb + j0 + j;
#pragma unroll
          for (int i = 0; i < kVV; ++i) {
            const int v = v0 + i;
            if (t < T && v < V) {
              Act<TA>::store(dx3s + (((size_t)n * T + t) * V + v) * SC + (size_t)s * C + cg,
                             acc[j][i]);
            }
          }
        }
      }
    }
  }
}

// The whole-V design's channel tile at (S, V, RP): 16 (or max_ct = 8), else
// 8 where 16 does not fit its shared memory, else 0, and then the tiled
// design runs.
inline int whole_v_ct(int S, int V, int RP, int max_ct = 16) {
  const int VP = (V + kVV - 1) / kVV * kVV;
  for (int ct = max_ct; ct >= 8; ct /= 2) {
    const size_t bytes = sizeof(float) * ((size_t)region0(V, ct, RP) +
                                          (size_t)S * V * VP * ct + 2 * V * RP);
    if (bytes <= kSmemLimit) return ct;
  }
  return 0;
}

inline int rp_of(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : 32; }

template <class L, int RP, int TF, typename TA>
int launch_tiled(const TA* x1s, const TA* x2s, const TA* g, const float* w4s,
                 const float* b4s, const float* alpha, const float* As, TA* dx3s,
                 int N, int S, int T, int V, int R, int C, cudaStream_t stream) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, sizeof(TA));
  constexpr int smem = smem_bytes(TF, CT, RP, sizeof(TA));
  static_assert(smem <= kSmemLimit, "the tiled design's shared memory");
  // the f32 chunks arrive by tensor copies; the bf16 form does not read the map
  CUtensorMap xmap = {};
  if constexpr (sizeof(TA) == 4) {
    const cudaError_t err = chunk_map(&xmap, reinterpret_cast<const float*>(g), N, T, V, C, TF);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + CT - 1) / CT, ((V + kJ - 1) / kJ) * S, N);
  return L::template tiled<RP, TF, TA>(grid, smem, stream, x1s, x2s, g, w4s, b4s, alpha, As,
                                       dx3s, xmap, S, T, V, R, C);
}

template <class L, int RP, typename TA>
int launch(const TA* x1s, const TA* x2s, const TA* g, const float* w4s,
           const float* b4s, const float* alpha, const float* As, TA* dx3s,
           int N, int S, int T, int V, int R, int C, cudaStream_t stream, int max_ct) {
  const int CT = whole_v_ct(S, V, RP, max_ct);
  if (CT == 0) {
    const int TF = tiled::frame_tile(T);
    if (TF == 8) return launch_tiled<L, RP, 8>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
    if (TF == 16) return launch_tiled<L, RP, 16>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
    return launch_tiled<L, RP, 32>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
  }
  const int VP = (V + kVV - 1) / kVV * kVV;
  const size_t smem = sizeof(float) *
      ((size_t)region0(V, CT, RP) + (size_t)S * V * VP * CT + 2 * V * RP);
  const dim3 grid((C + CT - 1) / CT, N);
  return L::template whole<RP, TA>(grid, smem, stream, x1s, x2s, g, w4s, b4s, alpha, As, dx3s,
                                   S, T, V, R, C, CT, VP);
}

// Whether dims() takes the shape: R <= 32, C % 4 == 0, any V.
inline bool dims_ok(int N, int S, int T, int V, int R, int C) {
  return N >= 1 && N <= 65535 && S >= 1 && T >= 1 && V >= 1 && R >= 1 && R <= 32 && C >= 4 &&
         C % 4 == 0;
}

// dx3s (N,T,V,S*C) of the unit op through L's kernels, in the design that
// unit_ctr_gc_bwd_dx3_variant names (the whole-V one with channel tiles of
// at most max_ct). Returns cudaGetLastError() (0 = ok).
template <class L, typename TA>
int run(const TA* x1s, const TA* x2s, const TA* g, const float* w4s, const float* b4s,
        const float* alpha, const float* As, TA* dx3s, int N, int S, int T, int V, int R,
        int C, cudaStream_t st, int max_ct = 16) {
  if (!dims_ok(N, S, T, V, R, C)) return cudaErrorInvalidValue;
  if (R <= 8) return launch<L, 8>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, st, max_ct);
  if (R <= 16) return launch<L, 16>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, st, max_ct);
  return launch<L, 32>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, st, max_ct);
}

}  // namespace dx3
}  // namespace unit_ctr_gc
