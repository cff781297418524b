// The unit CTR-GC forward (K1's work), shared by K1 (unit_ctr_gc_fwd.cu) and
// the aggregation phase of K5 (gcn_tcn_block.cu): the whole-V design's body
// and the choice between it and the joint-tiled design
// (unit_ctr_gc_tiled.cuh), with its grid, shared memory and tensor map, as
// unit_ctr_gc_dx3.cuh does for the x3 gradient. Each source defines its own
// kernels (so that a profile names them apart) and launches them through a
// class L with two static member templates:
//   L::whole<RP, TA>(grid, smem, stream, x1s, x2s, x3s, w4s, b4s, alpha, As,
//                    out, S, T, V, R, C, CT, VP)
//   L::tiled<RP, TF, TA>(grid, smem, stream, x1s, x2s, x3s, w4s, b4s, alpha,
//                        As, out, xmap, S, T, V, R, C)
// each of which sets the kernel's shared memory, launches it and returns
// cudaGetLastError(). What the designs do and what bounds them:
// unit_ctr_gc_fwd.cu's header.
#pragma once

#include <cuda_runtime.h>

#include "unit_ctr_gc_common.cuh"
#include "unit_ctr_gc_tiled.cuh"

namespace unit_ctr_gc {
namespace fwd {

constexpr int kUU = 5;  // joints u per thread in stage 2
constexpr int kTT = 2;  // frames t per thread in stage 2

// shared memory, in floats: D/X region, then M, then E
__host__ __device__ inline int region0(int V, int S, int CT, int RP) {
  return round4(imax(V * V * (RP + 1), kTC * V * S * CT));
}

// The whole-V design, run by a block of kThreads threads: sample n =
// blockIdx.y, channels blockIdx.x * CT .. + CT.
template <int RP, typename TA>
__device__ inline void whole_v(const TA* __restrict__ x1s, const TA* __restrict__ x2s,
                               const TA* __restrict__ x3s, const float* __restrict__ w4s,
                               const float* __restrict__ b4s, const float* __restrict__ alpha,
                               const float* __restrict__ As, TA* __restrict__ out, int S,
                               int T, int V, int R, int C, int CT, int VP) {
  extern __shared__ float4 smem4[];
  // D [V*V][RP+1]: tanh(x1_u - x2_v) of one subset, in stage 1; stage 2
  // reuses its space for the x3s chunk X [kTC][V][S][CT].
  // M [S][VP][V][CT]: the refined adjacency of the channel tile.
  // E [2][V][RP]: the x1/x2 rows of one subset, zero-padded to RP.
  float* D = reinterpret_cast<float*>(smem4);
  float* X = D;
  float* M = D + region0(V, S, CT, RP);
  float* E = M + S * VP * V * CT;

  const int n = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  const int tid = threadIdx.x;
  const float a = alpha[0];

  // ---- stage 1: M_s[u,v,c] for the channel tile, all subsets ----
  build_m<RP, TA>(x1s, x2s, w4s, b4s, a, As, D, E, M, VP * V, V, n, c0, S, V,
                  R, C, CT);
  // zero the padded joint rows u in [V, VP): stage 2 reads them
  for (int i = tid; i < S * (VP - V) * V * CT; i += kThreads) {
    const int rest = i / (V * CT);  // (s, u - V)
    M[((rest / (VP - V)) * VP + V + rest % (VP - V)) * V * CT + i % (V * CT)] = 0.f;
  }

  // ---- stage 2: out[n,t,u,c] = sum_{s,v} M_s[u,v,c] * x3s[n,t,v,s*C+c] ----
  const int c = tid % CT;  // this thread's channel
  const int g = tid / CT;
  const int G = kThreads / CT;
  const int cg = c0 + c;
  const int nug = VP / kUU;
  const int nitems = nug * (kTC / kTT);
  const size_t SC = (size_t)S * C;
  const int CT4 = CT / 4;
  const int xsize4 = kTC * V * S * CT4;  // 16-byte groups of channels
  for (int tb = 0; tb < T; tb += kTC) {
    __syncthreads();  // M is complete, and the previous chunk is consumed
    for (int base = tid; base < xsize4; base += kThreads * kBatch) {
      float4 val[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kThreads;
        int rest = i / CT4;
        const int s = rest % S;
        rest /= S;
        const int v = rest % V;
        const int t = tb + rest / V;
        const int cx = c0 + 4 * (i % CT4);
        val[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < xsize4 && t < T && cx < C) {
          val[k] = Act<TA>::load4(
              x3s + (((size_t)n * T + t) * V + v) * SC + (size_t)s * C + cx);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kThreads;
        if (i < xsize4) reinterpret_cast<float4*>(X)[i] = val[k];
      }
    }
    __syncthreads();
    for (int item = g; item < nitems; item += G) {
      const int u0 = (item % nug) * kUU;
      const int j0 = (item / nug) * kTT;  // frame within the chunk
      float acc[kTT][kUU];
#pragma unroll
      for (int j = 0; j < kTT; ++j) {
#pragma unroll
        for (int i = 0; i < kUU; ++i) acc[j][i] = 0.f;
      }
      for (int s = 0; s < S; ++s) {
#pragma unroll 4
        for (int v = 0; v < V; ++v) {
          const float* mrow = M + ((s * VP + u0) * V + v) * CT + c;
          const float* xrow = X + ((j0 * V + v) * S + s) * CT + c;
          float m[kUU];
#pragma unroll
          for (int i = 0; i < kUU; ++i) m[i] = mrow[i * V * CT];
          float x[kTT];
#pragma unroll
          for (int j = 0; j < kTT; ++j) x[j] = xrow[j * V * S * CT];
#pragma unroll
          for (int j = 0; j < kTT; ++j) {
#pragma unroll
            for (int i = 0; i < kUU; ++i) acc[j][i] = fmaf(x[j], m[i], acc[j][i]);
          }
        }
      }
      if (cg < C) {
#pragma unroll
        for (int j = 0; j < kTT; ++j) {
          const int t = tb + j0 + j;
#pragma unroll
          for (int i = 0; i < kUU; ++i) {
            const int u = u0 + i;
            if (t < T && u < V) {
              Act<TA>::store(out + (((size_t)n * T + t) * V + u) * C + cg, acc[j][i]);
            }
          }
        }
      }
    }
  }
}

// The whole-V design's channel tile at (S, V, RP): 16, else 8 where 16 does
// not fit its shared memory, else 0, and then the tiled design runs.
inline int whole_v_ct(int S, int V, int RP) {
  const int VP = (V + kUU - 1) / kUU * kUU;
  for (int ct = 16; ct >= 8; ct /= 2) {
    const size_t bytes = sizeof(float) * ((size_t)region0(V, S, ct, RP) +
                                          (size_t)S * VP * V * ct + 2 * V * RP);
    if (bytes <= kSmemLimit) return ct;
  }
  return 0;
}

inline int rp_of(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : 32; }

template <class L, int RP, int TF, typename TA>
int launch_tiled(const TA* x1s, const TA* x2s, const TA* x3s, const float* w4s,
                 const float* b4s, const float* alpha, const float* As, TA* out,
                 int N, int S, int T, int V, int R, int C, cudaStream_t stream) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, sizeof(TA));
  constexpr int smem = smem_bytes(TF, CT, RP, sizeof(TA));
  static_assert(smem <= kSmemLimit, "the tiled design's shared memory");
  // the f32 chunks arrive by tensor copies; the bf16 form does not read the map
  CUtensorMap xmap = {};
  if constexpr (sizeof(TA) == 4) {
    const cudaError_t err =
        chunk_map(&xmap, reinterpret_cast<const float*>(x3s), N, T, V, S * C, TF);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + CT - 1) / CT, (V + kJ - 1) / kJ, N);
  return L::template tiled<RP, TF, TA>(grid, smem, stream, x1s, x2s, x3s, w4s, b4s, alpha, As,
                                       out, xmap, S, T, V, R, C);
}

template <class L, int RP, typename TA>
int launch(const TA* x1s, const TA* x2s, const TA* x3s, const float* w4s,
           const float* b4s, const float* alpha, const float* As, TA* out,
           int N, int S, int T, int V, int R, int C, cudaStream_t stream) {
  const int CT = whole_v_ct(S, V, RP);
  if (CT == 0) {
    const int TF = tiled::frame_tile(T);
    if (TF == 8) return launch_tiled<L, RP, 8>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
    if (TF == 16) return launch_tiled<L, RP, 16>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
    return launch_tiled<L, RP, 32>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
  }
  const int VP = (V + kUU - 1) / kUU * kUU;
  const size_t smem = sizeof(float) *
      ((size_t)region0(V, S, CT, RP) + (size_t)S * VP * V * CT + 2 * V * RP);
  const dim3 grid((C + CT - 1) / CT, N);
  return L::template whole<RP, TA>(grid, smem, stream, x1s, x2s, x3s, w4s, b4s, alpha, As, out,
                                   S, T, V, R, C, CT, VP);
}

// Whether run() takes the shape: R <= 32, C % 4 == 0, any V.
inline bool dims_ok(int N, int S, int T, int V, int R, int C) {
  return N >= 1 && N <= 65535 && S >= 1 && T >= 1 && V >= 1 && R >= 1 && R <= 32 && C >= 4 &&
         C % 4 == 0;
}

// out (N,T,V,C) of the unit op through L's kernels, in the design that
// unit_ctr_gc_fwd_variant names. Returns cudaGetLastError() (0 = ok).
template <class L, typename TA>
int run(const TA* x1s, const TA* x2s, const TA* x3s, const float* w4s, const float* b4s,
        const float* alpha, const float* As, TA* out, int N, int S, int T, int V, int R, int C,
        cudaStream_t st) {
  if (!dims_ok(N, S, T, V, R, C)) return cudaErrorInvalidValue;
  if (R <= 8) return launch<L, 8>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, st);
  if (R <= 16) return launch<L, 16>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, st);
  return launch<L, 32>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, st);
}

}  // namespace fwd
}  // namespace unit_ctr_gc
