// Unit CTR-GC backward, the x3 gradient (K2), for Hopper (sm_90a), f32 and
// bf16.
//
// Replaces tamgcn_tpu/ops/pallas/ctr_gc.py:_unit_bwd_dx3_kernel_tile (stages
// in _dx3_tile_stages) and its schedule variants _unit_bwd_dx3_kernel_bcast
// and _unit_bwd_dx3_kernel (all launched by unit_ctr_gc_bwd_pallas), which
// compute the same function:
//
//   dx3s[n,t,v,s*C+c] = sum_u M_s[n,u,v,c] * g[n,t,u,c]
//   M_s[n,u,v,c] = (sum_r tanh(x1s[n,s,u,r] - x2s[n,s,v,r]) * w4s[s,r,c]
//                   + b4s[s,c]) * alpha + As[s,u,v]
//
// with the refined adjacency M rebuilt on the chip and never written to
// device memory. It is the forward kernel (unit_ctr_gc_fwd.cu) with the roles
// swapped: it reads g (C wide), writes dx3s (S*C wide) and sums over the
// FIRST joint index of M.
//
// What bounds it on this card. At the deep NW-UCLA shape (N=16, T=13, V=20,
// C=256, R=32) the function moves ~17 MB (g in, dx3s out: ~5 us at
// 3.35 TB/s) and does 2*N*S*(V*V*R*C + T*V*V*C) ~ 0.44 GFLOP of f32 FMAs
// (~7 us at 67 TFLOP/s): the operations bound it there, the bytes at the
// wide-T shapes (T=52, C=64). As in the forward, M for one (n, s) is
// V*V*C*4 B (410 KB at C=256), larger than a block's 227 KB of shared
// memory.
//
// What the design does about it. The forward's: one block of 256 threads per
// (sample n, tile of CT=16 channels; 8 where 16 does not fit), so M for the
// tile and all three subsets sits in shared memory, stored [s][u][v][c] with
// the output joint v padded to a multiple of 5.
//   Stage 1 builds M with the forward's code (unit_ctr_gc_common.cuh:
//   build_m): D = tanh(x1_u - x2_v) once per subset in shared memory, then
//   M_s = D @ w4s[s] with w4s[s,:,4 channels] in registers.
//   Stage 2 walks T in chunks of 8 frames: the block copies the chunk's g
//   tile (8 x V x CT) into shared memory with 16-byte loads, all in flight at
//   once; then each thread owns one channel and, for one subset, a 2 (frames)
//   x 5 (joints v) register tile of dx3s, and for every u reads 5 values of M
//   and 2 of g for 10 FMAs.
// g is read from device memory once per block and dx3s written once.
//
// bf16 (unit_ctr_gc_bwd_dx3_bf16): x1s, x2s, g and dx3s bf16, the
// parameters f32; stage 1 as the forward's bf16 form, M and every sum in
// f32, dx3s rounded to bf16 once (Act<T> in unit_ctr_gc_common.cuh).
//
// Where M of even 8 channels for all V x V pairs does not fit a block's
// shared memory (see unit_ctr_gc_bwd_dx3_variant), the joint-tiled design of
// unit_ctr_gc_tiled.cuh runs instead (K2t), with the forward's roles
// swapped: a block owns (sample, subset, 16 joints v, 32 or 64 channels),
// walks the tiles of 16 joints u, builds each M tile stored [v][u][c] on
// the tensor cores and adds M_c^T @ g_c of TF frames, 3xTF32 in f32, with
// the next g chunk on its way by tensor copy. What bounds it on this card
// and what the design does about it: the header's design note (the
// operations, 82 G FMAs per configs/scene256.yaml train step at batch 8).

#include <cuda_runtime.h>

#include "unit_ctr_gc_common.cuh"
#include "unit_ctr_gc_tiled.cuh"

namespace {

using namespace unit_ctr_gc;

constexpr int kVV = 5;  // joints v per thread in stage 2
constexpr int kTT = 2;  // frames t per thread in stage 2

// shared memory, in floats: D/G region, then M, then E
__host__ __device__ inline int region0(int V, int CT, int RP) {
  return round4(imax(V * V * (RP + 1), kTC * V * CT));
}

template <int RP, typename TA>
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_dx3_kernel(const TA* __restrict__ x1s,
                           const TA* __restrict__ x2s,
                           const TA* __restrict__ g,
                           const float* __restrict__ w4s,
                           const float* __restrict__ b4s,
                           const float* __restrict__ alpha,
                           const float* __restrict__ As,
                           TA* __restrict__ dx3s,
                           int S, int T, int V, int R, int C, int CT, int VP) {
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

// The whole-V design's channel tile at (S, V, RP): 16, else 8 where 16 does
// not fit its shared memory, else 0, and then the tiled design runs.
inline int whole_v_ct(int S, int V, int RP) {
  const int VP = (V + kVV - 1) / kVV * kVV;
  for (int ct = 16; ct >= 8; ct /= 2) {
    const size_t bytes = sizeof(float) * ((size_t)region0(V, ct, RP) +
                                          (size_t)S * V * VP * ct + 2 * V * RP);
    if (bytes <= kSmemLimit) return ct;
  }
  return 0;
}

inline int rp_of(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : 32; }

template <int RP, int TF, typename TA>
__global__ void __launch_bounds__(kThreads, 1)
unit_ctr_gc_bwd_dx3_tiled_kernel(const TA* __restrict__ x1s,
                                 const TA* __restrict__ x2s,
                                 const TA* __restrict__ g,
                                 const float* __restrict__ w4s,
                                 const float* __restrict__ b4s,
                                 const float* __restrict__ alpha,
                                 const float* __restrict__ As,
                                 TA* __restrict__ dx3s,
                                 const __grid_constant__ CUtensorMap xmap,
                                 int S, int T, int V, int R, int C) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, sizeof(TA));
  // own joints v of subset s, summed u; the block walks the u tiles
  run<false, RP, TF, CT, TA>(x1s, x2s, g, w4s, b4s, alpha[0], As, dx3s, &xmap, blockIdx.z,
                             blockIdx.y % S, (blockIdx.y / S) * kJ, blockIdx.x * CT, S, T,
                             V, R, C);
}

template <int RP, int TF, typename TA>
int launch_tiled(const TA* x1s, const TA* x2s, const TA* g, const float* w4s,
                 const float* b4s, const float* alpha, const float* As, TA* dx3s,
                 int N, int S, int T, int V, int R, int C, cudaStream_t stream) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, sizeof(TA));
  constexpr int smem = smem_bytes(TF, CT, RP, sizeof(TA));
  static_assert(smem <= kSmemLimit, "the tiled design's shared memory");
  cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_bwd_dx3_tiled_kernel<RP, TF, TA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the f32 chunks arrive by tensor copies; the bf16 form does not read the map
  CUtensorMap xmap = {};
  if constexpr (sizeof(TA) == 4) {
    err = chunk_map(&xmap, reinterpret_cast<const float*>(g), N, T, V, C, TF);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + CT - 1) / CT, ((V + kJ - 1) / kJ) * S, N);
  unit_ctr_gc_bwd_dx3_tiled_kernel<RP, TF, TA><<<grid, kThreads, smem, stream>>>(
      x1s, x2s, g, w4s, b4s, alpha, As, dx3s, xmap, S, T, V, R, C);
  return cudaGetLastError();
}

template <int RP, typename TA>
int launch(const TA* x1s, const TA* x2s, const TA* g, const float* w4s,
           const float* b4s, const float* alpha, const float* As, TA* dx3s,
           int N, int S, int T, int V, int R, int C, cudaStream_t stream) {
  const int CT = whole_v_ct(S, V, RP);
  if (CT == 0) {
    const int TF = tiled::frame_tile(T);
    if (TF == 8) return launch_tiled<RP, 8>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
    if (TF == 16) return launch_tiled<RP, 16>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
    return launch_tiled<RP, 32>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
  }
  const int VP = (V + kVV - 1) / kVV * kVV;
  const size_t smem = sizeof(float) *
      ((size_t)region0(V, CT, RP) + (size_t)S * V * VP * CT + 2 * V * RP);
  cudaError_t err = cudaFuncSetAttribute(
      unit_ctr_gc_bwd_dx3_kernel<RP, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + CT - 1) / CT, N);
  unit_ctr_gc_bwd_dx3_kernel<RP, TA><<<grid, kThreads, smem, stream>>>(
      x1s, x2s, g, w4s, b4s, alpha, As, dx3s, S, T, V, R, C, CT, VP);
  return cudaGetLastError();
}

template <typename TA>
int dx3(const TA* x1s, const TA* x2s, const TA* g, const float* w4s,
        const float* b4s, const float* alpha, const float* As, TA* dx3s, int N,
        int S, int T, int V, int R, int C, void* stream) {
  if (N < 1 || N > 65535 || S < 1 || T < 1 || V < 1 || R < 1 || C < 4 ||
      C % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 8) return launch<8>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, st);
  if (R <= 16) return launch<16>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, st);
  if (R <= 32) return launch<32>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Which design unit_ctr_gc_bwd_dx3_f32 and unit_ctr_gc_bwd_dx3_bf16 launch
// at (S, V, R): 0 the whole-V kernel, 1 the joint-tiled one, -1 neither (R or
// S or V out of range).
extern "C" int unit_ctr_gc_bwd_dx3_variant(int S, int V, int R) {
  if (S < 1 || V < 1 || R < 1 || R > 32) return -1;
  return whole_v_ct(S, V, rp_of(R)) == 0 ? 1 : 0;
}

// All tensors contiguous f32 on the device, 16-byte aligned: x1s, x2s
// (N,S,V,R); g (N,T,V,C); w4s (S,R,C); b4s (S,C); alpha (1,); As (S,V,V);
// dx3s (N,T,V,S*C); C % 4 == 0 and R <= 32, any V (the design as
// unit_ctr_gc_bwd_dx3_variant says). Launches on `stream` and returns
// cudaGetLastError() (0 = ok).
extern "C" int unit_ctr_gc_bwd_dx3_f32(const float* x1s, const float* x2s,
                                       const float* g, const float* w4s,
                                       const float* b4s, const float* alpha,
                                       const float* As, float* dx3s, int N,
                                       int S, int T, int V, int R, int C,
                                       void* stream) {
  return dx3(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
}

// As unit_ctr_gc_bwd_dx3_f32 with x1s, x2s, g and dx3s bf16 (g and dx3s
// 8-byte aligned), the parameters f32.
extern "C" int unit_ctr_gc_bwd_dx3_bf16(const __nv_bfloat16* x1s,
                                        const __nv_bfloat16* x2s,
                                        const __nv_bfloat16* g,
                                        const float* w4s, const float* b4s,
                                        const float* alpha, const float* As,
                                        __nv_bfloat16* dx3s, int N, int S,
                                        int T, int V, int R, int C,
                                        void* stream) {
  return dx3(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
}
