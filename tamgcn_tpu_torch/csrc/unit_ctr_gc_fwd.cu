// Unit CTR-GC forward (K1) for Hopper (sm_90a), f32 and bf16.
//
// Replaces tamgcn_tpu/ops/pallas/ctr_gc.py:_unit_fwd_kernel_tile (launched by
// unit_ctr_gc_fwd_pallas) and computes the same function:
//
//   out[n,t,u,c] = sum_s sum_v M_s[n,u,v,c] * x3s[n,t,v,s*C+c]
//   M_s[n,u,v,c] = (sum_r tanh(x1s[n,s,u,r] - x2s[n,s,v,r]) * w4s[s,r,c]
//                   + b4s[s,c]) * alpha + As[s,u,v]
//
// with the refined adjacency M never written to device memory.
//
// What bounds it on this card. At the deep NW-UCLA shape (N=64, T=13, V=20,
// C=256, R=32) the function moves ~68 MB (x3s in, out back: ~20 us at
// 3.35 TB/s) and does 2*N*S*(V*V*R*C + T*V*V*C) ~ 1.77 GFLOP of f32 FMAs,
// ~26 us on the 67 TFLOP/s f32 CUDA cores: the operations bound it, and
// building M (the V*V*R*C term) is two thirds of them. At the wider-T
// shapes (T=52, C=64) the bytes bound it. M for one (n, s) is V*V*C*4 B
// (410 KB at C=256), larger than a block's 227 KB of shared memory.
//
// What the design does about it. One block of 256 threads per (sample n,
// tile of CT=16 channels; 8 where 16 does not fit), so M for the tile and
// all three subsets sits in shared memory, and at R <= 16 two blocks share
// an SM. With so few warps per SM, every loop keeps several independent
// loads or arithmetic chains in flight per thread.
//   Stage 1 (unit_ctr_gc_common.cuh:build_m, shared with K2): for each
//   subset s, the block stages the x1/x2 rows in shared memory and computes
//   D = tanh(x1_u - x2_v) (V*V*R values, once per block instead of once per
//   channel). Then M_s = D @ w4s[s] is a small GEMM: each thread holds
//   w4s[s,:,4 channels] in registers and, per r, reads one value of D (rows
//   padded to RP+1 floats, so the 8 rows a warp reads sit in different
//   banks) for 4 FMAs, two (u,v) rows at a time.
//   Stage 2: the block walks T in chunks of 8 frames. All threads first copy
//   the chunk's x3s tile (8 x V x S x CT values) into shared memory over D,
//   with 16-byte loads, consecutive threads on consecutive channels, all of a
//   thread's loads in flight at once; then each thread owns one channel and
//   a 2 (frames) x 5 (joints) register tile of out and, for every (s,v),
//   reads 5 values of M and 2 of x3s from shared memory for 10 FMAs.
// x3s is read from device memory once per block and out written once.
// Tensor cores, TMA, double-buffered chunks and a persistent grid are left
// for later work.
//
// bf16 (unit_ctr_gc_fwd_bf16): x1s, x2s, x3s and out are bf16, the
// parameters f32, as the JAX kernel takes them under bf16 mixed precision.
// The same kernels run on them (Act<T> in unit_ctr_gc_common.cuh): tanh in
// f32 from the bf16 x1s and x2s; stage 1 over D and w4s rounded to bf16,
// accumulated in f32; M in f32 in shared memory; stage 2 in f32; out rounded
// to bf16 once. The f32 kernels are the same code with nothing rounded.
//
// Where M of even 8 channels for all V x V pairs does not fit a block's
// shared memory (V >= 33 at R <= 8; see unit_ctr_gc_fwd_variant), the
// joint-tiled design of unit_ctr_gc_tiled.cuh runs instead (K1t): a block
// owns (sample, 16 joints u, 32 or 64 channels), walks the subsets and the
// tiles of 16 joints v, builds each M tile on the tensor cores with the
// tanh in registers, and adds M_c @ x3s_c of TF = 8, 16 or 32 frames (from
// T) on the tensor cores, 3xTF32 in f32, with the next x3s chunk on its way
// by tensor copy. At configs/scene256.yaml's shapes (V=256) the operations
// bound it: M costs V*V*R*C FMAs per sample and subset, as many as or more
// than the aggregation's T*V*V*C; the design note in the header says what
// held the first design back and what this one does about it.

#include <cuda_runtime.h>

#include "unit_ctr_gc_common.cuh"
#include "unit_ctr_gc_tiled.cuh"

namespace {

using namespace unit_ctr_gc;

constexpr int kUU = 5;  // joints u per thread in stage 2
constexpr int kTT = 2;  // frames t per thread in stage 2

// shared memory, in floats: D/X region, then M, then E
__host__ __device__ inline int region0(int V, int S, int CT, int RP) {
  return round4(imax(V * V * (RP + 1), kTC * V * S * CT));
}

template <int RP, typename TA>
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_fwd_kernel(const TA* __restrict__ x1s,
                       const TA* __restrict__ x2s,
                       const TA* __restrict__ x3s,
                       const float* __restrict__ w4s,
                       const float* __restrict__ b4s,
                       const float* __restrict__ alpha,
                       const float* __restrict__ As,
                       TA* __restrict__ out,
                       int S, int T, int V, int R, int C, int CT, int VP) {
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

template <int RP, int TF, typename TA>
__global__ void __launch_bounds__(kThreads, 1)
unit_ctr_gc_fwd_tiled_kernel(const TA* __restrict__ x1s,
                             const TA* __restrict__ x2s,
                             const TA* __restrict__ x3s,
                             const float* __restrict__ w4s,
                             const float* __restrict__ b4s,
                             const float* __restrict__ alpha,
                             const float* __restrict__ As,
                             TA* __restrict__ out,
                             const __grid_constant__ CUtensorMap xmap,
                             int S, int T, int V, int R, int C) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, sizeof(TA));
  // own joints u, summed v; the block walks the subsets and the v tiles
  run<true, RP, TF, CT, TA>(x1s, x2s, x3s, w4s, b4s, alpha[0], As, out, &xmap, blockIdx.z, 0,
                            blockIdx.y * kJ, blockIdx.x * CT, S, T, V, R, C);
}

template <int RP, int TF, typename TA>
int launch_tiled(const TA* x1s, const TA* x2s, const TA* x3s, const float* w4s,
                 const float* b4s, const float* alpha, const float* As, TA* out,
                 int N, int S, int T, int V, int R, int C, cudaStream_t stream) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, sizeof(TA));
  constexpr int smem = smem_bytes(TF, CT, RP, sizeof(TA));
  static_assert(smem <= kSmemLimit, "the tiled design's shared memory");
  cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_fwd_tiled_kernel<RP, TF, TA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // the f32 chunks arrive by tensor copies; the bf16 form does not read the map
  CUtensorMap xmap = {};
  if constexpr (sizeof(TA) == 4) {
    err = chunk_map(&xmap, reinterpret_cast<const float*>(x3s), N, T, V, S * C, TF);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + CT - 1) / CT, (V + kJ - 1) / kJ, N);
  unit_ctr_gc_fwd_tiled_kernel<RP, TF, TA><<<grid, kThreads, smem, stream>>>(
      x1s, x2s, x3s, w4s, b4s, alpha, As, out, xmap, S, T, V, R, C);
  return cudaGetLastError();
}

template <int RP, typename TA>
int launch(const TA* x1s, const TA* x2s, const TA* x3s, const float* w4s,
           const float* b4s, const float* alpha, const float* As, TA* out,
           int N, int S, int T, int V, int R, int C, cudaStream_t stream) {
  const int CT = whole_v_ct(S, V, RP);
  if (CT == 0) {
    const int TF = tiled::frame_tile(T);
    if (TF == 8) return launch_tiled<RP, 8>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
    if (TF == 16) return launch_tiled<RP, 16>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
    return launch_tiled<RP, 32>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
  }
  const int VP = (V + kUU - 1) / kUU * kUU;
  const size_t smem = sizeof(float) *
      ((size_t)region0(V, S, CT, RP) + (size_t)S * VP * V * CT + 2 * V * RP);
  cudaError_t err = cudaFuncSetAttribute(
      unit_ctr_gc_fwd_kernel<RP, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + CT - 1) / CT, N);
  unit_ctr_gc_fwd_kernel<RP, TA><<<grid, kThreads, smem, stream>>>(
      x1s, x2s, x3s, w4s, b4s, alpha, As, out, S, T, V, R, C, CT, VP);
  return cudaGetLastError();
}

template <typename TA>
int fwd(const TA* x1s, const TA* x2s, const TA* x3s, const float* w4s,
        const float* b4s, const float* alpha, const float* As, TA* out, int N,
        int S, int T, int V, int R, int C, void* stream) {
  if (N < 1 || N > 65535 || S < 1 || T < 1 || V < 1 || R < 1 || C < 4 ||
      C % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 8) return launch<8>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, st);
  if (R <= 16) return launch<16>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, st);
  if (R <= 32) return launch<32>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Which design unit_ctr_gc_fwd_f32 and unit_ctr_gc_fwd_bf16 launch at
// (S, V, R): 0 the whole-V kernel, 1 the joint-tiled one, -1 neither (R or S
// or V out of range). Shared memory holds f32 in either dtype, so the two
// take the same design.
extern "C" int unit_ctr_gc_fwd_variant(int S, int V, int R) {
  if (S < 1 || V < 1 || R < 1 || R > 32) return -1;
  return whole_v_ct(S, V, rp_of(R)) == 0 ? 1 : 0;
}

// All tensors contiguous f32 on the device, 16-byte aligned: x1s, x2s
// (N,S,V,R); x3s (N,T,V,S*C); w4s (S,R,C); b4s (S,C); alpha (1,); As (S,V,V);
// out (N,T,V,C); C % 4 == 0 and R <= 32, any V (the design as
// unit_ctr_gc_fwd_variant says). Launches on `stream` and returns
// cudaGetLastError() (0 = ok).
extern "C" int unit_ctr_gc_fwd_f32(const float* x1s, const float* x2s,
                                   const float* x3s, const float* w4s,
                                   const float* b4s, const float* alpha,
                                   const float* As, float* out, int N, int S,
                                   int T, int V, int R, int C, void* stream) {
  return fwd(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
}

// As unit_ctr_gc_fwd_f32 with x1s, x2s, x3s and out bf16 (x3s and out
// 8-byte aligned), the parameters f32.
extern "C" int unit_ctr_gc_fwd_bf16(const __nv_bfloat16* x1s,
                                    const __nv_bfloat16* x2s,
                                    const __nv_bfloat16* x3s, const float* w4s,
                                    const float* b4s, const float* alpha,
                                    const float* As, __nv_bfloat16* out, int N,
                                    int S, int T, int V, int R, int C,
                                    void* stream) {
  return fwd(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
}
