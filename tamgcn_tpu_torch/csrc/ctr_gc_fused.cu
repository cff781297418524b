// The standalone CTR-GC op's bf16 form (K4 bf16), for Hopper (sm_90a).
//
// Replaces tamgcn_tpu/ops/pallas/ctr_gc.py:_fused_kernel (launched by
// _fused_pallas_call, forward and transpose_m) on the operands the JAX
// `CTRGC(dtype=bfloat16)` gives it: x1, x2 (N,V,R) and x3 (N,T,V,C) bf16
// from bf16 1x1 convs, w4 (R,C), b4 (C,), alpha and A (V,V) f32:
//
//   forward:     out[n,t,u,c] = sum_v M[n,u,v,c] * x3[n,t,v,c]
//   transpose_m: dx3[n,t,v,c] = sum_u M[n,u,v,c] * g[n,t,u,c]
//   M[n,u,v,c] = (sum_r D[n,u,v,r] * w4[r,c] + b4[c]) * alpha + A[u,v]
//   D = bf16(tanh(bf16(x1[n,u,:] - x2[n,v,:])))
//
// with g the f32 gradient of the f32 output, and both outputs f32. The JAX
// kernel takes the difference and the tanh in bf16 (x1 and x2 are bf16),
// w4 in f32 and an f32 product, an f32 M and an f32 aggregation.
//
// The f32 op runs K1 and K2 at S = 1 (ops/aggregation.py:CtrGcFused); this
// form runs their bodies at S = 1 under its own names: the whole-V design
// (unit_ctr_gc_whole.cuh) up to V = 24, the joint-tiled one
// (unit_ctr_gc_tiled.cuh) past it, with stage 1's K4 policy (Stage1::kK4,
// unit_ctr_gc_common.cuh): D rounded as the JAX kernel rounds it, w4 f32.
// A bf16 value is exact in TF32, so the 3xTF32 split of D, and of a bf16
// x3, has a zero remainder: stage 1 takes D times w4's two TF32 parts and
// the forward's aggregation x3 times M's two parts, two products a term
// where 3xTF32 takes three; the transposed call's f32 g takes all three.
// What that leaves is the TF32 remainder of w4 (and of M) truncated to its
// top 11 bits, ~2^-22 of each term, well inside the 1e-4 of max |out| the
// tests hold the form to.
//
// What bounds it on this card: at the CTRGC main-path shape (N=16, T=52,
// V=20, Cin=64, C=128, R=8) the bytes, x3 in bf16 and out in f32 (~13 MB a
// forward, ~4 us at 3.35 TB/s) against ~0.1 GFLOP (the products at two
// TF32 terms, 495/2 TFLOP/s; ~0.4 us). The designs' headers say what the
// bodies do about their own limits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "unit_ctr_gc_dx3.cuh"
#include "unit_ctr_gc_fwd.cuh"

namespace {

using namespace unit_ctr_gc;
using bf16 = __nv_bfloat16;

// kFwd: the forward (src x3 bf16), else transpose_m (src g f32); out f32
template <bool kFwd, int RP, int JT, typename TX>
__global__ void __launch_bounds__(kThreads, 2)
ctr_gc_fused_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2,
                    const TX* __restrict__ src, const float* __restrict__ w4,
                    const float* __restrict__ b4, const float* __restrict__ alpha,
                    const float* __restrict__ A, float* __restrict__ out, int S, int T, int V,
                    int R, int C) {
  whole::run<kFwd, RP, JT, bf16, TX, float, Stage1::kK4>(x1, x2, src, w4, b4, alpha, A, out,
                                                         S, T, V, R, C);
}

template <bool kFwd, int RP, int TF, typename TX>
__global__ void __launch_bounds__(kThreads, 1)
ctr_gc_fused_tiled_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2,
                          const TX* __restrict__ src, const float* __restrict__ w4,
                          const float* __restrict__ b4, const float* __restrict__ alpha,
                          const float* __restrict__ A, float* __restrict__ out,
                          const __grid_constant__ CUtensorMap xmap, int S, int T, int V, int R,
                          int C) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, sizeof(TX));
  // at S = 1 both directions' grids are (channel tiles, own-joint tiles, N)
  run<kFwd, RP, TF, CT, bf16, TX, float, Stage1::kK4>(x1, x2, src, w4, b4, alpha[0], A, out,
                                                      &xmap, blockIdx.z, 0, blockIdx.y * kJ,
                                                      blockIdx.x * CT, S, T, V, R, C);
}

// the launches of each direction (0 forward, 1 transpose) and design (0
// whole-V, 1 joint-tiled), counted on the host where a kernel is launched:
// the witness of the design a call took (ctr_gc_fused_launched)
long long launched[2][2] = {{0, 0}, {0, 0}};

// the kernels for fwd::run (kFwd) and dx3::run
template <bool kFwd>
struct Launch {
  template <int RP, int JT, typename TX>
  static int whole(dim3 grid, size_t smem, cudaStream_t st, const bf16* x1, const bf16* x2,
                   const TX* src, const float* w4, const float* b4, const float* alpha,
                   const float* A, float* out, int S, int T, int V, int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(ctr_gc_fused_kernel<kFwd, RP, JT, TX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ctr_gc_fused_kernel<kFwd, RP, JT, TX><<<grid, kThreads, smem, st>>>(
        x1, x2, src, w4, b4, alpha, A, out, S, T, V, R, C);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++launched[kFwd ? 0 : 1][0];
    return err;
  }
  template <int RP, int TF, typename TX>
  static int tiled(dim3 grid, int smem, cudaStream_t st, const bf16* x1, const bf16* x2,
                   const TX* src, const float* w4, const float* b4, const float* alpha,
                   const float* A, float* out, const CUtensorMap& xmap, int S, int T, int V,
                   int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(ctr_gc_fused_tiled_kernel<kFwd, RP, TF, TX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ctr_gc_fused_tiled_kernel<kFwd, RP, TF, TX><<<grid, kThreads, smem, st>>>(
        x1, x2, src, w4, b4, alpha, A, out, xmap, S, T, V, R, C);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++launched[kFwd ? 0 : 1][1];
    return err;
  }
};

}  // namespace

// Launches of K4-bf16's forward (transpose 0) or transposed call
// (transpose 1) in `design` (0 whole-V, 1 joint-tiled) so far, counted where
// the kernel is launched; -1 for another direction or design.
extern "C" long long ctr_gc_fused_launched(int transpose, int design) {
  return (transpose == 0 || transpose == 1) && (design == 0 || design == 1)
             ? launched[transpose][design]
             : -1;
}

// x1, x2 (N,V,R) bf16; x3 (N,T,V,C) bf16, 8-byte aligned; w4 (R,C), b4
// (C,), 16-byte aligned, alpha (1,), A (V,V) f32; out (N,T,V,C) f32; C % 4
// == 0 and R <= 32, any V (the whole-V design up to V = 24, as
// unit_ctr_gc_fwd_variant says at S = 1). Launches on `stream` and returns
// cudaGetLastError() (0 = ok).
extern "C" int ctr_gc_fused_bf16(const bf16* x1, const bf16* x2, const bf16* x3,
                                 const float* w4, const float* b4, const float* alpha,
                                 const float* A, float* out, int N, int T, int V, int R, int C,
                                 void* stream) {
  return fwd::run<Launch<true>, bf16>(x1, x2, x3, w4, b4, alpha, A, out, N, 1, T, V, R, C,
                                      static_cast<cudaStream_t>(stream));
}

// The transposed call (transpose_m): as ctr_gc_fused_bf16 with g (N,T,V,C)
// f32, 16-byte aligned, in x3's place and dx3 (N,T,V,C) f32 out.
extern "C" int ctr_gc_fused_t_bf16(const bf16* x1, const bf16* x2, const float* g,
                                   const float* w4, const float* b4, const float* alpha,
                                   const float* A, float* dx3, int N, int T, int V, int R,
                                   int C, void* stream) {
  return dx3::run<Launch<false>, bf16>(x1, x2, g, w4, b4, alpha, A, dx3, N, 1, T, V, R, C,
                                       static_cast<cudaStream_t>(stream));
}
