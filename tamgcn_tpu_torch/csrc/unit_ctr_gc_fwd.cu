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
// What bounds it on this card. At the NW-UCLA shapes (V=20) the bytes do:
// x3s in and out back (e.g. N=64, T=13, C=256: ~68 MB, ~20 us at 3.35
// TB/s) against 2*N*S*(V*V*R*C + T*V*V*C) FMAs (~1.77 GFLOP there, ~11 us
// at the 165 TFLOP/s of f32 products on the tensor cores as 3xTF32). M for
// one (n, s) is V*V*C*4 B (410 KB at C=256), larger than a block's 227 KB
// of shared memory.
//
// What the design does about it (unit_ctr_gc_whole.cuh, whose header says
// what held the design before it back): a block of 8 warps per (sample n,
// 16 channels, tile of <= 16 frames), 256-1024 blocks a NW-UCLA launch. It
// walks the subsets s with the subset sum in registers: builds M_s of its
// channels in shared memory on the tensor cores (D = tanh(x1_u - x2_v) in
// registers as the A fragments), then adds the product (frames x v) @ M_s^T
// per channel on the tensor cores, 3xTF32 in f32, while the next subset's
// x3s tile and x1/x2 rows are on their way into registers. x3s is read from
// device memory once and out written once, in whole 64-byte rows.

// bf16 (unit_ctr_gc_fwd_bf16): x1s, x2s, x3s and out are bf16, the
// parameters f32, as the JAX kernel takes them under bf16 mixed precision.
// The same kernels run on them (Act<T> and Stage1 in
// unit_ctr_gc_common.cuh): tanh in f32 from the bf16 x1s and x2s; stage 1
// one bf16 product over D and w4s rounded to bf16, accumulated in f32; M in
// f32 in shared memory; stage 2 in f32 (M's two TF32 parts against the
// bf16 x3s, exact in TF32); out rounded to bf16 once.
//
// Past V = 24 (unit_ctr_gc_fwd_variant) the joint-tiled design of
// unit_ctr_gc_tiled.cuh runs instead (K1t): a block owns (sample, 16 joints
// u, 32 or 64 channels), walks the subsets and the tiles of 16 joints v,
// builds each M tile on the tensor cores with the tanh in registers, and
// adds M_c @ x3s_c of TF = 8, 16 or 32 frames (from T) on the tensor cores,
// 3xTF32 in f32, with the next x3s chunk on its way by tensor copy. At
// configs/scene256.yaml's shapes (V=256) the operations bound it: M costs
// V*V*R*C FMAs per sample and subset, as many as or more than the
// aggregation's T*V*V*C; the design note in the header says what held the
// first design back and what this one does about it.

// The whole-V body (unit_ctr_gc_whole.cuh) and both designs' launch rules
// (unit_ctr_gc_fwd.cuh) are shared with K5.

#include <cuda_runtime.h>

#include "unit_ctr_gc_fwd.cuh"

namespace {

using namespace unit_ctr_gc;

template <int RP, int JT, typename TA>
__global__ void __launch_bounds__(kThreads, 2)
unit_ctr_gc_fwd_kernel(const TA* __restrict__ x1s,
                       const TA* __restrict__ x2s,
                       const TA* __restrict__ x3s,
                       const float* __restrict__ w4s,
                       const float* __restrict__ b4s,
                       const float* __restrict__ alpha,
                       const float* __restrict__ As,
                       TA* __restrict__ out,
                       int S, int T, int V, int R, int C) {
  whole::run<true, RP, JT, TA>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, S, T, V, R, C);
}

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

// the launches of each design (0 whole-V, 1 joint-tiled), counted on the
// host where a kernel is launched: the witness of the design a call took
// (unit_ctr_gc_fwd_launched)
long long launched[2] = {0, 0};

// K1's kernels for fwd::run
struct Launch {
  template <int RP, int JT, typename TA>
  static int whole(dim3 grid, size_t smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* x3s, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, TA* out, int S, int T, int V, int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_fwd_kernel<RP, JT, TA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    unit_ctr_gc_fwd_kernel<RP, JT, TA><<<grid, kThreads, smem, st>>>(
        x1s, x2s, x3s, w4s, b4s, alpha, As, out, S, T, V, R, C);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++launched[0];
    return err;
  }
  template <int RP, int TF, typename TA>
  static int tiled(dim3 grid, int smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* x3s, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, TA* out, const CUtensorMap& xmap, int S, int T, int V,
                   int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_fwd_tiled_kernel<RP, TF, TA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    unit_ctr_gc_fwd_tiled_kernel<RP, TF, TA><<<grid, kThreads, smem, st>>>(
        x1s, x2s, x3s, w4s, b4s, alpha, As, out, xmap, S, T, V, R, C);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++launched[1];
    return err;
  }
};

template <typename TA>
int out_of(const TA* x1s, const TA* x2s, const TA* x3s, const float* w4s, const float* b4s,
           const float* alpha, const float* As, TA* out, int N, int S, int T, int V, int R,
           int C, void* stream) {
  return fwd::run<Launch, TA>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C,
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

// Which design unit_ctr_gc_fwd_f32 and unit_ctr_gc_fwd_bf16 launch at
// (S, V, R): 0 the whole-V kernel (V <= 24), 1 the joint-tiled one, -1
// neither (R or S or V out of range). The two dtypes take the same design.
extern "C" int unit_ctr_gc_fwd_variant(int S, int V, int R) {
  if (S < 1 || V < 1 || R < 1 || R > 32) return -1;
  return whole::takes(V) ? 0 : 1;
}

// Launches of `design` (0 the whole-V kernel, 1 the joint-tiled one) that
// unit_ctr_gc_fwd_f32 and unit_ctr_gc_fwd_bf16 made so far, counted
// where they launch the kernel; -1 for any other design.
extern "C" long long unit_ctr_gc_fwd_launched(int design) {
  return design == 0 || design == 1 ? launched[design] : -1;
}

// Blocks of unit_ctr_gc_fwd_f32's launch at the shape; -1 where it does not
// take it.
extern "C" long long unit_ctr_gc_fwd_blocks(int N, int S, int T, int V, int R, int C) {
  if (!fwd::dims_ok(N, S, T, V, R, C)) return -1;
  return fwd::blocks(N, S, T, V, R, C);
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
  return out_of(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
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
  return out_of(x1s, x2s, x3s, w4s, b4s, alpha, As, out, N, S, T, V, R, C, stream);
}
