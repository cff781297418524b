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

// The whole-V body and both designs' launch rules live in
// unit_ctr_gc_fwd.cuh, which K5 shares.

#include <cuda_runtime.h>

#include "unit_ctr_gc_fwd.cuh"

namespace {

using namespace unit_ctr_gc;

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
  fwd::whole_v<RP, TA>(x1s, x2s, x3s, w4s, b4s, alpha, As, out, S, T, V, R, C, CT, VP);
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

// K1's kernels for fwd::run
struct Launch {
  template <int RP, typename TA>
  static int whole(dim3 grid, size_t smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* x3s, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, TA* out, int S, int T, int V, int R, int C, int CT,
                   int VP) {
    cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_fwd_kernel<RP, TA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    unit_ctr_gc_fwd_kernel<RP, TA><<<grid, kThreads, smem, st>>>(
        x1s, x2s, x3s, w4s, b4s, alpha, As, out, S, T, V, R, C, CT, VP);
    return cudaGetLastError();
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
    return cudaGetLastError();
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
// (S, V, R): 0 the whole-V kernel, 1 the joint-tiled one, -1 neither (R or S
// or V out of range). Shared memory holds f32 in either dtype, so the two
// take the same design.
extern "C" int unit_ctr_gc_fwd_variant(int S, int V, int R) {
  if (S < 1 || V < 1 || R < 1 || R > 32) return -1;
  return fwd::whole_v_ct(S, V, fwd::rp_of(R)) == 0 ? 1 : 0;
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
