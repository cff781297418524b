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
// What bounds it on this card. At the NW-UCLA shapes (V=20) the bytes do:
// g in and dx3s out (e.g. N=16, T=13, C=256: ~17 MB, ~5 us at 3.35 TB/s)
// against 2*N*S*(V*V*R*C + T*V*V*C) FMAs (~0.44 GFLOP there, ~3 us at the
// 165 TFLOP/s of f32 products on the tensor cores as 3xTF32). As in the
// forward, M for one (n, s) is V*V*C*4 B (410 KB at C=256), larger than a
// block's 227 KB of shared memory.
//
// What the design does about it: the forward's (unit_ctr_gc_whole.cuh),
// with a block per (sample n, subset s, 16 channels, tile of <= 16
// frames), since each subset's output is its own: it builds M_s of its
// channels on the tensor cores, with the g tile on its way into registers
// meanwhile, then adds the product (frames x u) @ M_s per channel on the
// tensor cores, 3xTF32 in f32. The S blocks of one (n, channels, frames)
// are launched side by side and read the same g tile, all but the first
// mostly from L2; dx3s is written once, in whole 64-byte rows.

// bf16 (unit_ctr_gc_bwd_dx3_bf16): x1s, x2s, g and dx3s bf16, the
// parameters f32; stage 1 as the forward's bf16 form, M and every sum in
// f32, dx3s rounded to bf16 once (Act<T> in unit_ctr_gc_common.cuh).
//
// Past V = 24 (unit_ctr_gc_bwd_dx3_variant) the joint-tiled design of
// unit_ctr_gc_tiled.cuh runs instead (K2t), with the forward's roles
// swapped: a block owns (sample, subset, 16 joints v, 32 or 64 channels),
// walks the tiles of 16 joints u, builds each M tile stored [v][u][c] on
// the tensor cores and adds M_c^T @ g_c of TF frames, 3xTF32 in f32, with
// the next g chunk on its way by tensor copy. What bounds it on this card
// and what the design does about it: the header's design note (the
// operations, 82 G FMAs per configs/scene256.yaml train step at batch 8).

// The whole-V body (unit_ctr_gc_whole.cuh) and both designs' launch rules
// (unit_ctr_gc_dx3.cuh) are shared with K6.

#include <cuda_runtime.h>

#include "unit_ctr_gc_dx3.cuh"

namespace {

using namespace unit_ctr_gc;

template <int RP, int JT, typename TA>
__global__ void __launch_bounds__(kThreads, 2)
unit_ctr_gc_bwd_dx3_kernel(const TA* __restrict__ x1s,
                           const TA* __restrict__ x2s,
                           const TA* __restrict__ g,
                           const float* __restrict__ w4s,
                           const float* __restrict__ b4s,
                           const float* __restrict__ alpha,
                           const float* __restrict__ As,
                           TA* __restrict__ dx3s,
                           int S, int T, int V, int R, int C) {
  whole::run<false, RP, JT, TA>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, S, T, V, R, C);
}

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

// the launches of each design (0 whole-V, 1 joint-tiled), counted on the
// host where a kernel is launched: the witness of the design a call took
// (unit_ctr_gc_bwd_dx3_launched)
long long launched[2] = {0, 0};

// K2's kernels for dx3::run
struct Launch {
  template <int RP, int JT, typename TA>
  static int whole(dim3 grid, size_t smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* g, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, TA* dx3s, int S, int T, int V, int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_bwd_dx3_kernel<RP, JT, TA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    unit_ctr_gc_bwd_dx3_kernel<RP, JT, TA><<<grid, kThreads, smem, st>>>(
        x1s, x2s, g, w4s, b4s, alpha, As, dx3s, S, T, V, R, C);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++launched[0];
    return err;
  }
  template <int RP, int TF, typename TA>
  static int tiled(dim3 grid, int smem, cudaStream_t st, const TA* x1s, const TA* x2s,
                   const TA* g, const float* w4s, const float* b4s, const float* alpha,
                   const float* As, TA* dx3s, const CUtensorMap& xmap, int S, int T, int V,
                   int R, int C) {
    cudaError_t err = cudaFuncSetAttribute(unit_ctr_gc_bwd_dx3_tiled_kernel<RP, TF, TA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    unit_ctr_gc_bwd_dx3_tiled_kernel<RP, TF, TA><<<grid, kThreads, smem, st>>>(
        x1s, x2s, g, w4s, b4s, alpha, As, dx3s, xmap, S, T, V, R, C);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++launched[1];
    return err;
  }
};

template <typename TA>
int dx3s_of(const TA* x1s, const TA* x2s, const TA* g, const float* w4s,
            const float* b4s, const float* alpha, const float* As, TA* dx3s, int N,
            int S, int T, int V, int R, int C, void* stream) {
  return dx3::run<Launch, TA>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C,
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

// Which design unit_ctr_gc_bwd_dx3_f32 and unit_ctr_gc_bwd_dx3_bf16 launch
// at (S, V, R): 0 the whole-V kernel (V <= 24), 1 the joint-tiled one, -1
// neither (R or S or V out of range).
extern "C" int unit_ctr_gc_bwd_dx3_variant(int S, int V, int R) {
  if (S < 1 || V < 1 || R < 1 || R > 32) return -1;
  return whole::takes(V) ? 0 : 1;
}

// Launches of `design` (0 the whole-V kernel, 1 the joint-tiled one) that
// unit_ctr_gc_bwd_dx3_f32 and unit_ctr_gc_bwd_dx3_bf16 made so far, counted
// where they launch the kernel; -1 for any other design.
extern "C" long long unit_ctr_gc_bwd_dx3_launched(int design) {
  return design == 0 || design == 1 ? launched[design] : -1;
}

// Blocks of unit_ctr_gc_bwd_dx3_f32's launch at the shape; -1 where it does
// not take it.
extern "C" long long unit_ctr_gc_bwd_dx3_blocks(int N, int S, int T, int V, int R, int C) {
  if (!dx3::dims_ok(N, S, T, V, R, C)) return -1;
  return dx3::blocks(N, S, T, V, R, C);
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
  return dx3s_of(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
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
  return dx3s_of(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
}
