// The x3 gradient of the unit CTR-GC op (K2's work), shared by K2
// (unit_ctr_gc_bwd_dx3.cu) and the first phase of K6
// (unit_ctr_gc_bwd_conv3.cu): the choice between the whole-V design
// (unit_ctr_gc_whole.cuh, V <= 24) and the joint-tiled one
// (unit_ctr_gc_tiled.cuh), with their grids, shared memory and tensor map.
// Each source defines its own kernels (so that a profile names them apart)
// and launches them through a class L with two static member templates:
//   L::whole<RP, JT>(grid, smem, stream, x1s, x2s, g, w4s, b4s, alpha, As,
//                    dx3s, S, T, V, R, C)
//   L::tiled<RP, TF>(grid, smem, stream, x1s, x2s, g, w4s, b4s, alpha, As,
//                    dx3s, xmap, S, T, V, R, C)
// (the element types of x1s/x2s, of the aggregated tensor and of the
// output deduced from the pointers: the unit op takes one type, K6's x3
// gradient and K4's bf16 form mix them), each of which sets the kernel's
// shared memory, launches it and returns cudaGetLastError(). What the
// designs do and what bounds them:
// unit_ctr_gc_bwd_dx3.cu's header and the two designs' headers.
#pragma once

#include <cuda_runtime.h>

#include "unit_ctr_gc_common.cuh"
#include "unit_ctr_gc_tiled.cuh"
#include "unit_ctr_gc_whole.cuh"

namespace unit_ctr_gc {
namespace dx3 {

inline int rp_of(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : 32; }

template <class L, int RP, int TF, typename TE, typename TX, typename TO>
int launch_tiled(const TE* x1s, const TE* x2s, const TX* g, const float* w4s,
                 const float* b4s, const float* alpha, const float* As, TO* dx3s,
                 int N, int S, int T, int V, int R, int C, cudaStream_t stream) {
  using namespace tiled;
  constexpr int CT = channel_tile(TF, RP, sizeof(TX));
  constexpr int smem = smem_bytes(TF, CT, RP, sizeof(TX));
  static_assert(smem <= kSmemLimit, "the tiled design's shared memory");
  // the f32 chunks arrive by tensor copies; the bf16 form does not read the map
  CUtensorMap xmap = {};
  if constexpr (sizeof(TX) == 4) {
    const cudaError_t err = chunk_map(&xmap, reinterpret_cast<const float*>(g), N, T, V, C, TF);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((C + CT - 1) / CT, ((V + kJ - 1) / kJ) * S, N);
  return L::template tiled<RP, TF>(grid, smem, stream, x1s, x2s, g, w4s, b4s, alpha, As,
                                   dx3s, xmap, S, T, V, R, C);
}

template <class L, int RP, typename TE, typename TX, typename TO>
int launch(const TE* x1s, const TE* x2s, const TX* g, const float* w4s,
           const float* b4s, const float* alpha, const float* As, TO* dx3s,
           int N, int S, int T, int V, int R, int C, cudaStream_t stream) {
  if (whole::takes(V)) {
    return whole::launch<L, false, RP>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R,
                                       C, stream);
  }
  const int TF = tiled::frame_tile(T);
  if (TF == 8) return launch_tiled<L, RP, 8>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
  if (TF == 16) return launch_tiled<L, RP, 16>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
  return launch_tiled<L, RP, 32>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, stream);
}

// Blocks of the launch run() makes at the shape, in either design (the
// joint-tiled one's f32 form).
inline long long blocks(int N, int S, int T, int V, int R, int C) {
  if (whole::takes(V)) {
    const dim3 grid = whole::grid(false, N, S, T, C);
    return (long long)grid.x * grid.y * grid.z;
  }
  const int RP = rp_of(R), TF = tiled::frame_tile(T);
  const int CT = tiled::channel_tile(TF, RP, 4);
  return (long long)((C + CT - 1) / CT) * ((V + tiled::kJ - 1) / tiled::kJ) * S * N;
}

// Whether dims() takes the shape: R <= 32, C % 4 == 0, any V.
inline bool dims_ok(int N, int S, int T, int V, int R, int C) {
  return N >= 1 && N <= 65535 && S >= 1 && T >= 1 && V >= 1 && R >= 1 && R <= 32 && C >= 4 &&
         C % 4 == 0;
}

// dx3s (N,T,V,S*C) of the unit op through L's kernels, in the design that
// unit_ctr_gc_bwd_dx3_variant names. Returns cudaGetLastError() (0 = ok).
template <class L, typename TE, typename TX, typename TO>
int run(const TE* x1s, const TE* x2s, const TX* g, const float* w4s, const float* b4s,
        const float* alpha, const float* As, TO* dx3s, int N, int S, int T, int V, int R,
        int C, cudaStream_t st) {
  if (!dims_ok(N, S, T, V, R, C)) return cudaErrorInvalidValue;
  if (R <= 8) return launch<L, 8>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, st);
  if (R <= 16) return launch<L, 16>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, st);
  return launch<L, 32>(x1s, x2s, g, w4s, b4s, alpha, As, dx3s, N, S, T, V, R, C, st);
}

}  // namespace dx3
}  // namespace unit_ctr_gc
