// What the two sources of the unit op's parameter gradients (K3) share:
// the f32 kernel (unit_ctr_gc_bwd_param.cu) and the bf16 one
// (unit_ctr_gc_bwd_param_bf16.cu) split the work over blocks by (sample n,
// subset s, tile of J <= kJmax joints u, tile of kCT channels) alike and
// write the same per-block partials to the scratch, which each sums in a
// fixed order with a reduce kernel of its own.
#pragma once

#include <cuda_runtime.h>

namespace unit_ctr_gc {
namespace param {

constexpr int kCT = 16;    // channels per block
constexpr int kJmax = 20;  // joints per tile, at most
constexpr int kJ5 = 5;     // the f32 kernel's joint padding: a thread's 5 x 5 dm tile

// The joint tiling of V: nt tiles of J joints (the last may be partial),
// each padded to JP, a multiple of kJ5.
struct Tiling {
  int nt, J, JP;
};
__host__ __device__ inline Tiling tiling(int V) {
  const int nt = (V + kJmax - 1) / kJmax;
  const int J = (V + nt - 1) / nt;
  return {nt, J, (J + kJ5 - 1) / kJ5 * kJ5};
}

__host__ __device__ inline int channel_tiles(int C) { return (C + kCT - 1) / kCT; }

// The partials in the scratch buffer, in floats, in this order:
//   P    [N][S][nt][R*C + C]  P = D^T dm and sum(dm) of one u tile
//   dA   [N][KC][S][V*V]      sum_c dm of one channel tile
//   dx1  [N][S][KC][V*R]      sum_v dpre of one channel tile
//   dx2  [N][S][KC][nt][V*R]  sum_u dpre of one channel tile and u tile
struct Parts {
  size_t p, a, x1, x2, end;
};
__host__ __device__ inline Parts parts(int N, int S, int V, int R, int C) {
  const Tiling tl = tiling(V);
  const size_t KC = channel_tiles(C), NS = (size_t)N * S;
  Parts o;
  o.p = 0;
  o.a = o.p + NS * tl.nt * ((size_t)R * C + C);
  o.x1 = o.a + NS * KC * V * V;
  o.x2 = o.x1 + NS * KC * V * R;
  o.end = o.x2 + NS * KC * tl.nt * V * R;
  return o;
}

// the reduce kernels' outputs: dx1s, dx2s (N*S*V*R each), dAs (S*V*V), dw4s
// and db4s (S*(R*C + C)), in this order
__host__ inline size_t reduce_items(int N, int S, int V, int R, int C) {
  return 2 * (size_t)N * S * V * R + (size_t)S * V * V + (size_t)S * ((size_t)R * C + C);
}

}  // namespace param
}  // namespace unit_ctr_gc
