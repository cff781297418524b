// Stage-2 aggregation from a given M (T2) for Hopper (sm_90a), f32 or bf16.
//
// Replaces the stage-2 probes of tools/exp_stage2.py (_floor_kernel,
// _win_kernel, _tile_kernel, _flat_kernel) and tools/exp_stage2b.py
// (_tile_kernel, f32 and bf16) with one kernel, templated on the index rule,
// the subset sum and the element type. With M (V, V, L) shared by the whole
// batch and x3 (N, T, V, L):
//
//   out[n,t,u,l] = sum_j M[j,u,l] * x3[n,t,v(j,u),l]
//
//   kTile   v = j           (M laid out (v, u, l))
//   kDiag   v = (u+j) mod V (M holds the diagonals; the win and flat forms)
//   kFloor  v = u           (x3's joint pinned to u; the FMA-rate floor probe)
//
// and with the subset sum (L = S*C) out[n,t,u,c] = sum_s acc[n,t,u,s*C+c].
// Products and sums are f32 whatever the element type; the output is
// rounded once to it.
//
// What bounds it on this card. At the tools' shape (N=64, T=13, V=20,
// L=768) it moves 103 MB in f32 (x3 in and out once, M once: 31 us at
// 3.35 TB/s; 21 us with the subset sum) and does 0.26 G FMAs (8 us at the
// f32 peak): the bytes bound it.
//
// What the design does about it. M is shared by the batch, so a block owns
// a tile of LT output channels (all S subsets of them with the subset sum)
// and a range of (n, t) rows, and keeps M of the tile in shared memory as
// f32, laid out [subset][v or j][u (padded to VT)][channel] with the diagonal
// rule resolved while staging (V*VT*32*4 B = 61 KB at V = 20). It reuses
// the tile across all its rows. Channels map to threads, so every x3 and
// output access runs along the contiguous channel axis and each x3 value is
// read from device memory once. A thread keeps the VT output joints of R
// rows in registers: per source joint one load of x3 per row and, per
// output joint, one shared-memory load of M for R FMAs. It reaches about a
// third of the memory rate (PERF.md); a variant that loads all of a row's
// joints into registers first was faster on the tile and diagonal rules
// and slower on the others. TMA copies of x3 tiles into shared memory, with
// more bytes in flight, are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;   // bytes a block may use on sm_90
constexpr int kSmemTwo = 113 * 1024;  // two blocks per SM
constexpr int kSMs = 132;
constexpr int kTile = 0, kDiag = 1, kFloor = 2;

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <class E> __device__ inline E from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the output joints a thread keeps in registers: V rounded up
__host__ __device__ inline int joints_tile(int V) {
  return V <= 8 ? 8 : V <= 16 ? 16 : V <= 24 ? 24 : 32;
}

__host__ __device__ inline size_t smem_bytes(int V, int subsets, int LT) {
  return sizeof(float) * (size_t)subsets * V * joints_tile(V) * LT;
}

template <int RULE, bool SUBSET, class E, int VT>
__global__ void __launch_bounds__(kThreads, 2)
stage2_kernel(const E* __restrict__ m, const E* __restrict__ x3,
              E* __restrict__ out, int NT, int V, int L, int S, int LT,
              int rows_per_block) {
  extern __shared__ float Ms[];
  // rows per thread: the floor rule also keeps x3's VT joints in registers
  constexpr int R = (RULE == kFloor && VT > 16) ? 1 : 2;
  const int SS = SUBSET ? S : 1;
  const int LO = SUBSET ? L / S : L;  // output channels
  const int c0 = blockIdx.x * LT;     // the tile's first output channel
  const int tid = threadIdx.x;

  // ---- M of the tile, f32: Ms[((s*V + a)*VT + u)*LT + l], a = v or j ----
  for (int idx = tid; idx < SS * V * VT * LT; idx += kThreads) {
    const int l = idx % LT;
    int rest = idx / LT;
    const int u = rest % VT;
    rest /= VT;
    const int a = rest % V, s = rest / V;
    float val = 0.f;
    if (u < V && c0 + l < LO) {
      const int j = RULE == kDiag ? (a - u + V) % V : a;
      val = to_f(m[((size_t)j * V + u) * L + s * LO + c0 + l]);
    }
    Ms[idx] = val;
  }
  __syncthreads();

  const int l = tid % LT, g = tid / LT, G = kThreads / LT;
  const int co = c0 + l;
  if (co >= LO) return;  // no barrier follows
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(NT, r_begin + rows_per_block);
  for (int r = r_begin + g * R; r < r_end; r += G * R) {
    float acc[R][VT];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int u = 0; u < VT; ++u) acc[i][u] = 0.f;
    }
    // a row past the range loads the last row again and is not kept
    const E* xb[R];
#pragma unroll
    for (int i = 0; i < R; ++i) xb[i] = x3 + (size_t)min(r + i, r_end - 1) * V * L + co;
    for (int s = 0; s < SS; ++s) {
      const float* Mb = Ms + (size_t)s * V * VT * LT + l;
      const int off = s * LO;
      if (RULE == kFloor) {
        float xr[R][VT];
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int u = 0; u < VT; ++u) {
            xr[i][u] = u < V ? to_f(xb[i][(size_t)u * L + off]) : 0.f;
          }
        }
        for (int j = 0; j < V; ++j) {
          const float* mv = Mb + j * VT * LT;
#pragma unroll
          for (int u = 0; u < VT; ++u) {
            const float mm = mv[u * LT];
#pragma unroll
            for (int i = 0; i < R; ++i) acc[i][u] = fmaf(mm, xr[i][u], acc[i][u]);
          }
        }
      } else {
#pragma unroll 2
        for (int v = 0; v < V; ++v) {
          float xv[R];
#pragma unroll
          for (int i = 0; i < R; ++i) xv[i] = to_f(xb[i][(size_t)v * L + off]);
          const float* mv = Mb + v * VT * LT;
#pragma unroll
          for (int u = 0; u < VT; ++u) {
            const float mm = mv[u * LT];
#pragma unroll
            for (int i = 0; i < R; ++i) acc[i][u] = fmaf(mm, xv[i], acc[i][u]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (r + i >= r_end) continue;
      E* o = out + (size_t)(r + i) * V * LO + co;
#pragma unroll
      for (int u = 0; u < VT; ++u) {
        if (u < V) o[(size_t)u * LO] = from_f<E>(acc[i][u]);
      }
    }
  }
}

template <int RULE, bool SUBSET, class E, int VT>
int launch(const void* m, const void* x3, void* out, int NT, int V, int L,
           int S, int LT, cudaStream_t stream) {
  const int SS = SUBSET ? S : 1;
  const int LO = SUBSET ? L / S : L;
  const size_t smem = smem_bytes(V, SS, LT);
  auto kernel = stage2_kernel<RULE, SUBSET, E, VT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // row ranges: about four blocks per SM over all channel tiles, each range
  // at least one pass of the block's row groups
  const int tiles = (LO + LT - 1) / LT;
  const int pass = kThreads / LT * 2;
  int chunks = (4 * kSMs + tiles - 1) / tiles;
  const int most = (NT + pass - 1) / pass;
  if (chunks > most) chunks = most;
  if (chunks > 65535) chunks = 65535;
  const int rows_per_block = (NT + chunks - 1) / chunks;
  const dim3 grid(tiles, (NT + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(m), static_cast<const E*>(x3), static_cast<E*>(out),
      NT, V, L, S, LT, rows_per_block);
  return cudaGetLastError();
}

template <int RULE, bool SUBSET, class E>
int launch_vt(const void* m, const void* x3, void* out, int NT, int V, int L,
              int S, int LT, cudaStream_t st) {
  switch (joints_tile(V)) {
    case 8: return launch<RULE, SUBSET, E, 8>(m, x3, out, NT, V, L, S, LT, st);
    case 16: return launch<RULE, SUBSET, E, 16>(m, x3, out, NT, V, L, S, LT, st);
    case 24: return launch<RULE, SUBSET, E, 24>(m, x3, out, NT, V, L, S, LT, st);
    default: return launch<RULE, SUBSET, E, 32>(m, x3, out, NT, V, L, S, LT, st);
  }
}

template <int RULE, class E>
int launch_ss(const void* m, const void* x3, void* out, int NT, int V, int L,
              int subsets, int LT, cudaStream_t st) {
  return subsets > 1 ? launch_vt<RULE, true, E>(m, x3, out, NT, V, L, subsets, LT, st)
                     : launch_vt<RULE, false, E>(m, x3, out, NT, V, L, 1, LT, st);
}

template <class E>
int launch_rule(const void* m, const void* x3, void* out, int NT, int V, int L,
                int rule, int subsets, int LT, cudaStream_t st) {
  switch (rule) {
    case kTile: return launch_ss<kTile, E>(m, x3, out, NT, V, L, subsets, LT, st);
    case kDiag: return launch_ss<kDiag, E>(m, x3, out, NT, V, L, subsets, LT, st);
    default: return launch_ss<kFloor, E>(m, x3, out, NT, V, L, subsets, LT, st);
  }
}

}  // namespace

// The output channels a block owns for (V, L, subsets), or 0 where the
// kernel does not take the shape (V > 32, or M of the smallest tile beyond
// the shared memory): the largest of 32, 16, 8 whose M fits two blocks per
// SM, else the smallest that fits one.
extern "C" int stage2_channel_tile(int V, int L, int subsets) {
  if (V < 1 || V > 32 || L < 1 || subsets < 1 || L % subsets) return 0;
  for (int lt = 32; lt >= 8; lt /= 2) {
    if (smem_bytes(V, subsets, lt) <= (size_t)kSmemTwo) return lt;
  }
  return smem_bytes(V, subsets, 8) <= (size_t)kSmemLimit ? 8 : 0;
}

// m (V,V,L), x3 (N,T,V,L), out (N,T,V,L/subsets): contiguous on the device,
// f32 (dtype 0) or bf16 (dtype 1); rule 0 tile, 1 diagonal, 2 floor;
// subsets 1 (no subset sum) or S with L % S == 0. Launches on `stream` and
// returns cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for what the
// kernel does not take.
extern "C" int stage2_aggregate(const void* m, const void* x3, void* out, int N,
                                int T, int V, int L, int rule, int subsets,
                                int dtype, void* stream) {
  const int LT = stage2_channel_tile(V, L, subsets);
  const long long NT = (long long)N * T;
  if (LT == 0 || N < 1 || T < 1 || NT > 0x7fffffffLL || rule < kTile ||
      rule > kFloor || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_rule<float>(m, x3, out, (int)NT, V, L, rule, subsets, LT, st)
             : launch_rule<__nv_bfloat16>(m, x3, out, (int)NT, V, L, rule, subsets, LT, st);
}
