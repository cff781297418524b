// Stage-2 aggregation from a given M (T2) for Hopper (sm_90a), f32 or bf16.
//
// Replaces the stage-2 probes of tools/exp_stage2.py (_floor_kernel,
// _win_kernel, _tile_kernel, _flat_kernel) and tools/exp_stage2b.py
// (_tile_kernel, f32 and bf16). With M (V, V, L) shared by the whole batch
// and x3 (N, T, V, L):
//
//   out[n,t,u,l] = sum_j M[j,u,l] * x3[n,t,v(j,u),l]
//
//   kTile   v = j           (M laid out (v, u, l))
//   kDiag   v = (u+j) mod V (M holds the diagonals; the win and flat forms)
//   kFloor  v = u           (x3's joint pinned to u: (sum_j M[j,u,l]) * x3)
//
// and with the subset sum (L = S*C) out[n,t,u,c] = sum_s acc[n,t,u,s*C+c].
// Products and sums are f32 whatever the element type; the output is
// rounded once to it.
//
// What bounds it on this card. At the tools' shape (N=64, T=13, V=20,
// L=768) it moves 103 MB in f32 (x3 in and out once, M once: 31 us at
// 3.35 TB/s; 21 us with the subset sum) and does 0.26 G FMAs (8 us at the
// f32 peak): the bytes bound it, so the design streams x3.
//
// What the design does about it.
// - tile and diag (stage2_kernel): persistent blocks, one or two an SM,
//   each owning a tile of LT output channels (32 where M fits) and a range
//   of row groups. M of the tile is staged once per block by cp.async, in
//   the element type, laid out [subset][v][u (padded to VT)][channel] with
//   the diagonal rule resolved while staging. Each warp then walks its own
//   row groups through its own ring of stages in shared memory: a stage
//   holds R rows of each lane group times VC source joints of one subset,
//   filled by 16-byte cp.async along the channel axis (8- and 4-byte copies
//   where the strides or data_ptr are not 16-byte aligned; plain 2-byte
//   loads for bf16 that is not even 4-byte aligned), two to seven stages in
//   flight while the warp multiplies the current one (64 KB an SM at the
//   tools' shape in f32, the most that M of 32 channels leaves two blocks).
//   No block barrier follows M's staging; a warp syncs with itself.
//   A lane owns one channel and R rows (R * VT <= 80 accumulators in
//   registers: every output joint of R rows); per source joint it reads R
//   x3 values and, per output joint, one M value for R FMAs. Output joints
//   past V are skipped four at a time. The stores run along the channel
//   axis, a warp's 32 lanes writing 128 contiguous bytes (a cache line).
// - floor (stage2_kernel_floor): the rule is (sum_j M[j,u,l]) * x3[n,t,u,l],
//   so a block sums M over j once for its columns (into shared memory, one
//   value per subset and column) and streams its rows: 16-byte loads and
//   stores of x3 and out, 32 values in flight a thread and three blocks an
//   SM, one multiply per output and subset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemLimit = 232448;   // bytes a block may use on sm_90
constexpr int kSmemTwo = 113 * 1024;  // two blocks per SM
constexpr int kSMs = 132;
constexpr int kMaxStages = 8;
constexpr int kTile = 0, kDiag = 1, kFloor = 2;
// rows in flight per thread of the floor kernel: 32 values (128 bytes in
// f32, 64 in bf16; 16 rows of scalars)
__host__ __device__ constexpr int floor_rows(int U) { return U == 1 ? 16 : 32 / U; }

__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <class E> __device__ inline E from_f(float x);
template <> __device__ inline float from_f<float>(float x) { return x; }
template <> __device__ inline __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the output joints a lane keeps in registers (V rounded up: 20 for
// NW-UCLA, 28 for NTU's 25), its rows R (R * VT <= 80 accumulators: more
// spill at 128 registers a thread) and the source joints VC of one stage
// (32 * R * VC ~ 512 elements: smaller stages, in deeper rings, were slower)
__host__ __device__ constexpr int joints_tile(int V) {
  return V <= 8 ? 8 : V <= 16 ? 16 : V <= 20 ? 20 : V <= 28 ? 28 : 32;
}
__host__ __device__ constexpr int lane_rows(int VT) {
  return VT == 8 ? 8 : VT == 16 ? 5 : VT == 20 ? 4 : 2;
}
__host__ __device__ constexpr int stage_joints(int VT) {
  return VT == 8 ? 2 : VT == 16 ? 3 : VT == 20 ? 4 : 8;
}
__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// shared memory of stage2_kernel: M of the tile, then the warps' rings
__host__ __device__ inline size_t m_bytes(int SS, int V, int LT, int esz) {
  return round16((size_t)SS * V * joints_tile(V) * LT * esz);
}
__host__ __device__ inline size_t ring_bytes(int V, int stages, int esz) {
  const int VT = joints_tile(V);
  return (size_t)kWarps * stages * 32 * lane_rows(VT) * stage_joints(VT) * esz;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ inline void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most n - 1 committed groups of this thread are in flight
__device__ inline void wait_stages(int n) {
  switch (n) {
    case 2: wait_groups<1>(); break;
    case 3: wait_groups<2>(); break;
    case 4: wait_groups<3>(); break;
    case 5: wait_groups<4>(); break;
    case 6: wait_groups<5>(); break;
    case 7: wait_groups<6>(); break;
    default: wait_groups<7>(); break;
  }
}

// W bytes from src to dst (zero where !ok; src must then still be a valid
// address): cp.async of 16, 8 or 4 bytes, or for W = 2 (a bf16 value) a
// plain load and store
template <int W, class E>
__device__ inline void copy_unit(E* dst, const E* src, bool ok) {
  if constexpr (W == 2) {
    *dst = ok ? *src : from_f<E>(0.f);
  } else if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(W), "r"(ok ? W : 0));
  }
}

// M of the block's channel tile into Ms[((s*V + a)*VT + u)*LT + l], a = v
// (tile rule, a = j) or the x3 joint of the diagonal rule, zero for u >= V
// and past the output channels; W-byte units along l, all threads
template <int W, class E>
__device__ inline void stage_m(E* Ms, const E* __restrict__ m, int SS, int V, int VT, int L,
                               int LO, int LT, int c0, int rule) {
  constexpr int U = W / (int)sizeof(E);
  const int units = SS * V * VT * LT / U;
  for (int i = threadIdx.x; i < units; i += kThreads) {
    const int l = (i % (LT / U)) * U;
    int rest = i / (LT / U);
    const int u = rest % VT;
    rest /= VT;
    const int a = rest % V, s = rest / V;
    const int j = rule == kDiag ? (a - u + V) % V : a;
    const bool ok = u < V && c0 + l < LO;
    copy_unit<W>(Ms + (size_t)i * U, ok ? m + ((size_t)j * V + u) * L + s * LO + c0 + l : m, ok);
  }
}

// one stage of a warp: x3 of rows row0 + h*R + k (lane group h = lane / LT,
// k < R), source joints j0 .. j0 + VC, channels s*LO + c0 + l, into
// st[(v*R + k)*32 + h*LT + l]; zero past the rows, joints and channels
template <int W, class E, int R, int VC>
__device__ inline void stage_x(E* st, const E* __restrict__ x3, int lane, int row0, int NT,
                               int V, int L, int LO, int LT, int c0, int s, int j0) {
  constexpr int U = W / (int)sizeof(E);
  constexpr int units = 32 * R * VC / U;
  for (int i = lane; i < units; i += 32) {
    const int l4 = (i % (32 / U)) * U;
    const int rest = i / (32 / U);
    const int k = rest % R, v = rest / R;
    const int h = l4 / LT, l = l4 % LT;
    const int row = row0 + h * R + k, j = j0 + v;
    const bool ok = row < NT && j < V && c0 + l < LO;
    copy_unit<W>(st + (size_t)i * U,
                 ok ? x3 + ((size_t)row * V + j) * L + s * LO + c0 + l : x3, ok);
  }
}

template <class E, int R, int VC>
__device__ inline void stage_x_w(int w, E* st, const E* __restrict__ x3, int lane, int row0,
                                 int NT, int V, int L, int LO, int LT, int c0, int s, int j0) {
  switch (w) {
    case 16: stage_x<16, E, R, VC>(st, x3, lane, row0, NT, V, L, LO, LT, c0, s, j0); break;
    case 8: stage_x<8, E, R, VC>(st, x3, lane, row0, NT, V, L, LO, LT, c0, s, j0); break;
    case 4: stage_x<4, E, R, VC>(st, x3, lane, row0, NT, V, L, LO, LT, c0, s, j0); break;
    default:
      if constexpr (sizeof(E) == 2) {
        stage_x<2, E, R, VC>(st, x3, lane, row0, NT, V, L, LO, LT, c0, s, j0);
      }
  }
}

// tile and diagonal rules. Block (channel tile, chunk of row groups); LT_T
// the channel tile at compile time (32), or 0 for LT given at run time.
// wx, wm: copy widths in bytes of x3 and m; stages: the depth of each
// warp's ring.
template <bool SUBSET, class E, int VT, int LT_T>
__global__ void __launch_bounds__(kThreads, 2)
stage2_kernel(const E* __restrict__ m, const E* __restrict__ x3, E* __restrict__ out, int NT,
              int V, int L, int S, int lt, int rule, int groups_per_block, int stages, int wx,
              int wm) {
  constexpr int R = lane_rows(VT), VC = stage_joints(VT);
  constexpr int STAGE = 32 * R * VC;  // elements of one stage
  extern __shared__ __align__(16) unsigned char smem[];
  const int LT = LT_T ? LT_T : lt;
  const int SS = SUBSET ? S : 1;
  const int LO = SUBSET ? L / S : L;
  const int c0 = blockIdx.x * LT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  E* Ms = reinterpret_cast<E*>(smem);
  E* ring = reinterpret_cast<E*>(smem + m_bytes(SS, V, LT, sizeof(E))) + warp * stages * STAGE;

  const int RW = 32 / LT * R;  // rows of a row group
  const int G = (NT + RW - 1) / RW;
  const int g_begin = blockIdx.y * groups_per_block + warp;
  const int g_end = min(G, (blockIdx.y + 1) * groups_per_block);
  const int mine = g_begin < g_end ? (g_end - g_begin + kWarps - 1) / kWarps : 0;
  const int chunks = (V + VC - 1) / VC;
  const int total = mine * SS * chunks;  // stages of this warp

  // a stage is (row group gi of this warp, subset s, joint chunk vc); the
  // copy cursor runs stages - 1 ahead of the compute cursor, both advanced
  // by increments, without a division per stage
  struct Cursor {
    int gi = 0, s = 0, vc = 0, slot = 0;
  };
  auto advance = [&](Cursor& c) {
    if (++c.vc == chunks) {
      c.vc = 0;
      if (++c.s == SS) c.s = 0, ++c.gi;
    }
    c.slot = c.slot + 1 == stages ? 0 : c.slot + 1;
  };
  Cursor in, cur;
  auto issue = [&]() {  // one commit group per stage, empty past the last
    if (in.gi < mine) {
      stage_x_w<E, R, VC>(wx, ring + in.slot * STAGE, x3, lane,
                          (g_begin + in.gi * kWarps) * RW, NT, V, L, LO, LT, c0, in.s,
                          in.vc * VC);
    }
    commit();
    advance(in);
  };

  switch (wm) {
    case 16: stage_m<16>(Ms, m, SS, V, VT, L, LO, LT, c0, rule); break;
    case 8: stage_m<8>(Ms, m, SS, V, VT, L, LO, LT, c0, rule); break;
    case 4: stage_m<4>(Ms, m, SS, V, VT, L, LO, LT, c0, rule); break;
    default:
      if constexpr (sizeof(E) == 2) stage_m<2>(Ms, m, SS, V, VT, L, LO, LT, c0, rule);
  }
  commit();
  for (int q = 0; q < stages - 1; ++q) issue();
  wait_stages(stages);  // M's group is in; the first stages may still fly
  __syncthreads();      // M from every thread; no block barrier follows

  const int h = lane / LT, l = lane % LT;
  const int co = c0 + l;
  float acc[R][VT];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int u = 0; u < VT; ++u) acc[k][u] = 0.f;

  for (int q = 0; q < total; ++q) {
    issue();              // into the slot consumed at q - 1
    wait_stages(stages);  // stage q is in (this lane's copies)
    __syncwarp();         // and every lane's
    const E* st = ring + cur.slot * STAGE + lane;
#pragma unroll
    for (int v = 0; v < VC; ++v) {
      const int j = cur.vc * VC + v;
      if (j < V) {
        float xv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) xv[k] = to_f(st[(v * R + k) * 32]);
        const E* mr = Ms + ((size_t)(cur.s * V + j) * VT) * LT + l;
#pragma unroll
        for (int u0 = 0; u0 < VT; u0 += 4) {
          if (u0 >= V) break;
#pragma unroll
          for (int u = u0; u < u0 + 4; ++u) {
            const float mm = to_f(mr[u * LT]);
#pragma unroll
            for (int k = 0; k < R; ++k) acc[k][u] = fmaf(mm, xv[k], acc[k][u]);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
    if (cur.s == SS - 1 && cur.vc == chunks - 1) {
      // the row group is done: store its rows and start the next
      const int row0 = (g_begin + cur.gi * kWarps) * RW + h * R;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (row0 + k < NT && co < LO) {
          E* o = out + (size_t)(row0 + k) * V * LO + co;
#pragma unroll
          for (int u = 0; u < VT; ++u) {
            if (u < V) o[(size_t)u * LO] = from_f<E>(acc[k][u]);
          }
        }
#pragma unroll
        for (int u = 0; u < VT; ++u) acc[k][u] = 0.f;
      }
    }
    advance(cur);
  }
  wait_groups<0>();  // no copy outlives the block
}

// the floor rule: block (column chunk, row chunk); a thread owns U
// consecutive output columns q = u*LO + c of a row (U = 1, or 16 bytes of
// elements where the strides and pointers allow), sums M over j for them
// once per subset into Msum[s][thread][U], then walks the rows
template <class E, int U>
__global__ void __launch_bounds__(kThreads, 3)
stage2_kernel_floor(const E* __restrict__ m, const E* __restrict__ x3, E* __restrict__ out,
                    int NT, int V, int L, int SS, int rows_per_block) {
  constexpr int FR = floor_rows(U);
  extern __shared__ float Msum[];
  const int LO = L / SS, Q = V * LO;
  const int q0 = (blockIdx.x * blockDim.x + threadIdx.x) * U;
  if (q0 >= Q) return;  // no barrier follows
  const int u = q0 / LO, c = q0 % LO;
  float* ms = Msum + threadIdx.x * U;
  const size_t sstride = (size_t)blockDim.x * U;
  auto load = [&](const E* p, float (&v)[U]) {
    if constexpr (U == 1) {
      v[0] = to_f(*p);
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
      for (int i = 0; i < U; ++i) v[i] = to_f(e[i]);
    }
  };
  for (int s = 0; s < SS; ++s) {
    float sum[U];
#pragma unroll
    for (int i = 0; i < U; ++i) sum[i] = 0.f;
#pragma unroll 8
    for (int j = 0; j < V; ++j) {  // the loads of 8 joints in flight at once
      float v[U];
      load(m + ((size_t)j * V + u) * L + s * LO + c, v);
#pragma unroll
      for (int i = 0; i < U; ++i) sum[i] += v[i];
    }
#pragma unroll
    for (int i = 0; i < U; ++i) ms[s * sstride + i] = sum[i];
  }
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(NT, r_begin + rows_per_block);
  for (int r = r_begin; r < r_end; r += FR) {
    float acc[FR][U];
#pragma unroll
    for (int k = 0; k < FR; ++k)
#pragma unroll
      for (int i = 0; i < U; ++i) acc[k][i] = 0.f;
    for (int s = 0; s < SS; ++s) {
      float xv[FR][U];
#pragma unroll
      for (int k = 0; k < FR; ++k) {
        if (r + k < r_end) {
          load(x3 + ((size_t)(r + k) * V + u) * L + s * LO + c, xv[k]);
        } else {
#pragma unroll
          for (int i = 0; i < U; ++i) xv[k][i] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < FR; ++k)
#pragma unroll
        for (int i = 0; i < U; ++i) acc[k][i] = fmaf(ms[s * sstride + i], xv[k][i], acc[k][i]);
    }
#pragma unroll
    for (int k = 0; k < FR; ++k) {
      if (r + k >= r_end) continue;
      E* o = out + (size_t)(r + k) * Q + q0;
      if constexpr (U == 1) {
        o[0] = from_f<E>(acc[k][0]);
      } else {
        uint4 raw;
        E* e = reinterpret_cast<E*>(&raw);
#pragma unroll
        for (int i = 0; i < U; ++i) e[i] = from_f<E>(acc[k][i]);
        *reinterpret_cast<uint4*>(o) = raw;
      }
    }
  }
}

// the widest copy (16, 8, 4 bytes; 2 for a bf16 value) that the pointer,
// the row stride L, the subset offset LO and the channel tile LT allow
inline int copy_width(const void* p, int L, int LO, int LT, int esz) {
  for (int w = 16; w >= 4; w /= 2) {
    if ((uintptr_t)p % w == 0 && (size_t)L * esz % w == 0 && (size_t)LO * esz % w == 0 &&
        LT * esz >= w) {
      return w;
    }
  }
  return esz == 2 ? 2 : 4;
}

struct Plan {
  int lt = 0, stages = 0, blocks_per_sm = 0;
  size_t smem = 0;
};

// stage2_kernel's channel tile, ring depth and blocks an SM for (V, SS, LO
// output channels, element size), the first that fits: two blocks an SM
// with a channel tile of 32, then 16, and the deepest ring of 3 to
// kMaxStages stages; else one block with a tile of 32, 16, 8, 4 and such a
// ring; else one block with a ring of 2. lt = 0 where nothing fits.
inline Plan plan(int V, int SS, int LO, int esz) {
  Plan p;
  const int want = LO >= 32 ? 32 : LO >= 16 ? 16 : LO >= 8 ? 8 : 4;
  auto fits = [&](int bps, int lt, int st) {
    const size_t smem = m_bytes(SS, V, lt, esz) + ring_bytes(V, st, esz);
    if (smem > (size_t)(bps == 2 ? kSmemTwo : kSmemLimit)) return false;
    p.lt = lt, p.stages = st, p.blocks_per_sm = bps, p.smem = smem;
    return true;
  };
  for (int lt = want; lt >= 16; lt /= 2) {
    for (int st = kMaxStages; st >= 3; --st) {
      if (fits(2, lt, st)) return p;
    }
  }
  for (int lowest = 3; lowest >= 2; --lowest) {
    for (int lt = want; lt >= 4; lt /= 2) {
      for (int st = lowest == 3 ? kMaxStages : 2; st >= lowest; --st) {
        if (fits(1, lt, st)) return p;
      }
    }
  }
  return Plan{};
}

template <bool SUBSET, class E, int VT, int LT_T>
int launch_tile(const void* m, const void* x3, void* out, int NT, int V, int L, int S,
                int rule, const Plan& p, cudaStream_t stream) {
  const int SS = SUBSET ? S : 1, LO = L / SS;
  auto kernel = stage2_kernel<SUBSET, E, VT, LT_T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  const int esz = sizeof(E);
  const int tiles = (LO + p.lt - 1) / p.lt;
  const int RW = 32 / p.lt * lane_rows(VT);
  const int G = (NT + RW - 1) / RW;
  // persistent blocks: as many as run at once, at most one per row group
  int chunks = kSMs * p.blocks_per_sm / tiles;
  chunks = max(1, min(chunks, (G + kWarps - 1) / kWarps));
  chunks = min(chunks, 65535);
  const int groups_per_block = (G + chunks - 1) / chunks;
  const dim3 grid(tiles, (G + groups_per_block - 1) / groups_per_block);
  kernel<<<grid, kThreads, p.smem, stream>>>(
      static_cast<const E*>(m), static_cast<const E*>(x3), static_cast<E*>(out), NT, V, L, S,
      p.lt, rule, groups_per_block, p.stages, copy_width(x3, L, LO, p.lt, esz),
      copy_width(m, L, LO, p.lt, esz));
  return cudaGetLastError();
}

template <bool SUBSET, class E>
int launch_vt(const void* m, const void* x3, void* out, int NT, int V, int L, int S, int rule,
              cudaStream_t st) {
  const Plan p = plan(V, SUBSET ? S : 1, SUBSET ? L / S : L, sizeof(E));
  if (p.lt == 0) return cudaErrorInvalidValue;
#define STAGE2_VT(VT)                                                                \
  return p.lt == 32 ? launch_tile<SUBSET, E, VT, 32>(m, x3, out, NT, V, L, S, rule, p, st) \
                    : launch_tile<SUBSET, E, VT, 0>(m, x3, out, NT, V, L, S, rule, p, st)
  switch (joints_tile(V)) {
    case 8: STAGE2_VT(8);
    case 16: STAGE2_VT(16);
    case 20: STAGE2_VT(20);
    case 28: STAGE2_VT(28);
    default: STAGE2_VT(32);
  }
#undef STAGE2_VT
}

// the floor kernel's threads a block and the bytes of Msum: 256 threads,
// fewer where SS subsets of Msum do not fit (0 where 32 do not)
inline int floor_threads(int SS, int U) {
  for (int t = kThreads; t >= 32; t /= 2) {
    if ((size_t)SS * t * U * sizeof(float) <= (size_t)kSmemLimit) return t;
  }
  return 0;
}

template <class E, int U>
int launch_floor_u(const void* m, const void* x3, void* out, int NT, int V, int L, int SS,
                   cudaStream_t stream) {
  const int threads = floor_threads(SS, U);
  if (threads == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)SS * threads * U * sizeof(float);
  auto kernel = stage2_kernel_floor<E, U>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long Q = (long long)V * (L / SS);
  const int cols = (int)((Q + (long long)threads * U - 1) / ((long long)threads * U));
  // three blocks of 256 threads an SM in all (the bytes in flight the
  // memory needs), each at least a batch of rows
  int chunks = max(1, 3 * kSMs * (kThreads / threads) / cols);
  chunks = min(chunks, max(1, (NT + floor_rows(U) - 1) / floor_rows(U)));
  chunks = min(chunks, 65535);
  const int rows_per_block = (NT + chunks - 1) / chunks;
  const dim3 grid(cols, (NT + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const E*>(m), static_cast<const E*>(x3),
                                          static_cast<E*>(out), NT, V, L, SS, rows_per_block);
  return cudaGetLastError();
}

template <class E>
int launch_floor(const void* m, const void* x3, void* out, int NT, int V, int L, int SS,
                 cudaStream_t st) {
  constexpr int U = 16 / sizeof(E);
  const int LO = L / SS;
  const bool vec = (uintptr_t)m % 16 == 0 && (uintptr_t)x3 % 16 == 0 &&
                   (uintptr_t)out % 16 == 0 && L % U == 0 && LO % U == 0 &&
                   floor_threads(SS, U) > 0;
  return vec ? launch_floor_u<E, U>(m, x3, out, NT, V, L, SS, st)
             : launch_floor_u<E, 1>(m, x3, out, NT, V, L, SS, st);
}

template <class E>
int launch_rule(const void* m, const void* x3, void* out, int NT, int V, int L, int rule,
                int subsets, cudaStream_t st) {
  if (rule == kFloor) return launch_floor<E>(m, x3, out, NT, V, L, subsets, st);
  return subsets > 1 ? launch_vt<true, E>(m, x3, out, NT, V, L, subsets, rule, st)
                     : launch_vt<false, E>(m, x3, out, NT, V, L, 1, rule, st);
}

}  // namespace

// The output channels a block of the tile and diagonal rules owns for (V,
// L, subsets) in f32 (the larger element size), or 0 where the kernel does
// not take the shape (V > 32, or M of a 4-channel tile and the shallowest
// ring beyond a block's shared memory).
extern "C" int stage2_channel_tile(int V, int L, int subsets) {
  if (V < 1 || V > 32 || L < 1 || subsets < 1 || L % subsets) return 0;
  return plan(V, subsets, L / subsets, sizeof(float)).lt;
}

// m (V,V,L), x3 (N,T,V,L), out (N,T,V,L/subsets): contiguous on the device,
// f32 (dtype 0) or bf16 (dtype 1), any alignment of the element type; rule
// 0 tile, 1 diagonal, 2 floor; subsets 1 (no subset sum) or S with L % S ==
// 0. Launches on `stream` and returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int stage2_aggregate(const void* m, const void* x3, void* out, int N, int T, int V,
                                int L, int rule, int subsets, int dtype, void* stream) {
  const long long NT = (long long)N * T;
  if (stage2_channel_tile(V, L, subsets) == 0 || N < 1 || T < 1 || NT > 0x7fffffffLL ||
      rule < kTile || rule > kFloor || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_rule<float>(m, x3, out, (int)NT, V, L, rule, subsets, st)
             : launch_rule<__nv_bfloat16>(m, x3, out, (int)NT, V, L, rule, subsets, st);
}
