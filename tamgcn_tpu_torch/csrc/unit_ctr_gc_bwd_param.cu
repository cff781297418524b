// Unit CTR-GC backward, the parameter gradients (K3), for Hopper (sm_90a),
// f32. Its bf16 form is a design of its own (unit_ctr_gc_bwd_param_bf16.cu)
// on the same block split and partials (unit_ctr_gc_param.cuh).
//
// Replaces tamgcn_tpu/ops/pallas/ctr_gc.py:_unit_bwd_param_kernel_flat and
// its schedule variants _unit_bwd_param_kernel_tile (with _param_phase_c),
// _unit_bwd_param_kernel_bcast and _unit_bwd_param_kernel (all launched by
// _unit_param_grads), which compute the same function (docs/KERNELS.md
// "Fully-fused backward"):
//
//   dm_s[n,u,v,c] = sum_t g[n,t,u,c] * x3s[n,t,v,s*C+c]
//   D = tanh(x1s[n,s,u,:] - x2s[n,s,v,:])
//   dA[s,u,v]  = sum_{n,c} dm
//   db4[s,c]   = alpha * sum_{n,u,v} dm
//   dw4[s,r,c] = alpha * sum_{n,u,v} D[..,r] * dm[..,c]
//   dalpha     = sum dm * (D @ w4[s] + b4[s])
//   dpre       = alpha * (dm @ w4[s]^T) * (1 - D^2)
//   dx1s[n,s,u,:] = sum_v dpre,  dx2s[n,s,v,:] = -sum_u dpre
//
// with dm never written to device memory. dA comes out in its natural
// (s, u, v) layout (the TPU kernel returns it transposed).
//
// What bounds it on this card. At the deep NW-UCLA shape (N=16, T=13, V=20,
// C=256, R=32) it reads g and x3s (~17 MB, ~5 us at 3.35 TB/s) and does
// 2*N*S*T*V*V*C + 4*N*S*V*V*R*C ~ 0.75 GFLOP of f32 FMAs (~11 us at
// 67 TFLOP/s): dm, then P = D^T dm and DD = dm w4^T; dalpha reuses P as
// sum w4*P + b4*sum(dm), so it needs no third V*V*R*C product. Its sums span
// more than a block: dm sums over T; DD over all C channels; dx1s and dx2s
// over v and u; dw4, db4, dA and dalpha over samples. dm for a whole (n, s)
// is 410 KB at C=256 (8 MB of D alone at V=256, R=32), more than a block's
// 227 KB of shared memory.
//
// What the design does about it. The work is split over blocks by (sample
// n, subset s, tile of J <= 20 joints u, tile of 16 channels), so that every
// main-path shape at batch 16 launches at least 192 blocks and two or more
// blocks share an SM. A block walks the tiles of J joints v:
//   1. dm of the (u tile, v tile, channel tile) in registers: the block
//      walks T in chunks of 8 frames, staging the chunk's g and x3s tiles in
//      shared memory (8 loads in flight per thread); each thread owns one
//      channel and a 5 x 5 (u, v) tile, 25 FMAs per 10 loads. Then dm goes to shared memory, and D of the two
//      joint tiles is built beside it.
//   2. From the dm tile: dA's channel sum (written to a partial), P += D^T dm
//      and sum(dm) in registers (each thread 4 r x 4 channels over a share of
//      the joint pairs), DD = dm w4^T over the tile's 16 channels, and from
//      it dpre = DD * (1 - D^2): its sum over v accumulates in shared memory
//      (dx1s), its sum over u goes to a partial (dx2s).
// Every sum across blocks is a per-block partial in device memory that a
// second kernel reduces in a fixed order: dx1s over the channel tiles, dx2s
// over the channel and u tiles, dA over samples and channel tiles, dw4 and
// db4 over samples and u tiles; that kernel also forms the per-block sums of
// dalpha = sum w4*P + b4*sum(dm), which the last of its blocks to finish adds
// up in block order. The one atomic only hands out that role (a ticket
// counter); no sum depends on the order in which blocks finish, so two
// launches give bitwise equal gradients. The products run as f32 FFMA on the
// CUDA cores; tensor cores (3xTF32 for f32 accuracy) are left for later
// work.

#include <cuda_runtime.h>

#include "unit_ctr_gc_common.cuh"
#include "unit_ctr_gc_param.cuh"

namespace {

using unit_ctr_gc::Act;
using namespace unit_ctr_gc::param;

constexpr int kThreads = 256;
constexpr int kTC = 8;    // frames per g/x3s chunk in shared memory
constexpr int kBatch = 8;  // loads in flight per thread
constexpr int kRed = 20;  // P (4 x 4) and sum (4) values a thread keeps

// the reduce kernel's outputs (reduce_items), one thread each
__host__ inline int reduce_blocks(int N, int S, int V, int R, int C) {
  return (int)((reduce_items(N, S, V, R, C) + kThreads - 1) / kThreads);
}

// shared memory, in floats: D, DM, the chunk region (g and x3s chunks, then
// the P reduction), W, E, DX1
__host__ __device__ inline int chunk_region(int JP) {
  const int chunks = 2 * kTC * JP * kCT;
  const int red = kThreads * kRed;
  return chunks > red ? chunks : red;
}
__host__ __device__ inline size_t smem_floats(int JP, int RP) {
  const size_t PP = (size_t)JP * JP;
  return PP * RP + PP * kCT + chunk_region(JP) + (size_t)RP * kCT +
         2 * (size_t)JP * RP + (size_t)JP * RP;
}

__device__ inline float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int RP, typename TA>
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_param_kernel(const TA* __restrict__ x1s,
                             const TA* __restrict__ x2s,
                             const TA* __restrict__ g,
                             const TA* __restrict__ x3s,
                             const float* __restrict__ w4s,
                             float* __restrict__ part,
                             unsigned int* __restrict__ done,
                             int N, int S, int T, int V, int R, int C) {
  extern __shared__ float4 smem4[];
  const Tiling tl = tiling(V);
  const int J = tl.J, JP = tl.JP, PP = JP * JP;
  const int KC = channel_tiles(C);
  // D [PP][RP]: tanh(x1_u - x2_v) of the two joint tiles, then dpre
  // DM [PP][kCT]: dm of the tile
  // Gc, Xc [kTC][JP][kCT]: the chunk of g and of x3s's subset s; then the
  // P reduction Red [pair group][role][kRed]
  // W [kCT][RP]: w4s[s] of the channel tile, transposed, so that the 8
  // r-quads a warp reads at one channel are 128 contiguous bytes
  // E [2][JP][RP]: x1/x2 rows
  // DX1 [JP][RP]: sum_v dpre, over the v tiles so far
  float* D = reinterpret_cast<float*>(smem4);
  float* DM = D + PP * RP;
  float* Gc = DM + PP * kCT;
  float* Xc = Gc + kTC * JP * kCT;
  float* Red = Gc;
  float* W = Gc + chunk_region(JP);
  float* E = W + RP * kCT;
  float* DX1 = E + 2 * JP * RP;

  const int ut = blockIdx.x / KC, kc = blockIdx.x % KC;
  const int s = blockIdx.y, n = blockIdx.z;
  const int u0 = ut * J, c0 = kc * kCT;
  const int nu = min(J, V - u0);  // joints of the u tile that exist
  const int tid = threadIdx.x;
  const size_t SC = (size_t)S * C;
  const Parts pt = parts(N, S, V, R, C);

  // the reduce kernel's ticket counter starts at 0
  if (blockIdx.x == 0 && s == 0 && n == 0 && tid == 0) *done = 0;
  for (int i = tid; i < RP * kCT; i += kThreads) {
    const int r = i / kCT, c = i % kCT;
    W[c * RP + r] = (r < R && c0 + c < C) ? w4s[((size_t)s * R + r) * C + c0 + c] : 0.f;
  }
  for (int i = tid; i < JP * RP; i += kThreads) DX1[i] = 0.f;

  // this thread's dm tile: channel c, joints u su*5 .., v sv*5 .. of the
  // tiles; threads past the last tile only stage
  const int c = tid % kCT;
  const int nsub = JP / kJ5;
  const int sub = tid / kCT;
  const bool dm_thread = sub < nsub * nsub;
  const int su = dm_thread ? sub / nsub : 0, sv = dm_thread ? sub % nsub : 0;
  // this thread's role in the P pass: 4 r x 4 channels over a pair group
  constexpr int kNR = (RP / 4) * (kCT / 4);
  constexpr int kG = kThreads / kNR;
  const int role = tid % kNR, pg = tid / kNR;
  const int rq = role / (kCT / 4), cq = role % (kCT / 4);
  float pacc[4][4] = {}, psum[4] = {};
  const int csize = kTC * JP * kCT;

  for (int v0 = 0; v0 < V; v0 += J) {
    const int nv = min(J, V - v0);
    // ---- 1. dm of the tile, in registers ----
    float acc[kJ5][kJ5] = {};
    for (int tb = 0; tb < T; tb += kTC) {
      __syncthreads();  // the previous chunk (or v tile) is consumed
      for (int base = tid; base < csize; base += kThreads * kBatch) {
        float gv[kBatch], xv[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = base + k * kThreads;
          const int cc = i % kCT, rest = i / kCT;
          const int j = rest % JP, t = tb + rest / JP;
          gv[k] = 0.f;
          xv[k] = 0.f;
          if (i < csize && t < T && c0 + cc < C) {
            const size_t row = (size_t)n * T + t;
            if (j < nu) gv[k] = Act<TA>::load(g + (row * V + u0 + j) * C + c0 + cc);
            if (j < nv) {
              xv[k] = Act<TA>::load(x3s + (row * V + v0 + j) * SC + (size_t)s * C + c0 + cc);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = base + k * kThreads;
          if (i < csize) {
            Gc[i] = gv[k];
            Xc[i] = xv[k];
          }
        }
      }
      __syncthreads();
      if (dm_thread) {
#pragma unroll 2
        for (int j = 0; j < kTC; ++j) {
          float gu[kJ5], xw[kJ5];
#pragma unroll
          for (int i = 0; i < kJ5; ++i) {
            gu[i] = Gc[(j * JP + su * kJ5 + i) * kCT + c];
            xw[i] = Xc[(j * JP + sv * kJ5 + i) * kCT + c];
          }
#pragma unroll
          for (int i = 0; i < kJ5; ++i) {
#pragma unroll
            for (int k = 0; k < kJ5; ++k) acc[i][k] = fmaf(gu[i], xw[k], acc[i][k]);
          }
        }
      }
    }
    // DM and E: the previous v tile's last reads of both were before the
    // barriers of this tile's chunk loop
    if (dm_thread) {
#pragma unroll
      for (int i = 0; i < kJ5; ++i) {
#pragma unroll
        for (int k = 0; k < kJ5; ++k) {
          DM[((su * kJ5 + i) * JP + sv * kJ5 + k) * kCT + c] = acc[i][k];
        }
      }
    }
    {
      const TA* x1 = x1s + ((size_t)n * S + s) * V * R;
      const TA* x2 = x2s + ((size_t)n * S + s) * V * R;
      for (int i = tid; i < 2 * JP * RP; i += kThreads) {
        const int r = i % RP, row = i / RP;  // row < JP: x1 of u0 + row
        const bool x1row = row < JP;
        const int j = x1row ? row : row - JP;
        const bool ok = r < R && j < (x1row ? nu : nv);
        E[i] = ok ? Act<TA>::load(x1row ? x1 + (u0 + j) * R + r : x2 + (v0 + j) * R + r) : 0.f;
      }
    }
    __syncthreads();
    // ---- 2. what the dm tile contributes ----
    // D, and dA's channel sum of each existing pair
    for (int i = tid; i < PP * RP; i += kThreads) {
      const int r = i % RP, p = i / RP;
      D[i] = tanhf(E[(p / JP) * RP + r] - E[(JP + p % JP) * RP + r]);
    }
    for (int p = tid; p < PP; p += kThreads) {
      const int iu = p / JP, iv = p % JP;
      if (iu < nu && iv < nv) {
        // from channel p % kCT on, so that a warp's 32 pairs read 16 banks
        float sum = 0.f;
#pragma unroll
        for (int cc = 0; cc < kCT; ++cc) sum += DM[p * kCT + (cc + p) % kCT];
        part[pt.a + (((size_t)n * KC + kc) * S + s) * V * V +
             (size_t)(u0 + iu) * V + v0 + iv] = sum;
      }
    }
    __syncthreads();
    // P[r][c] += sum_p D[p][r] dm[p][c], and sum_p dm[p][c]
    for (int p = pg; p < PP; p += kG) {
      const float4 d = ld4(D + p * RP + 4 * rq);
      const float4 m = ld4(DM + p * kCT + 4 * cq);
      const float dv[4] = {d.x, d.y, d.z, d.w}, mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) pacc[i][k] = fmaf(dv[i], mv[k], pacc[i][k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) psum[k] += mv[k];
    }
    __syncthreads();
    // dpre[p][r] = (sum_c dm[p][c] w4[r][c]) * (1 - D[p][r]^2), over D
    {
      constexpr int kNRQ = RP / 4;
      const int q = tid % kNRQ;
      for (int p = tid / kNRQ; p < PP; p += kThreads / kNRQ) {
        float dd[4] = {};
#pragma unroll
        for (int c4 = 0; c4 < kCT / 4; ++c4) {
          const float4 m = ld4(DM + p * kCT + 4 * c4);
          const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 w = ld4(W + (4 * c4 + k) * RP + 4 * q);
            dd[0] = fmaf(mv[k], w.x, dd[0]);
            dd[1] = fmaf(mv[k], w.y, dd[1]);
            dd[2] = fmaf(mv[k], w.z, dd[2]);
            dd[3] = fmaf(mv[k], w.w, dd[3]);
          }
        }
        float4* dp = reinterpret_cast<float4*>(D + p * RP + 4 * q);
        const float4 d = *dp;
        *dp = make_float4(dd[0] * (1.f - d.x * d.x), dd[1] * (1.f - d.y * d.y),
                          dd[2] * (1.f - d.z * d.z), dd[3] * (1.f - d.w * d.w));
      }
    }
    __syncthreads();
    // dx1: DX1[u][r] += sum_v dpre; dx2: the partial sum_u dpre
    for (int i = tid; i < 2 * JP * RP; i += kThreads) {
      const int r = i % RP, row = i / RP;
      if (r >= R) continue;
      if (row < JP) {
        if (row >= nu) continue;
        float sum = 0.f;
        for (int iv = 0; iv < nv; ++iv) sum += D[(row * JP + iv) * RP + r];
        DX1[row * RP + r] += sum;
      } else {
        const int iv = row - JP;
        if (iv >= nv) continue;
        float sum = 0.f;
        for (int iu = 0; iu < nu; ++iu) sum += D[(iu * JP + iv) * RP + r];
        part[pt.x2 + ((((size_t)n * S + s) * KC + kc) * tl.nt + ut) * V * R +
             (size_t)(v0 + iv) * R + r] = sum;
      }
    }
  }
  __syncthreads();
  // ---- the block's partials of dx1, P and sum(dm) ----
  for (int i = tid; i < nu * R; i += kThreads) {
    const int iu = i / R, r = i % R;
    part[pt.x1 + (((size_t)n * S + s) * KC + kc) * V * R + (size_t)(u0 + iu) * R + r] =
        DX1[iu * RP + r];
  }
  {
    float* mine = Red + (pg * kNR + role) * kRed;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) mine[i * 4 + k] = pacc[i][k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) mine[16 + k] = psum[k];
  }
  __syncthreads();
  float* pP = part + pt.p + (((size_t)n * S + s) * tl.nt + ut) * ((size_t)R * C + C);
  for (int i = tid; i < kNR * kRed; i += kThreads) {
    const int rl = i / kRed, k = i % kRed;
    const int r4 = rl / (kCT / 4), c4 = rl % (kCT / 4);
    float sum = 0.f;
    for (int gi = 0; gi < kG; ++gi) sum += Red[(gi * kNR + rl) * kRed + k];
    if (k < 16) {
      const int r = 4 * r4 + k / 4, cc = c0 + 4 * c4 + k % 4;
      if (r < R && cc < C) pP[(size_t)r * C + cc] = sum;
    } else {
      const int cc = c0 + 4 * c4 + k - 16;
      if (r4 == 0 && cc < C) pP[(size_t)R * C + cc] = sum;
    }
  }
}

// Sums the partials in a fixed order into dx1s, dx2s (times a and -a), dAs,
// dw4s = a * P and db4s = a * sum; and per block, sum of w4 * P + b4 * sum
// (dalpha's terms), which the block that finishes last adds up in block
// order into dalpha. dx1s and dx2s are rounded once to TA.
template <typename TA>
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_param_reduce(const float* __restrict__ part,
                             const float* __restrict__ w4s,
                             const float* __restrict__ b4s,
                             const float* __restrict__ alpha,
                             TA* __restrict__ dx1s, TA* __restrict__ dx2s,
                             float* __restrict__ dw4s, float* __restrict__ db4s,
                             float* __restrict__ dAs,
                             float* __restrict__ dalpha_part,
                             unsigned int* __restrict__ done,
                             float* __restrict__ dalpha,
                             int N, int S, int V, int R, int C) {
  __shared__ float red[kThreads];
  __shared__ bool last;
  const Tiling tl = tiling(V);
  const int KC = channel_tiles(C);
  const Parts pt = parts(N, S, V, R, C);
  const size_t VR = (size_t)V * R, VV = (size_t)V * V, RC = (size_t)R * C;
  const size_t nx = (size_t)N * S * VR;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const float a = alpha[0];
  float term = 0.f;
  if (i < nx) {  // dx1s[ns, u, r] over the channel tiles
    const size_t ns = i / VR, k = i % VR;
    float sum = 0.f;
    for (int kc = 0; kc < KC; ++kc) sum += part[pt.x1 + (ns * KC + kc) * VR + k];
    Act<TA>::store(dx1s + i, a * sum);
  } else if (i < 2 * nx) {  // dx2s[ns, v, r] over the channel and u tiles
    const size_t j = i - nx, ns = j / VR, k = j % VR;
    float sum = 0.f;
    for (int kt = 0; kt < KC * tl.nt; ++kt) {
      sum += part[pt.x2 + (ns * KC * tl.nt + kt) * VR + k];
    }
    Act<TA>::store(dx2s + j, -a * sum);
  } else if (i < 2 * nx + S * VV) {  // dAs[s, u, v] over samples, channel tiles
    const size_t j = i - 2 * nx, s = j / VV, k = j % VV;
    float sum = 0.f;
    for (int n = 0; n < N; ++n) {
      for (int kc = 0; kc < KC; ++kc) {
        sum += part[pt.a + (((size_t)n * KC + kc) * S + s) * VV + k];
      }
    }
    dAs[j] = sum;
  } else if (i < 2 * nx + S * VV + S * (RC + C)) {  // dw4s, db4s
    const size_t j = i - 2 * nx - S * VV, s = j / (RC + C), k = j % (RC + C);
    float sum = 0.f;
    for (int n = 0; n < N; ++n) {
      for (int ut = 0; ut < tl.nt; ++ut) {
        sum += part[pt.p + (((size_t)n * S + s) * tl.nt + ut) * (RC + C) + k];
      }
    }
    if (k < RC) {
      dw4s[s * RC + k] = a * sum;
      term = w4s[s * RC + k] * sum;
    } else {
      db4s[s * C + k - RC] = a * sum;
      term = b4s[s * C + k - RC] * sum;
    }
  }
  red[threadIdx.x] = term;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    dalpha_part[blockIdx.x] = red[0];
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every block's partial is written: each thread sums a fixed, strided set
  // of them (read past L1), then the same tree as above
  float sum = 0.f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    sum += __ldcg(dalpha_part + b);
  }
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dalpha[0] = red[0];
}

template <int RP, typename TA>
int launch(const TA* x1s, const TA* x2s, const TA* g, const TA* x3s,
           const float* w4s, const float* b4s, const float* alpha, TA* dx1s,
           TA* dx2s, float* dw4s, float* db4s, float* dalpha, float* dAs,
           float* scratch, int N, int S, int T, int V, int R, int C,
           cudaStream_t stream) {
  const Tiling tl = tiling(V);
  const size_t smem = sizeof(float) * smem_floats(tl.JP, RP);
  cudaError_t err = cudaFuncSetAttribute(
      unit_ctr_gc_bwd_param_kernel<RP, TA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nb = reduce_blocks(N, S, V, R, C);
  const Parts pt = parts(N, S, V, R, C);
  float* dalpha_part = scratch + pt.end;
  unsigned int* done = reinterpret_cast<unsigned int*>(dalpha_part + nb);
  const dim3 grid(tl.nt * channel_tiles(C), S, N);
  unit_ctr_gc_bwd_param_kernel<RP, TA><<<grid, kThreads, smem, stream>>>(
      x1s, x2s, g, x3s, w4s, scratch, done, N, S, T, V, R, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  unit_ctr_gc_bwd_param_reduce<TA><<<nb, kThreads, 0, stream>>>(
      scratch, w4s, b4s, alpha, dx1s, dx2s, dw4s, db4s, dAs, dalpha_part, done,
      dalpha, N, S, V, R, C);
  return cudaGetLastError();
}

template <typename TA>
int param(const TA* x1s, const TA* x2s, const TA* g, const TA* x3s,
          const float* w4s, const float* b4s, const float* alpha, TA* dx1s,
          TA* dx2s, float* dw4s, float* db4s, float* dalpha, float* dAs,
          float* scratch, int N, int S, int T, int V, int R, int C,
          void* stream) {
  if (N < 1 || N > 65535 || S < 1 || S > 65535 || T < 1 || V < 1 || R < 1 ||
      C < 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TAMGCN_LAUNCH(RP)                                                      \
  launch<RP>(x1s, x2s, g, x3s, w4s, b4s, alpha, dx1s, dx2s, dw4s, db4s,       \
             dalpha, dAs, scratch, N, S, T, V, R, C, st)
  if (R <= 8) return TAMGCN_LAUNCH(8);
  if (R <= 16) return TAMGCN_LAUNCH(16);
  if (R <= 32) return TAMGCN_LAUNCH(32);
#undef TAMGCN_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of device scratch that unit_ctr_gc_bwd_param_f32 needs.
extern "C" long long unit_ctr_gc_bwd_param_scratch_floats(int N, int S, int V,
                                                          int R, int C) {
  // the partials, the per-block dalpha terms, the ticket counter
  return (long long)parts(N, S, V, R, C).end + reduce_blocks(N, S, V, R, C) + 1;
}

// Blocks of the first kernel that unit_ctr_gc_bwd_param_f32 (and
// unit_ctr_gc_bwd_param_bf16.cu's, on the same block split) launches.
extern "C" long long unit_ctr_gc_bwd_param_blocks(int N, int S, int V, int C) {
  return (long long)tiling(V).nt * channel_tiles(C) * S * N;
}

// All tensors contiguous f32 on the device: x1s, x2s (N,S,V,R); g (N,T,V,C);
// x3s (N,T,V,S*C); w4s (S,R,C); b4s (S,C); alpha (1,) -> dx1s, dx2s
// (N,S,V,R); dw4s (S,R,C); db4s (S,C); dalpha (1,); dAs (S,V,V); scratch of
// unit_ctr_gc_bwd_param_scratch_floats(N, S, V, R, C) floats; R <= 32, any V
// and C. Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int unit_ctr_gc_bwd_param_f32(
    const float* x1s, const float* x2s, const float* g, const float* x3s,
    const float* w4s, const float* b4s, const float* alpha, float* dx1s,
    float* dx2s, float* dw4s, float* db4s, float* dalpha, float* dAs,
    float* scratch, int N, int S, int T, int V, int R, int C, void* stream) {
  return param(x1s, x2s, g, x3s, w4s, b4s, alpha, dx1s, dx2s, dw4s, db4s,
               dalpha, dAs, scratch, N, S, T, V, R, C, stream);
}
