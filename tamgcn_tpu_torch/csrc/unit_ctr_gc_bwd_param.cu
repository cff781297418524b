// Unit CTR-GC backward, the parameter gradients (K3), for Hopper (sm_90a),
// f32.
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
// 67 TFLOP/s): dm, then D^T dm and dm w4^T; dalpha reuses P = D^T dm, so
// it needs no third V*V*R*C product. Its reductions span more than one block holds: dm sums over
// T; dpre needs dm @ w4^T summed over all C channels (V*V*R floats, 51 KB at
// R=32); dw4/db4/dA/dalpha sum over samples; and dm for a whole (n, s) is
// 410 KB at C=256, more than a block's 227 KB of shared memory.
//
// What the design does about it. One block of 256 threads per (subset s,
// sample n). It keeps D = tanh(x1_u - x2_v) and DD = dm @ w4^T (V*V*R floats
// each) and the dA row sums in shared memory, and loops over channel tiles
// of CT=16 (8 where 16 does not fit):
//   1. dm of the tile, V*V*CT floats in shared memory: the block walks T in
//      chunks of 8 frames, copying the chunk's g and x3s tiles into shared
//      memory (8 loads in flight per thread); each thread owns one channel
//      and a 5 x 5 register tile of (u, v), 25 FMAs per 10 loads;
//   2. from the dm tile: the dA row sums, the per-sample dw4/alpha
//      (P = D^T dm) and db4/alpha (sum over u, v) partials, written to a
//      scratch buffer, and DD += dm @ w4^T.
// Then the block writes dx1s/dx2s directly. A second kernel reduces the
// per-sample partials over N in a fixed order and forms dw4, db4, dA and the
// per-block sums of dalpha = sum w4*P + b4*sum(dm); the last of its blocks to
// finish adds those up in block order. The one atomic only hands out that
// role (a ticket counter); no sum depends on the order in which blocks
// finish, so two launches give bitwise equal gradients.
// This launches only N*S blocks (48 at batch 16): tensor cores for the
// D^T dm and dm w4^T products and a split of the channels across blocks are
// left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kJ = 5;  // joints per side of a thread's (u, v) tile
constexpr int kTC = 8;  // frames per g/x3s chunk in shared memory
constexpr int kBatch = 8;  // loads in flight per thread
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

// per-sample partials of one (n, s), in floats: dA [V*V], P [R][C], sum [C]
__host__ __device__ inline size_t per_sample(int V, int R, int C) {
  return (size_t)V * V + (size_t)R * C + C;
}

__host__ inline int reduce_blocks(int S, int V, int R, int C) {
  return (int)((S * per_sample(V, R, C) + kThreads - 1) / kThreads);
}

// shared memory, in floats
__host__ __device__ inline size_t smem_floats(int V, int VP, int RP, int CT) {
  const size_t VV = (size_t)V * V;
  return 2 * VV * RP              // D, DD
         + VV * (CT + 1)          // DM
         + 2 * (size_t)kTC * VP * CT  // g and x3s chunks
         + (size_t)RP * (CT + 1)  // W
         + 2 * (size_t)V * RP     // E
         + VV;                    // DA
}

template <int RP>
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_param_kernel(const float* __restrict__ x1s,
                             const float* __restrict__ x2s,
                             const float* __restrict__ g,
                             const float* __restrict__ x3s,
                             const float* __restrict__ w4s,
                             const float* __restrict__ alpha,
                             float* __restrict__ dx1s,
                             float* __restrict__ dx2s,
                             float* __restrict__ part,
                             unsigned int* __restrict__ done,
                             int S, int T, int V, int R, int C, int CT, int VP) {
  extern __shared__ float4 smem4[];
  const int VV = V * V;
  const int CTP = CT + 1;  // row stride of DM and W: a warp's column reads
                           // from 32 rows fall in distinct banks
  // D [V*V][RP]: tanh(x1_u - x2_v); DD [V*V][RP]: sum_c dm * w4
  // DM [V*V][CTP]: dm of the channel tile
  // Gc, Xc [kTC][VP][CT]: the chunk of g and of x3s's subset s, joints padded
  // W [RP][CTP]: w4s[s] of the channel tile; E [2][V][RP]: x1/x2 rows
  // DA [V*V]: sum_c dm, over the tiles so far
  float* D = reinterpret_cast<float*>(smem4);
  float* DD = D + VV * RP;
  float* DM = DD + VV * RP;
  float* Gc = DM + VV * CTP;
  float* Xc = Gc + kTC * VP * CT;
  float* W = Xc + kTC * VP * CT;
  float* E = W + RP * CTP;
  float* DA = E + 2 * V * RP;

  const int s = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = alpha[0];
  const size_t SC = (size_t)S * C;
  float* pA = part + ((size_t)n * S + s) * per_sample(V, R, C);
  float* pP = pA + VV;
  float* pSum = pP + (size_t)R * C;

  // the reduce kernel's ticket counter starts at 0
  if (s == 0 && n == 0 && tid == 0) *done = 0;
  // ---- D, and zeroed DD and DA ----
  {
    const float* x1 = x1s + ((size_t)n * S + s) * V * R;
    const float* x2 = x2s + ((size_t)n * S + s) * V * R;
    for (int i = tid; i < 2 * V * RP; i += kThreads) {
      const int r = i % RP, row = i / RP;  // row < V: x1, else x2
      E[i] = r < R ? (row < V ? x1[row * R + r] : x2[(row - V) * R + r]) : 0.f;
    }
    for (int i = tid; i < VV; i += kThreads) DA[i] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < VV * RP; i += kThreads) {
    const int r = i % RP, uv = i / RP;
    D[i] = tanhf(E[(uv / V) * RP + r] - E[(V + uv % V) * RP + r]);
    DD[i] = 0.f;
  }

  const int c = tid % CT;  // this thread's channel in the dm pass
  const int grp = tid / CT;
  const int G = kThreads / CT;
  const int nj = VP / kJ;
  const int ntiles = nj * nj;
  const int csize = kTC * VP * CT;
  for (int c0 = 0; c0 < C; c0 += CT) {
    __syncthreads();  // the previous tile's reads of DM and W are done
    for (int i = tid; i < RP * CT; i += kThreads) {
      const int r = i / CT, cc = i % CT;
      W[r * CTP + cc] =
          (r < R && c0 + cc < C) ? w4s[((size_t)s * R + r) * C + c0 + cc] : 0.f;
    }
    // ---- 1. dm of the tile ----
    for (int tb = 0; tb < T; tb += kTC) {
      __syncthreads();  // the previous chunk is consumed
      for (int base = tid; base < csize; base += kThreads * kBatch) {
        float gv[kBatch], xv[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = base + k * kThreads;
          const int cc = i % CT, rest = i / CT;
          const int v = rest % VP, t = tb + rest / VP;
          gv[k] = 0.f;
          xv[k] = 0.f;
          if (i < csize && t < T && v < V && c0 + cc < C) {
            const size_t row = ((size_t)n * T + t) * V + v;
            gv[k] = g[row * C + c0 + cc];
            xv[k] = x3s[row * SC + (size_t)s * C + c0 + cc];
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
      for (int item = grp; item < ntiles; item += G) {
        const int u0 = (item / nj) * kJ, v0 = (item % nj) * kJ;
        float acc[kJ][kJ];
#pragma unroll
        for (int i = 0; i < kJ; ++i) {
#pragma unroll
          for (int k = 0; k < kJ; ++k) {
            const int u = u0 + i, v = v0 + k;
            acc[i][k] = (tb > 0 && u < V && v < V) ? DM[(u * V + v) * CTP + c] : 0.f;
          }
        }
#pragma unroll 2
        for (int j = 0; j < kTC; ++j) {
          float gu[kJ], xv[kJ];
#pragma unroll
          for (int i = 0; i < kJ; ++i) {
            gu[i] = Gc[(j * VP + u0 + i) * CT + c];
            xv[i] = Xc[(j * VP + v0 + i) * CT + c];
          }
#pragma unroll
          for (int i = 0; i < kJ; ++i) {
#pragma unroll
            for (int k = 0; k < kJ; ++k) acc[i][k] = fmaf(gu[i], xv[k], acc[i][k]);
          }
        }
#pragma unroll
        for (int i = 0; i < kJ; ++i) {
#pragma unroll
          for (int k = 0; k < kJ; ++k) {
            const int u = u0 + i, v = v0 + k;
            if (u < V && v < V) DM[(u * V + v) * CTP + c] = acc[i][k];
          }
        }
      }
    }
    __syncthreads();  // dm of the tile is complete
    // ---- 2. what the dm tile contributes ----
    // dA row sums; each (u, v) always belongs to the same thread
    for (int uv = tid; uv < VV; uv += kThreads) {
      float sum = 0.f;
      for (int cc = 0; cc < CT; ++cc) sum += DM[uv * CTP + cc];
      DA[uv] += sum;
    }
    // per-sample P[r][c] = sum_uv D[uv][r] dm[uv][c], and (row RP) sum_uv dm
    for (int i = tid; i < (RP + 1) * CT; i += kThreads) {
      const int r = i / CT, cc = i % CT;
      if (c0 + cc >= C || (r < RP && r >= R)) continue;
      float acc = 0.f;
      if (r == RP) {
        for (int uv = 0; uv < VV; ++uv) acc += DM[uv * CTP + cc];
        pSum[c0 + cc] = acc;
      } else {
        for (int uv = 0; uv < VV; ++uv) acc = fmaf(D[uv * RP + r], DM[uv * CTP + cc], acc);
        pP[(size_t)r * C + c0 + cc] = acc;
      }
    }
    // DD[uv][r] += sum_c dm[uv][c] * w4[r][c]
    for (int i = tid; i < VV * RP; i += kThreads) {
      const int r = i % RP, uv = i / RP;
      float acc = 0.f;
      for (int cc = 0; cc < CT; ++cc) acc = fmaf(DM[uv * CTP + cc], W[r * CTP + cc], acc);
      DD[i] += acc;
    }
  }
  __syncthreads();
  // ---- dx1s = sum_v dpre, dx2s = -sum_u dpre; dpre = a * DD * (1 - D^2) ----
  for (int i = tid; i < 2 * V * R; i += kThreads) {
    const int r = i % R, row = i / R;  // row < V: dx1s of u = row; else dx2s
    float acc = 0.f;
    if (row < V) {
      for (int v = 0; v < V; ++v) {
        const int k = (row * V + v) * RP + r;
        acc = fmaf(DD[k], 1.f - D[k] * D[k], acc);
      }
      dx1s[(((size_t)n * S + s) * V + row) * R + r] = a * acc;
    } else {
      const int v = row - V;
      for (int u = 0; u < V; ++u) {
        const int k = (u * V + v) * RP + r;
        acc = fmaf(DD[k], 1.f - D[k] * D[k], acc);
      }
      dx2s[(((size_t)n * S + s) * V + v) * R + r] = -a * acc;
    }
  }
  for (int uv = tid; uv < VV; uv += kThreads) pA[uv] = DA[uv];
}

// Sums the per-sample partials over n, in order: dAs, dw4s = a * P,
// db4s = a * sum; and per block, sum of w4 * P + b4 * sum (dalpha's terms),
// which the block that finishes last adds up in block order into dalpha.
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_param_reduce(const float* __restrict__ part,
                             const float* __restrict__ w4s,
                             const float* __restrict__ b4s,
                             const float* __restrict__ alpha,
                             float* __restrict__ dw4s, float* __restrict__ db4s,
                             float* __restrict__ dAs,
                             float* __restrict__ dalpha_part,
                             unsigned int* __restrict__ done,
                             float* __restrict__ dalpha,
                             int N, int S, int V, int R, int C) {
  __shared__ float red[kThreads];
  __shared__ bool last;
  const size_t VV = (size_t)V * V, RC = (size_t)R * C;
  const size_t per = per_sample(V, R, C);
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  float term = 0.f;
  if (i < S * per) {
    const size_t s = i / per, k = i % per;
    float sum = 0.f;
    for (int n = 0; n < N; ++n) sum += part[((size_t)n * S + s) * per + k];
    const float a = alpha[0];
    if (k < VV) {
      dAs[s * VV + k] = sum;
    } else if (k < VV + RC) {
      const size_t rc = k - VV;
      dw4s[s * RC + rc] = a * sum;
      term = w4s[s * RC + rc] * sum;
    } else {
      const size_t cc = k - VV - RC;
      db4s[s * C + cc] = a * sum;
      term = b4s[s * C + cc] * sum;
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

template <int RP>
int launch(const float* x1s, const float* x2s, const float* g, const float* x3s,
           const float* w4s, const float* b4s, const float* alpha, float* dx1s,
           float* dx2s, float* dw4s, float* db4s, float* dalpha, float* dAs,
           float* scratch, int N, int S, int T, int V, int R, int C,
           cudaStream_t stream) {
  const int VP = (V + kJ - 1) / kJ * kJ;
  int CT = 16;
  if (sizeof(float) * smem_floats(V, VP, RP, CT) > kSmemLimit) CT = 8;
  const size_t smem = sizeof(float) * smem_floats(V, VP, RP, CT);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      unit_ctr_gc_bwd_param_kernel<RP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nb = reduce_blocks(S, V, R, C);
  float* part = scratch;
  float* dalpha_part = scratch + (size_t)N * S * per_sample(V, R, C);
  unsigned int* done = reinterpret_cast<unsigned int*>(dalpha_part + nb);
  unit_ctr_gc_bwd_param_kernel<RP><<<dim3(S, N), kThreads, smem, stream>>>(
      x1s, x2s, g, x3s, w4s, alpha, dx1s, dx2s, part, done, S, T, V, R, C, CT,
      VP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  unit_ctr_gc_bwd_param_reduce<<<nb, kThreads, 0, stream>>>(
      part, w4s, b4s, alpha, dw4s, db4s, dAs, dalpha_part, done, dalpha, N, S,
      V, R, C);
  return cudaGetLastError();
}

}  // namespace

// Floats of device scratch that unit_ctr_gc_bwd_param_f32 needs.
extern "C" long long unit_ctr_gc_bwd_param_scratch_floats(int N, int S, int V,
                                                          int R, int C) {
  // per-sample partials, per-block dalpha terms, the ticket counter
  return (long long)N * S * per_sample(V, R, C) + reduce_blocks(S, V, R, C) + 1;
}

// All tensors contiguous f32 on the device: x1s, x2s (N,S,V,R); g (N,T,V,C);
// x3s (N,T,V,S*C); w4s (S,R,C); b4s (S,C); alpha (1,) -> dx1s, dx2s
// (N,S,V,R); dw4s (S,R,C); db4s (S,C); dalpha (1,); dAs (S,V,V); scratch of
// unit_ctr_gc_bwd_param_scratch_floats(N, S, V, R, C) floats; R <= 32.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int unit_ctr_gc_bwd_param_f32(
    const float* x1s, const float* x2s, const float* g, const float* x3s,
    const float* w4s, const float* b4s, const float* alpha, float* dx1s,
    float* dx2s, float* dw4s, float* db4s, float* dalpha, float* dAs,
    float* scratch, int N, int S, int T, int V, int R, int C, void* stream) {
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
