// Unit CTR-GC backward fused with conv3's VJP (K6), for Hopper (sm_90a), f32.
//
// Replaces tamgcn_tpu/ops/pallas/ctr_gc.py:_unit_bwd_dx3_conv3_kernel_tile
// (launched by unit_ctr_gc_bwd_conv3_pallas), which computes K2's x3
// gradient and, from it, the gradients of the packed conv3 1x1 that produced
// x3s = x @ w3 + b3:
//
//   dx3s[n,t,v,s*C+c] = sum_u M_s[n,u,v,c] * g[n,t,u,c]
//   dx[n,t,v,i]       = sum_o dx3s[n,t,v,o] * w3[i,o]
//   dw3[i,o]          = sum_{n,t,v} x[n,t,v,i] * dx3s[n,t,v,o]
//   db3[o]            = sum_{n,t,v} dx3s[n,t,v,o]
//   M_s[n,u,v,c] = (sum_r tanh(x1s[n,s,u,r] - x2s[n,s,v,r]) * w4s[s,r,c]
//                   + b4s[s,c]) * alpha + As[s,u,v]
//
// with M rebuilt on the chip and dx3s (N,T,V,S*C) never written to device
// memory. dw3 comes out transposed, (S*C, Cin): the layout of conv3's weight.
//
// What bounds it on this card. At the deep NW-UCLA shape (N=16, T=13, V=20,
// Cin=C=256, R=32) the function reads g and x and writes dx (~13 MB, ~4 us
// at 3.35 TB/s) and does 2*N*S*(V*V*R*C + T*V*V*C) + 4*N*T*V*S*C*Cin
// ~ 3.7 GFLOP of f32 FMAs (~55 us at 67 TFLOP/s): the two products with
// w3 and x bound it. Two things fight: a row of dx mixes all S*C channels,
// while M for one sample (V*V*S*C floats, 1.2 MB at C=256) is far larger
// than a block's 227 KB of shared memory, so a block cannot own both a row
// and all of M.
//
// What the design does about it. One block of 256 threads per (sample n,
// chunk of TF frames); it loops over (subset s, tile of CT=16 channels; 8
// where 16 does not fit) and rebuilds M of the tile from D = tanh(x1_u -
// x2_v), which it keeps per subset (unit_ctr_gc_common.cuh: build_d,
// m_from_d). For each tile:
//   1. the tile's dx3 (rows x CT, rows = TF*V) in shared memory, from the
//      chunk's g tile, K2's stage 2 with one frame and 5 joints a thread;
//   2. dx += dx3 @ w3[tile]^T, with dx for the chunk's rows x Cin in
//      registers: each thread an 8 x 8 tile (two 4-row by two 4-column
//      quads, so a warp's 16-byte loads of w3 fall in distinct banks),
//      64 FMAs per four 16-byte shared-memory loads;
//   3. the tile's dw3^T = dx3^T x over the chunk's rows (x staged once per
//      block) and db3 = the column sums of dx3, written to the block's slot
//      of a partial buffer, (S*C) x (Cin+1) floats per block.
// TF is the largest that keeps rows x Cin within 64 accumulators a thread
// and the block within shared memory (3 frames at V=20, Cin=256; 12 at
// Cin=64). A second kernel sums the partials over blocks in block order, so
// two launches give bitwise equal gradients; no float atomics. M is rebuilt
// once per chunk (ceil(T/TF) times per sample), and the partial buffer is
// ~63 MB at the deep shape: fewer, larger chunks, tensor-core products and
// the partials' traffic are left for later work.

#include <cuda_runtime.h>

#include "unit_ctr_gc_common.cuh"

namespace {

using namespace unit_ctr_gc;

constexpr int kVV = 5;  // joints v per thread in the aggregation
constexpr int kAcc = 64;  // dx accumulators a thread holds: an 8 x 8 tile

__host__ __device__ inline int round8(int a) { return (a + 7) / 8 * 8; }

struct Plan {
  int TF, CT, VP, rowsP, CinP;
  size_t smem;  // bytes
};

// shared memory, in floats: X, W3, DX3, Gs, M, D, E; each a multiple of 4
__host__ inline size_t smem_floats(int V, int VP, int RP, int CT, int TF,
                                   int rowsP, int CinP) {
  return (size_t)rowsP * CinP                // X [rowsP][CinP]
         + (size_t)CT * CinP                 // W3 [CT][CinP]
         + (size_t)CT * (rowsP + 4)          // DX3 [CT][rowsP + 4]
         + (size_t)TF * V * CT               // Gs [TF][V][CT]
         + (size_t)V * VP * CT               // M [V][VP][CT]
         + (size_t)round4(V * V * (RP + 1))  // D [V*V][RP+1]
         + (size_t)2 * V * RP;               // E [2][V][RP]
}

// The chunk of frames and the channel tile: the largest TF whose rows x Cin
// fit in kAcc accumulators for each of kThreads threads and whose shared
// memory fits, CT=16 first. False where no TF >= 1 fits.
__host__ inline bool make_plan(int T, int V, int Cin, int RP, Plan* p) {
  p->VP = (V + kVV - 1) / kVV * kVV;
  p->CinP = round8(Cin);
  for (int CT = 16; CT >= 8; CT /= 2) {
    for (int TF = T; TF >= 1; --TF) {
      const int rowsP = round8(TF * V);
      if ((size_t)rowsP * p->CinP > (size_t)kThreads * kAcc) continue;
      const size_t smem =
          sizeof(float) * smem_floats(V, p->VP, RP, CT, TF, rowsP, p->CinP);
      if (smem > kSmemLimit) continue;
      p->TF = TF;
      p->CT = CT;
      p->rowsP = rowsP;
      p->smem = smem;
      return true;
    }
  }
  return false;
}

__host__ inline int rp_of(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : 32; }

template <int RP>
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_conv3_kernel(const float* __restrict__ x1s,
                             const float* __restrict__ x2s,
                             const float* __restrict__ g,
                             const float* __restrict__ w4s,
                             const float* __restrict__ b4s,
                             const float* __restrict__ alpha,
                             const float* __restrict__ As,
                             const float* __restrict__ x,
                             const float* __restrict__ w3t,
                             float* __restrict__ dx,
                             float* __restrict__ partials, int S, int T,
                             int V, int R, int C, int Cin, int CT, int TF,
                             int VP, int rowsP, int CinP) {
  extern __shared__ float4 smem4[];
  const int DXS = rowsP + 4;  // row stride of DX3: the CT channels' rows
                              // fall in different banks
  // X [rowsP][CinP]: the chunk's rows of x, zero-padded
  // W3 [CT][CinP]: w3^T of the channel tile
  // DX3 [CT][DXS]: dx3 of the channel tile, channel-major
  // Gs [TF][V][CT]: the chunk's g tile
  // M [V][VP][CT]: M_s of the tile, the joint v padded
  // D [V*V][RP+1], E [2][V][RP]: stage 1 of the current subset
  float* X = reinterpret_cast<float*>(smem4);
  float* W3 = X + (size_t)rowsP * CinP;
  float* DX3 = W3 + CT * CinP;
  float* Gs = DX3 + CT * DXS;
  float* M = Gs + TF * V * CT;
  float* D = M + V * VP * CT;
  float* E = D + round4(V * V * (RP + 1));

  const int n = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int nf = min(TF, T - t0);  // frames of this chunk
  const int rows = nf * V;
  const int tid = threadIdx.x;
  const float a = alpha[0];
  const int SC = S * C;
  // this block's slot: dw3^T [S*C][Cin], then db3 [S*C]
  float* part = partials + ((size_t)n * gridDim.x + blockIdx.x) * SC * (Cin + 1);
  float* part_b = part + (size_t)SC * Cin;

  // ---- the chunk's x, and the padding that is read but never written ----
  const float* xb = x + ((size_t)n * T + t0) * V * Cin;
  for (int i = tid; i < rowsP * CinP; i += kThreads) {
    const int row = i / CinP, ci = i % CinP;
    X[i] = (row < rows && ci < Cin) ? xb[(size_t)row * Cin + ci] : 0.f;
  }
  for (int i = tid; i < CT * DXS; i += kThreads) DX3[i] = 0.f;
  const int pad = (VP - V) * CT;
  for (int i = tid; i < V * pad; i += kThreads) {
    M[((i / pad) * VP + V) * CT + i % pad] = 0.f;
  }

  // this thread's dx tile: rows r0.. and r1.., columns i0.. and i1..
  const int nit = CinP / 8;
  const int rt = tid / nit, it = tid % nit;
  const bool owner = rt < rowsP / 8;
  const int r0 = 4 * rt, r1 = rowsP / 2 + 4 * rt;
  const int i0 = 4 * it, i1 = CinP / 2 + 4 * it;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  }

  const int CT4 = CT / 4;
  const int gsize4 = nf * V * CT4;  // 16-byte groups of the g tile
  const int ca = tid % CT, grp = tid / CT, G = kThreads / CT;
  const int nvg = VP / kVV;
  const int nci = CT / 4, nii = CinP / 4;
  for (int s = 0; s < S; ++s) {
    __syncthreads();  // the previous subset's reads of D are done
    build_d<RP>(x1s, x2s, D, E, n, s, S, V, R);
    for (int c0 = 0; c0 < C; c0 += CT) {
      __syncthreads();  // D is complete; the previous tile is consumed
      m_from_d<RP>(w4s, b4s, a, As, D, M, VP, s, c0, V, R, C, CT);
      for (int base = tid; base < gsize4; base += kThreads * kBatch) {
        float4 val[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = base + k * kThreads;
          const int rest = i / CT4;  // (frame j, joint u) = rest
          const int cx = c0 + 4 * (i % CT4);
          val[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < gsize4 && cx < C) {
            val[k] = *reinterpret_cast<const float4*>(
                g + (((size_t)n * T + t0) * V + rest) * C + cx);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = base + k * kThreads;
          if (i < gsize4) reinterpret_cast<float4*>(Gs)[i] = val[k];
        }
      }
      for (int i = tid; i < CT * CinP; i += kThreads) {
        const int c = i / CinP, ci = i % CinP;
        W3[i] = (c0 + c < C && ci < Cin)
                    ? w3t[((size_t)s * C + c0 + c) * Cin + ci] : 0.f;
      }
      __syncthreads();
      // ---- 1. DX3[c][j*V + v] = sum_u M_s[u][v][c] * g[t0+j][u][c] ----
      for (int item = grp; item < nf * nvg; item += G) {
        const int v0 = (item % nvg) * kVV, j = item / nvg;
        float d[kVV];
#pragma unroll
        for (int k = 0; k < kVV; ++k) d[k] = 0.f;
#pragma unroll 4
        for (int u = 0; u < V; ++u) {
          const float gu = Gs[(j * V + u) * CT + ca];
          const float* mrow = M + (u * VP + v0) * CT + ca;
#pragma unroll
          for (int k = 0; k < kVV; ++k) d[k] = fmaf(gu, mrow[k * CT], d[k]);
        }
#pragma unroll
        for (int k = 0; k < kVV; ++k) {
          if (v0 + k < V) DX3[ca * DXS + j * V + v0 + k] = d[k];
        }
      }
      __syncthreads();
      // ---- 2. dx[row][i] += sum_c DX3[c][row] * W3[c][i] ----
      if (owner) {
#pragma unroll 4
        for (int c = 0; c < CT; ++c) {
          const float4 a0 = *reinterpret_cast<const float4*>(DX3 + c * DXS + r0);
          const float4 a1 = *reinterpret_cast<const float4*>(DX3 + c * DXS + r1);
          const float4 b0 = *reinterpret_cast<const float4*>(W3 + c * CinP + i0);
          const float4 b1 = *reinterpret_cast<const float4*>(W3 + c * CinP + i1);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int p = 0; p < 8; ++p) {
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
          }
        }
      }
      // ---- 3. the block's dw3^T[o][i] = sum_row DX3[c][row] * X[row][i]
      // and db3[o] = sum_row DX3[c][row], o = s*C + c0 + c; 4 x 4 a thread,
      // a warp on one channel quad (its DX3 loads broadcast) ----
      for (int item = tid; item < nii * nci; item += kThreads) {
        const int cc = (item / nii) * 4, ii = (item % nii) * 4;
        float4 w[4];
        float b[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          b[k] = 0.f;
        }
        for (int row = 0; row < rows; ++row) {
          const float4 xv = *reinterpret_cast<const float4*>(X + row * CinP + ii);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float dv = DX3[(cc + k) * DXS + row];
            w[k] = fma4(dv, xv, w[k]);
            b[k] += dv;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = c0 + cc + k;
          if (c >= C) continue;
          float* dst = part + ((size_t)s * C + c) * Cin + ii;
          const float wk[4] = {w[k].x, w[k].y, w[k].z, w[k].w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            if (ii + m < Cin) dst[m] = wk[m];
          }
          if (ii == 0) part_b[s * C + c] = b[k];
        }
      }
    }
  }

  // ---- dx of the chunk's rows, from the registers ----
  if (owner) {
    float* dxb = dx + ((size_t)n * T + t0) * V * Cin;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int row = p < 4 ? r0 + p : r1 + p - 4;
      if (row >= rows) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int ci = q < 4 ? i0 + q : i1 + q - 4;
        if (ci < Cin) dxb[(size_t)row * Cin + ci] = acc[p][q];
      }
    }
  }
}

// Sums the blocks' partials in block order: dw3t [S*C][Cin], then db3 [S*C].
__global__ void __launch_bounds__(kThreads)
unit_ctr_gc_bwd_conv3_reduce(const float* __restrict__ partials, int nblk,
                             int SC, int Cin, float* __restrict__ dw3t,
                             float* __restrict__ db3) {
  const size_t per = (size_t)SC * (Cin + 1);
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= per) return;
  float sum = 0.f;
  for (int b = 0; b < nblk; ++b) sum += partials[(size_t)b * per + i];
  if (i < (size_t)SC * Cin) {
    dw3t[i] = sum;
  } else {
    db3[i - (size_t)SC * Cin] = sum;
  }
}

template <int RP>
int launch(const float* x1s, const float* x2s, const float* g,
           const float* w4s, const float* b4s, const float* alpha,
           const float* As, const float* x, const float* w3t, float* dx,
           float* dw3t, float* db3, float* partials, int N, int S, int T,
           int V, int R, int C, int Cin, cudaStream_t stream) {
  Plan p;
  if (!make_plan(T, V, Cin, RP, &p)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      unit_ctr_gc_bwd_conv3_kernel<RP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const int chunks = (T + p.TF - 1) / p.TF;
  unit_ctr_gc_bwd_conv3_kernel<RP><<<dim3(chunks, N), kThreads, p.smem, stream>>>(
      x1s, x2s, g, w4s, b4s, alpha, As, x, w3t, dx, partials, S, T, V, R, C,
      Cin, p.CT, p.TF, p.VP, p.rowsP, p.CinP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t per = (size_t)S * C * (Cin + 1);
  unit_ctr_gc_bwd_conv3_reduce<<<(int)((per + kThreads - 1) / kThreads), kThreads,
                                 0, stream>>>(partials, chunks * N, S * C, Cin,
                                              dw3t, db3);
  return cudaGetLastError();
}

bool dims_ok(int N, int S, int T, int V, int R, int C, int Cin) {
  return N >= 1 && N <= 65535 && S >= 1 && T >= 1 && V >= 1 && R >= 1 &&
         R <= 32 && C >= 4 && C % 4 == 0 && Cin >= 1;
}

}  // namespace

// Floats of device scratch (the per-block partials) that
// unit_ctr_gc_bwd_conv3_f32 needs; -1 where the shape does not fit a block.
extern "C" long long unit_ctr_gc_bwd_conv3_scratch_floats(int N, int S, int T,
                                                          int V, int R, int C,
                                                          int Cin) {
  Plan p;
  if (!dims_ok(N, S, T, V, R, C, Cin) || !make_plan(T, V, Cin, rp_of(R), &p)) {
    return -1;
  }
  const long long chunks = (T + p.TF - 1) / p.TF;
  return chunks * N * S * C * (long long)(Cin + 1);
}

// All tensors contiguous f32 on the device, g 16-byte aligned, w4s/b4s
// 16-byte aligned: x1s, x2s (N,S,V,R); g (N,T,V,C); w4s (S,R,C); b4s (S,C);
// alpha (1,); As (S,V,V); x (N,T,V,Cin); w3t (S*C,Cin), conv3's weight ->
// dx (N,T,V,Cin); dw3t (S*C,Cin); db3 (S*C,); partials of
// unit_ctr_gc_bwd_conv3_scratch_floats floats; C % 4 == 0 and R <= 32.
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int unit_ctr_gc_bwd_conv3_f32(
    const float* x1s, const float* x2s, const float* g, const float* w4s,
    const float* b4s, const float* alpha, const float* As, const float* x,
    const float* w3t, float* dx, float* dw3t, float* db3, float* partials,
    int N, int S, int T, int V, int R, int C, int Cin, void* stream) {
  if (!dims_ok(N, S, T, V, R, C, Cin)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TAMGCN_LAUNCH(RP)                                                      \
  launch<RP>(x1s, x2s, g, w4s, b4s, alpha, As, x, w3t, dx, dw3t, db3,         \
             partials, N, S, T, V, R, C, Cin, st)
  if (R <= 8) return TAMGCN_LAUNCH(8);
  if (R <= 16) return TAMGCN_LAUNCH(16);
  return TAMGCN_LAUNCH(32);
#undef TAMGCN_LAUNCH
}
