// Whole eval-mode GCN+TCN block (K5) for Hopper (sm_90a), f32.
//
// Replaces tamgcn_tpu/ops/pallas/gcn_tcn_block.py:_block_kernel (launched by
// gcn_tcn_block_fused) and computes the same function. With every eval
// BatchNorm folded into the 1x1 conv beside it:
//
//   x3     = x @ W3 + b3                          (S subsets packed, S*C wide)
//   y      = sum_s sum_v M_s[u,v,c] x3[t,v,s*C+c]  (the unit CTR-GC op, K1's)
//   y      = y * gy[0] + gy[1]                    (unit_gcn BN)
//   res    = x  |  x @ Wd + bd                    (identity | folded down conv)
//   off    = tanh((res - y) @ Wo + bo)            (TAM offset conv, folded)
//   h      = relu(y + off + res)
//   prefix = relu(h @ Wp + bp)                    (TCN entry conv, folded)
//   pw     = h @ Wpw + bpw                        (TCN 1x1 branch, folded)
//
// with M_s[n,u,v,c] = (tanh(x1s[n,s,u,:] - x2s[n,s,v,:]) @ w4s[s] + b4s[s,c])
// * alpha + As[s,u,v]. The refined adjacency M, x3 and h never go to device
// memory; y does (see phase B).
//
// What bounds it on this card. At the deep NW-UCLA blocks (N=64, T=13, V=20,
// Cin=C=256, R=32, P=192, BC=64) it moves ~34 MB (x in, prefix and pw out:
// ~10 us at 3.35 TB/s) and does ~12.7 GFLOP of f32 FMAs (~190 us at the
// 67 TFLOP/s f32 peak outside the tensor cores), 86% of them in the five
// products: the operations bound it at every shape of the model.
//
// What the design does about it. The TPU kernel keeps M of whole samples for
// all S*C channels in VMEM (1.2 MB per sample at C=256); a Hopper block has
// 227 KB, and the epilogue's products mix all C channels of a row, so one
// block cannot own both a channel tile and a row. Two kernels, one launch of
// the wrapper:
//   Phase A, channel-tiled (block_agg_kernel): one block of 256 threads per
//   (sample, tile of CT=16 channels; 8 where 16 does not fit). It builds M
//   for the tile and all subsets in shared memory with K1's stage 1
//   (unit_ctr_gc_common.cuh:build_m), then walks T in chunks of 8 frames.
//   For each chunk the x3 columns of the tile are a product over chunks of
//   32 input channels: x (transposed, 4 rows per 16-byte store) and W3 are
//   staged in shared memory, the next chunk's values already loading into
//   registers while this one computes; each thread keeps NXT tiles of 4 rows
//   x 4 columns, all in one column group, in registers over the whole input
//   depth (per k: one 16-byte weight load and one 16-byte x load per tile
//   for 16 FMAs each, and no branch, so the loads pipeline). Then the
//   aggregation is K1's stage 2, and y = agg * gy0 + gy1 goes to device
//   memory.
//   Phase B, row-tiled (block_epilogue_kernel): one block per BR rows
//   (n, t, v) with all C channels (BR = 8192 / C within [32, 128], so the
//   C x C product has 512 tiles of 4 x 4): res (x, or x @ Wd), res - y,
//   off, h in shared memory (h overwrites res in place: each element is
//   read and written by one thread), then prefix and pw straight to device
//   memory. Its products (block_gemm) give each thread 2 tiles of 4 x 4 in
//   one column group where the width allows, so one 16-byte weight load
//   through the read-only cache serves 32 FMAs.
// y's round trip (N*T*V*C floats written, then read) is the gap to the TPU
// kernel's single pass. Tensor cores (3xTF32 for f32 accuracy), TMA and a
// persistent grid are left for later work.

#include <cuda_runtime.h>

#include "unit_ctr_gc_common.cuh"

namespace {

using namespace unit_ctr_gc;

constexpr int kUU = 5;    // joints u per thread in the aggregation
constexpr int kTT = 2;    // frames t per thread in the aggregation
constexpr int kKC = 32;   // input channels per x chunk in phase A
constexpr int kBRItems = 512;  // 4x4 tiles of a phase B block's C x C product
constexpr int kNI = 2;    // 4x4 output tiles per thread per pass of block_gemm
constexpr int kXI = 3;    // at most 4x4 x3 tiles per phase A thread (V <= 31)
constexpr int kXS = 7;    // x float4s a phase A thread stages per chunk (V <= 28)
constexpr int kWS = 2;    // W3 float4s a phase A thread stages per chunk

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

__device__ inline float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// out[r, c..c+3] = sum_k A[r, k] * W[k, c..c+3] for the rows r < rows of A
// (shared memory, row stride lda, at least rows rounded up to 4 rows
// allocated) and the columns c < ncols (ncols % 4 == 0); W (ncols wide,
// 16-byte aligned) is read through the read-only cache. A thread computes
// kNI tiles of 4 x 4 in one pass over k (a tile past the last is computed
// again as the pass's first and not kept), and for each calls epi(r0, c,
// acc), acc[i] the 4 values of row r0 + i; rows past `rows` hold whatever A
// held there.
template <class Epi>
__device__ inline void block_gemm(const float* A, int lda, int rows, int K,
                                  const float* __restrict__ W, int ncols,
                                  Epi epi) {
  const int ncq = ncols / 4;
  const int nitems = (rows + 3) / 4 * ncq;
  for (int base = threadIdx.x; base < nitems; base += kThreads * kNI) {
    int r0[kNI], c[kNI];
    float4 acc[kNI][4];
#pragma unroll
    for (int it = 0; it < kNI; ++it) {
      const int item = base + it * kThreads < nitems ? base + it * kThreads : base;
      c[it] = 4 * (item % ncq);
      r0[it] = 4 * (item / ncq);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[it][i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (kThreads % ncq == 0) {
      // every tile of the pass has the thread's columns: one weight load
      // serves them all
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        const float4 wk = ldg4(W + (size_t)k * ncols + c[0]);
#pragma unroll
        for (int it = 0; it < kNI; ++it) {
          const float* a = A + r0[it] * lda + k;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[it][i] = fma4(a[i * lda], wk, acc[it][i]);
        }
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int it = 0; it < kNI; ++it) {
          const float4 wk = ldg4(W + (size_t)k * ncols + c[it]);
          const float* a = A + r0[it] * lda + k;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[it][i] = fma4(a[i * lda], wk, acc[it][i]);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kNI; ++it) {
      if (base + it * kThreads < nitems) epi(r0[it], c[it], acc[it]);
    }
  }
}

// phase A shared memory, in floats: the D/X region (stage 1's D, then the
// x3 chunk X [kTC*V][S*CT], the x chunk transposed XS [kKC][kTC*V+4] and
// the W3 chunk WS [kKC][S*CT]), then M, then E
__host__ __device__ inline int agg_region0(int V, int S, int CT, int RP) {
  return round4(imax(V * V * (RP + 1),
                     kTC * V * S * CT + kKC * (kTC * V + 4) + kKC * S * CT));
}

// the x3 tiles (4 rows x 4 columns) of phase A's threads: thread t < G2 *
// ncq owns column group t % ncq of the row quads t / ncq + it * G2, it < NXT
__host__ __device__ inline int x3_tiles(int V, int S, int CT) {
  const int G2 = kThreads / (S * CT / 4);
  return G2 >= 1 ? (kTC * V / 4 + G2 - 1) / G2 : kXI + 1;
}

__host__ __device__ inline bool x3_tiles_fit(int V, int S, int CT) {
  return x3_tiles(V, S, CT) <= kXI && kTC * V / 4 * kKC <= kXS * kThreads &&
         kKC * (S * CT / 4) <= kWS * kThreads;
}

template <int RP, int NXT>
__global__ void __launch_bounds__(kThreads)
block_agg_kernel(const float* __restrict__ x, const float* __restrict__ x1s,
                 const float* __restrict__ x2s, const float* __restrict__ w3,
                 const float* __restrict__ b3, const float* __restrict__ w4s,
                 const float* __restrict__ b4s, const float* __restrict__ alpha,
                 const float* __restrict__ As, const float* __restrict__ gy,
                 float* __restrict__ y, int S, int T, int V, int Cin, int R,
                 int C, int CT, int VP) {
  extern __shared__ float4 smem4[];
  float* D = reinterpret_cast<float*>(smem4);
  const int SCT = S * CT;
  const int rows = kTC * V;  // (frame, joint) rows of a chunk
  const int LDX = rows + 4;  // XS's row stride: 16-byte aligned, LDX / 4 odd
  float* X = D;
  float* XS = X + rows * SCT;
  float* WS = XS + kKC * LDX;
  float* M = D + agg_region0(V, S, CT, RP);
  float* E = M + S * VP * V * CT;

  const int n = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  const int nct = min(CT, C - c0);  // channels of the tile that exist
  const int tid = threadIdx.x;
  const float a = alpha[0];

  // ---- stage 1: M_s[u,v,c] for the channel tile, all subsets (K1's) ----
  build_m<RP>(x1s, x2s, w4s, b4s, a, As, D, E, M, VP * V, V, n, c0, S, V, R,
              C, CT);
  for (int i = tid; i < S * (VP - V) * V * CT; i += kThreads) {
    const int rest = i / (V * CT);  // (s, u - V)
    M[((rest / (VP - V)) * VP + V + rest % (VP - V)) * V * CT + i % (V * CT)] = 0.f;
  }

  const int c = tid % CT;  // this thread's channel in the aggregation
  const int g = tid / CT;
  const int G = kThreads / CT;
  const int cg = c0 + c;
  const float gs = cg < C ? gy[cg] : 0.f;
  const float gb = cg < C ? gy[C + cg] : 0.f;
  const int nug = VP / kUU;
  const int nitems = nug * (kTC / kTT);
  const size_t SC = (size_t)S * C;
  // x3 tiles of this thread (x3_tiles_fit): 4 rows x 4 columns of X each,
  // all in one column group, kept in registers over the whole input depth
  const int ncq = SCT / 4;
  const int G2 = kThreads / ncq;
  const int wcol = 4 * (tid % ncq);  // the tiles' columns
  // their first rows; a tile past the last computes rows 0..3 again and is
  // not kept, so that every load of the product loop is unconditional
  int xrow[NXT];
  bool keep[NXT];
#pragma unroll
  for (int it = 0; it < NXT; ++it) {
    const int r0 = 4 * (tid / ncq + it * G2);
    keep[it] = tid < G2 * ncq && r0 < rows;
    xrow[it] = keep[it] ? r0 : 0;
  }
  const float4 bias = wcol % CT < nct
                          ? ldg4(b3 + (wcol / CT) * C + c0 + wcol % CT)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  // the x and W3 values of chunk (frames tb_.., channels k0_..) that this
  // thread stages, loaded into registers while the previous chunk computes
  float4 xv[kXS];  // x[4 rows, one channel]: one 16-byte store into XS
  float4 wv[kWS];
  auto load = [&](int tb_, int k0_) {
    const int kc_ = min(kKC, Cin - k0_);
    const float* xc = x + ((size_t)n * T + tb_) * V * Cin + k0_;
    const int valid_rows = min(rows, (T - tb_) * V);
#pragma unroll
    for (int b = 0; b < kXS; ++b) {
      const int i = tid + b * kThreads;
      const int row = 4 * (i / kKC), kk = i % kKC;
      const bool on = kk < kc_;
      const float* p = xc + (size_t)row * Cin + kk;
      xv[b] = make_float4(on && row < valid_rows ? p[0] : 0.f,
                          on && row + 1 < valid_rows ? p[Cin] : 0.f,
                          on && row + 2 < valid_rows ? p[2 * Cin] : 0.f,
                          on && row + 3 < valid_rows ? p[3 * Cin] : 0.f);
    }
#pragma unroll
    for (int b = 0; b < kWS; ++b) {
      const int i = tid + b * kThreads;
      const int kk = i / ncq, j = 4 * (i % ncq), cc = j % CT;
      wv[b] = (kk < kc_ && cc < nct)
                  ? ldg4(w3 + (size_t)(k0_ + kk) * SC + (j / CT) * C + c0 + cc)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load(0, 0);
  for (int tb = 0; tb < T; tb += kTC) {
    // ---- x3 of the tile: X[row][s*CT + cc] = b3 + x[row] @ W3[:, s*C+c0+cc]
    float4 xacc[NXT][4];
#pragma unroll
    for (int it = 0; it < NXT; ++it) {
#pragma unroll
      for (int i = 0; i < 4; ++i) xacc[it][i] = bias;
    }
    for (int k0 = 0; k0 < Cin; k0 += kKC) {
      const int kc = min(kKC, Cin - k0);
      __syncthreads();  // M is complete; the previous chunk is consumed
#pragma unroll
      for (int b = 0; b < kXS; ++b) {
        // LDX / 4 is odd: the 8 lanes of a quarter warp store to other banks
        const int i = tid + b * kThreads;
        if (i < rows / 4 * kKC) {
          *reinterpret_cast<float4*>(XS + (i % kKC) * LDX + 4 * (i / kKC)) = xv[b];
        }
      }
#pragma unroll
      for (int b = 0; b < kWS; ++b) {
        const int i = tid + b * kThreads;
        if (i < kKC * ncq) {
          *reinterpret_cast<float4*>(WS + (i / ncq) * SCT + 4 * (i % ncq)) = wv[b];
        }
      }
      __syncthreads();
      if (k0 + kKC < Cin) {
        load(tb, k0 + kKC);
      } else if (tb + kTC < T) {
        load(tb + kTC, 0);
      }
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(WS + k * SCT + wcol);
#pragma unroll
        for (int it = 0; it < NXT; ++it) {
          const float4 a = *reinterpret_cast<const float4*>(XS + k * LDX + xrow[it]);
          xacc[it][0] = fma4(a.x, w, xacc[it][0]);
          xacc[it][1] = fma4(a.y, w, xacc[it][1]);
          xacc[it][2] = fma4(a.z, w, xacc[it][2]);
          xacc[it][3] = fma4(a.w, w, xacc[it][3]);
        }
      }
    }
    __syncthreads();  // the last chunks are consumed, and the aggregation of
                      // the previous T chunk is done with X
#pragma unroll
    for (int it = 0; it < NXT; ++it) {
      if (keep[it]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          *reinterpret_cast<float4*>(X + (xrow[it] + i) * SCT + wcol) = xacc[it][i];
        }
      }
    }
    __syncthreads();
    // ---- aggregation (K1's stage 2), then the unit_gcn BN affine ----
    for (int item = g; item < nitems; item += G) {
      const int u0 = (item % nug) * kUU;
      const int j0 = (item / nug) * kTT;  // frame within the chunk
      float acc[kTT][kUU];
#pragma unroll
      for (int j = 0; j < kTT; ++j) {
#pragma unroll
        for (int i = 0; i < kUU; ++i) acc[j][i] = 0.f;
      }
      for (int s = 0; s < S; ++s) {
#pragma unroll 4
        for (int v = 0; v < V; ++v) {
          const float* mrow = M + ((s * VP + u0) * V + v) * CT + c;
          const float* xrow = X + (j0 * V + v) * SCT + s * CT + c;
          float m[kUU];
#pragma unroll
          for (int i = 0; i < kUU; ++i) m[i] = mrow[i * V * CT];
          float xv[kTT];
#pragma unroll
          for (int j = 0; j < kTT; ++j) xv[j] = xrow[j * V * SCT];
#pragma unroll
          for (int j = 0; j < kTT; ++j) {
#pragma unroll
            for (int i = 0; i < kUU; ++i) acc[j][i] = fmaf(xv[j], m[i], acc[j][i]);
          }
        }
      }
      if (cg < C) {
#pragma unroll
        for (int j = 0; j < kTT; ++j) {
          const int t = tb + j0 + j;
#pragma unroll
          for (int i = 0; i < kUU; ++i) {
            const int u = u0 + i;
            if (t < T && u < V) {
              y[(((size_t)n * T + t) * V + u) * C + cg] = fmaf(acc[j][i], gs, gb);
            }
          }
        }
      }
    }
  }
}

// Phase B. Shared memory: Rs [BR][C+4] (res, then h) and Ds
// [BR][max(Cin+1, C+4)] (x when the residual is a conv, then res - y). The
// row strides are padded so that the rows a warp reads sit in other banks.
__host__ __device__ inline int epi_ldr(int C) { return C + 4; }
__host__ __device__ inline int epi_region(int BR, int Cin, int C) {
  return BR * (epi_ldr(C) + imax(Cin + 1, epi_ldr(C)));
}

__global__ void __launch_bounds__(kThreads)
block_epilogue_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ wd, const float* __restrict__ bd,
                      const float* __restrict__ wo, const float* __restrict__ bo,
                      const float* __restrict__ wp, const float* __restrict__ bp,
                      const float* __restrict__ wpw,
                      const float* __restrict__ bpw, float* __restrict__ prefix,
                      float* __restrict__ pw, int NR, int Cin, int C, int P,
                      int BC, int BR) {
  extern __shared__ float4 smem4[];
  const int LDR = epi_ldr(C);
  float* Rs = reinterpret_cast<float*>(smem4);
  float* Ds = Rs + BR * LDR;
  const int tid = threadIdx.x;
  const size_t r_base = (size_t)blockIdx.x * BR;
  const int rows = min(BR, NR - (int)r_base);
  const float* xb = x + r_base * Cin;
  const float* yb = y + r_base * C;

  // ---- res ----
  if (wd == nullptr) {  // identity (Cin == C)
    for (int i = tid; i < BR * C; i += kThreads) {
      Rs[(i / C) * LDR + i % C] = i / C < rows ? xb[i] : 0.f;
    }
  } else {
    for (int i = tid; i < BR * Cin; i += kThreads) {
      Ds[(i / Cin) * (Cin + 1) + i % Cin] = i / Cin < rows ? xb[i] : 0.f;
    }
    __syncthreads();
    block_gemm(Ds, Cin + 1, BR, Cin, wd, C,
               [&](int r0, int c, const float4* acc) {
                 const float4 b = ldg4(bd + c);
#pragma unroll
                 for (int i = 0; i < 4; ++i) {
                   *reinterpret_cast<float4*>(Rs + (r0 + i) * LDR + c) =
                       make_float4(acc[i].x + b.x, acc[i].y + b.y,
                                   acc[i].z + b.z, acc[i].w + b.w);
                 }
               });
  }
  __syncthreads();
  // ---- res - y ----
  for (int i = tid; i < BR * C; i += kThreads) {
    const int r = i / C, o = r * LDR + i % C;
    Ds[o] = r < rows ? Rs[o] - yb[i] : 0.f;
  }
  __syncthreads();
  // ---- off = tanh((res - y) @ Wo + bo); h = relu(y + off + res) into Rs ----
  block_gemm(Ds, LDR, BR, C, wo, C, [&](int r0, int c, const float4* acc) {
    const float4 b = ldg4(bo + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < rows) {
        const float4 yv = *reinterpret_cast<const float4*>(yb + (r0 + i) * C + c);
        float4* h = reinterpret_cast<float4*>(Rs + (r0 + i) * LDR + c);
        const float4 r = *h;
        *h = make_float4(fmaxf(yv.x + tanhf(acc[i].x + b.x) + r.x, 0.f),
                         fmaxf(yv.y + tanhf(acc[i].y + b.y) + r.y, 0.f),
                         fmaxf(yv.z + tanhf(acc[i].z + b.z) + r.z, 0.f),
                         fmaxf(yv.w + tanhf(acc[i].w + b.w) + r.w, 0.f));
      }
    }
  });
  __syncthreads();
  // ---- prefix = relu(h @ Wp + bp); pw = h @ Wpw + bpw ----
  block_gemm(Rs, LDR, BR, C, wp, P, [&](int r0, int c, const float4* acc) {
    const float4 b = ldg4(bp + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < rows) {
        *reinterpret_cast<float4*>(prefix + (r_base + r0 + i) * P + c) =
            make_float4(fmaxf(acc[i].x + b.x, 0.f), fmaxf(acc[i].y + b.y, 0.f),
                        fmaxf(acc[i].z + b.z, 0.f), fmaxf(acc[i].w + b.w, 0.f));
      }
    }
  });
  block_gemm(Rs, LDR, BR, C, wpw, BC, [&](int r0, int c, const float4* acc) {
    const float4 b = ldg4(bpw + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < rows) {
        *reinterpret_cast<float4*>(pw + (r_base + r0 + i) * BC + c) = make_float4(
            acc[i].x + b.x, acc[i].y + b.y, acc[i].z + b.z, acc[i].w + b.w);
      }
    }
  });
}

template <int RP, int NXT>
int launch_one(const float* x, const float* x1s, const float* x2s,
               const float* w3, const float* b3, const float* w4s,
               const float* b4s, const float* alpha, const float* As,
               const float* gy, float* y, int N, int S, int T, int V, int Cin,
               int R, int C, int CT, int VP, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block_agg_kernel<RP, NXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + CT - 1) / CT, N);
  block_agg_kernel<RP, NXT><<<grid, kThreads, smem, stream>>>(
      x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, y, S, T, V, Cin, R, C, CT,
      VP);
  return cudaGetLastError();
}

template <int RP>
int launch_agg(const float* x, const float* x1s, const float* x2s,
               const float* w3, const float* b3, const float* w4s,
               const float* b4s, const float* alpha, const float* As,
               const float* gy, float* y, int N, int S, int T, int V, int Cin,
               int R, int C, cudaStream_t stream) {
  const int VP = (V + kUU - 1) / kUU * kUU;
  auto smem_bytes = [&](int ct) {
    return sizeof(float) * ((size_t)agg_region0(V, S, ct, RP) +
                            (size_t)S * VP * V * ct + 2 * V * RP);
  };
  // what the block keeps must fit its shared memory, and the x3 tiles of a
  // chunk its threads' registers
  auto fits = [&](int ct) {
    return smem_bytes(ct) <= kSmemLimit && x3_tiles_fit(V, S, ct);
  };
  int CT = 16;
  if (!fits(CT)) CT = 8;
  if (!fits(CT)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(CT);
  switch (x3_tiles(V, S, CT)) {
    case 1:
      return launch_one<RP, 1>(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, y, N, S, T, V, Cin, R, C, CT, VP, smem, stream);
    case 2:
      return launch_one<RP, 2>(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, y, N, S, T, V, Cin, R, C, CT, VP, smem, stream);
    default:
      return launch_one<RP, kXI>(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, y, N, S, T, V, Cin, R, C, CT, VP, smem, stream);
  }
}

}  // namespace

// All tensors contiguous f32 on the device, 16-byte aligned: x (N,T,V,Cin);
// x1s, x2s (N,S,V,R); w3 (Cin,S*C); b3 (S*C,); w4s (S,R,C); b4s (S,C);
// alpha (1,); As (S,V,V); gy (2,C); wd (Cin,C) and bd (C,), or both null for
// an identity residual (Cin == C); wo (C,C); bo (C,); wp (C,P); bp (P,);
// wpw (C,BC); bpw (BC,); y (N,T,V,C), scratch; prefix (N,T,V,P); pw
// (N,T,V,BC). C, P and BC % 4 == 0, R <= 32. Launches both phases on
// `stream` and returns the first non-zero cudaGetLastError() (0 = ok).
extern "C" int gcn_tcn_block_f32(
    const float* x, const float* x1s, const float* x2s, const float* w3,
    const float* b3, const float* w4s, const float* b4s, const float* alpha,
    const float* As, const float* gy, const float* wd, const float* bd,
    const float* wo, const float* bo, const float* wp, const float* bp,
    const float* wpw, const float* bpw, float* y, float* prefix, float* pw,
    int N, int S, int T, int V, int Cin, int R, int C, int P, int BC,
    void* stream) {
  const long long NR = (long long)N * T * V;
  if (N < 1 || N > 65535 || S < 1 || T < 1 || V < 1 || Cin < 1 || R < 1 ||
      C < 4 || C % 4 != 0 || P < 4 || P % 4 != 0 || BC < 4 || BC % 4 != 0 ||
      (wd == nullptr) != (bd == nullptr) || (wd == nullptr && Cin != C) ||
      NR > 0x7fffffffLL - 1024) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = cudaErrorInvalidValue;
  if (R <= 8) {
    err = launch_agg<8>(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, y, N, S, T, V, Cin, R, C, st);
  } else if (R <= 16) {
    err = launch_agg<16>(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, y, N, S, T, V, Cin, R, C, st);
  } else if (R <= 32) {
    err = launch_agg<32>(x, x1s, x2s, w3, b3, w4s, b4s, alpha, As, gy, y, N, S, T, V, Cin, R, C, st);
  }
  if (err != cudaSuccess) return err;
  // rows per block: enough 4x4 tiles in the C x C product for every thread,
  // and what the block keeps within its shared memory
  int BR = imax(32, imin(128, kBRItems * 16 / C)) / 4 * 4;
  while (BR > 4 && sizeof(float) * (size_t)epi_region(BR, Cin, C) > (size_t)kSmemLimit) BR /= 2;
  const size_t smem = sizeof(float) * (size_t)epi_region(BR, Cin, C);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      block_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (int)((NR + BR - 1) / BR);
  block_epilogue_kernel<<<blocks, kThreads, smem, st>>>(
      x, y, wd, bd, wo, bo, wp, bp, wpw, bpw, prefix, pw, (int)NR, Cin, C, P,
      BC, BR);
  return cudaGetLastError();
}
