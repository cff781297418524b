// What the unit CTR-GC kernels (K1 unit_ctr_gc_fwd.cu, K2
// unit_ctr_gc_bwd_dx3.cu, K5 gcn_tcn_block.cu, K6 unit_ctr_gc_bwd_conv3.cu)
// share: the launch constants and stage 1, which builds the refined adjacency
//
//   M_s[n,u,v,c] = (sum_r tanh(x1s[n,s,u,r] - x2s[n,s,v,r]) * w4s[s,r,c]
//                   + b4s[s,c]) * alpha + As[s,u,v]
//
// of one sample and one tile of CT channels in shared memory; and, with K3
// (unit_ctr_gc_bwd_param.cu), the activation element types (Act).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace unit_ctr_gc {

// The activations (x1s, x2s, x3s, g and the outputs of the same shapes) are
// float or __nv_bfloat16, bf16 mixed precision; the parameters (w4s, b4s,
// alpha, As) are float in either. Shared memory, tanh and every sum are f32
// in both. Act<TA> loads an activation as f32, stores an f32 result rounded
// once to T, and gives stage 1's product operands: as is in f32; rounded to
// bf16 in bf16, where the JAX kernels run stage 1 as a bf16 product with f32
// accumulation (tamgcn_tpu/ops/pallas/ctr_gc.py `mm_dtype`). The product of
// two bf16 values is exact in f32, so an FMA over rounded operands computes
// what that product computes, up to the order of the sum.
template <typename T>
struct Act;

template <>
struct Act<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static float operand(float v) { return v; }
};

template <>
struct Act<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  // 4 channels in one 8-byte load
  __device__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
  __device__ static float operand(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

constexpr int kThreads = 256;
constexpr int kTC = 8;  // frames per x3s/g chunk in shared memory
constexpr int kBatch = 8;  // loads or tanh in flight per thread
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int round4(int a) { return (a + 3) / 4 * 4; }

__device__ inline float4 fma4(float d, float4 w, float4 acc) {
  return make_float4(fmaf(d, w.x, acc.x), fmaf(d, w.y, acc.y),
                     fmaf(d, w.z, acc.z), fmaf(d, w.w, acc.w));
}

// Stage 1, run by all kThreads threads of a block, in two halves.
//
// build_d: for sample n and subset s, stages the x1/x2 rows in E [2][V][RP]
// (zero-padded to RP) and computes D = tanh(x1_u - x2_v) into D [V*V][RP+1]
// (V*V*R values, once per block instead of once per channel; rows padded to
// RP+1 floats so the 8 rows a warp reads sit in different banks), as stage
// 1's operand (Act<TA>::operand). The caller synchronises before it writes E
// or D and before it reads D.
template <int RP, typename TA = float>
__device__ inline void build_d(const TA* __restrict__ x1s,
                               const TA* __restrict__ x2s, float* D,
                               float* E, int n, int s, int S, int V, int R) {
  const int tid = threadIdx.x;
  const int VV = V * V;
  {
    const TA* x1 = x1s + ((size_t)n * S + s) * V * R;
    const TA* x2 = x2s + ((size_t)n * S + s) * V * R;
    const int esize = 2 * V * RP;
    for (int base = tid; base < esize; base += kThreads * kBatch) {
      float val[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kThreads;
        const int r = i % RP, row = i / RP;  // row < V: x1, else x2
        val[k] = 0.f;
        if (i < esize && r < R) {
          val[k] = Act<TA>::load(row < V ? x1 + row * R + r : x2 + (row - V) * R + r);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kThreads;
        if (i < esize) E[i] = val[k];
      }
    }
  }
  __syncthreads();
  for (int base = tid; base < VV * RP; base += kThreads * kBatch) {
    float val[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = min(base + k * kThreads, VV * RP - 1);
      const int r = i % RP, uv = i / RP;
      val[k] = Act<TA>::operand(tanhf(E[(uv / V) * RP + r] - E[(V + uv % V) * RP + r]));
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads;
      if (i < VV * RP) D[(i / RP) * (RP + 1) + i % RP] = val[k];
    }
  }
}

// m_from_d: M_s = D @ w4s[s] for channels c0 .. c0+CT (C % 4 == 0,
// CT % 4 == 0), a small GEMM: each thread holds w4s[s,:,4 channels] in
// registers and, per r, reads one value of D for 4 FMAs, two (u,v) rows at
// a time. M_s[u,v,:] goes to Ms + (u * m_u + v) * CT, so the caller chooses
// which joint index is padded; w4s enters as stage 1's operand
// (Act<TA>::operand). The caller synchronises after build_d and before it
// reads Ms.
template <int RP, typename TA = float>
__device__ inline void m_from_d(const float* __restrict__ w4s,
                                const float* __restrict__ b4s, float a,
                                const float* __restrict__ As, const float* D,
                                float* Ms, int m_u, int s, int c0, int V,
                                int R, int C, int CT) {
  const int tid = threadIdx.x;
  const int VV = V * V;
  const int q = tid % (CT / 4);  // this thread's 4 channels: c0 + 4q ..
  const int lane_uv = tid / (CT / 4);
  const int NUV = kThreads / (CT / 4);
  const int c4 = c0 + 4 * q;
  const bool ok4 = c4 < C;  // C % 4 == 0: all 4 channels or none
  float4 w[RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    w[r] = (ok4 && r < R)
               ? *reinterpret_cast<const float4*>(w4s + ((size_t)s * R + r) * C + c4)
               : make_float4(0.f, 0.f, 0.f, 0.f);
    w[r] = make_float4(Act<TA>::operand(w[r].x), Act<TA>::operand(w[r].y),
                       Act<TA>::operand(w[r].z), Act<TA>::operand(w[r].w));
  }
  const float4 b = ok4 ? *reinterpret_cast<const float4*>(b4s + (size_t)s * C + c4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* A = As + (size_t)s * VV;
  for (int uv0 = lane_uv; uv0 < VV; uv0 += 2 * NUV) {
    const int uv1 = min(uv0 + NUV, VV - 1);
    const float* d0 = D + uv0 * (RP + 1);
    const float* d1 = D + uv1 * (RP + 1);
    float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc1 = acc0;
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      acc0 = fma4(d0[r], w[r], acc0);
      acc1 = fma4(d1[r], w[r], acc1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int uv = uv0 + h * NUV;
      const float4 acc = h ? acc1 : acc0;
      if (ok4 && uv < VV) {
        const int u = uv / V, v = uv % V;
        const float Auv = A[uv];
        *reinterpret_cast<float4*>(Ms + (u * m_u + v) * CT + 4 * q) =
            make_float4(fmaf(acc.x + b.x, a, Auv), fmaf(acc.y + b.y, a, Auv),
                        fmaf(acc.z + b.z, a, Auv), fmaf(acc.w + b.w, a, Auv));
      }
    }
  }
}

// Stage 1 for sample n and one tile of CT channels, all subsets: build_d
// then m_from_d per subset, M_s[u,v,:] at
//   M + (s * m_subset + u * m_u + v) * CT.
// There is no barrier after the last subset: the caller synchronises before
// it reads M or reuses D or E.
template <int RP, typename TA = float>
__device__ inline void build_m(const TA* __restrict__ x1s,
                               const TA* __restrict__ x2s,
                               const float* __restrict__ w4s,
                               const float* __restrict__ b4s, float a,
                               const float* __restrict__ As, float* D,
                               float* E, float* M, int m_subset, int m_u,
                               int n, int c0, int S, int V, int R, int C,
                               int CT) {
  for (int s = 0; s < S; ++s) {
    __syncthreads();  // the previous subset's reads of D and E are done
    build_d<RP, TA>(x1s, x2s, D, E, n, s, S, V, R);
    __syncthreads();
    m_from_d<RP, TA>(w4s, b4s, a, As, D, M + s * m_subset * CT, m_u, s, c0, V, R,
                 C, CT);
  }
}

}  // namespace unit_ctr_gc
