// What the unit CTR-GC kernels (K1 unit_ctr_gc_fwd.cu, K2
// unit_ctr_gc_bwd_dx3.cu, K3 unit_ctr_gc_bwd_param.cu, K5 gcn_tcn_block.cu,
// K6 unit_ctr_gc_bwd_conv3.cu) share: the block size, the shared-memory
// limit and the activation element types (Act). Stage 1, which builds the
// refined adjacency
//
//   M_s[n,u,v,c] = (sum_r tanh(x1s[n,s,u,r] - x2s[n,s,v,r]) * w4s[s,r,c]
//                   + b4s[s,c]) * alpha + As[s,u,v],
//
// lives with each design (unit_ctr_gc_whole.cuh, unit_ctr_gc_tiled.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace unit_ctr_gc {

// The activations (x1s, x2s, x3s, g and the outputs of the same shapes) are
// float or __nv_bfloat16, bf16 mixed precision; the parameters (w4s, b4s,
// alpha, As) are float in either. Shared memory, tanh and every sum are f32
// in both. Act<TA> loads an activation as f32 and stores an f32 result
// rounded once to T. Stage 1's operands follow their own policy (Stage1
// below): as is in f32; rounded to bf16 in bf16, where the JAX kernels run
// stage 1 as a bf16 product with f32 accumulation
// (tamgcn_tpu/ops/pallas/ctr_gc.py `mm_dtype`). The product of two bf16
// values is exact in f32, so an FMA over rounded operands computes what
// that product computes, up to the order of the sum. The x3 gradient of K6
// (unit_ctr_gc_bwd_conv3.cu) reads bf16 activations and writes f32, and
// K4's bf16 form (ctr_gc_fused.cu) reads bf16 x1/x2 and writes f32: the
// bodies take the types of x1s/x2s, of the aggregated tensor and of the
// output apart. K5's and T1's bf16 forms (gcn_tcn_block.cu, ms_tcn.cu)
// store two or four results at once (store2: 8 bytes in f32, 4 in bf16;
// store4: 16 and 8).
template <typename T>
struct Act;

template <>
struct Act<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
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
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(v.x, v.y),
                                    __floats2bfloat162_rn(v.z, v.w)};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(pair);
  }
};

__device__ inline float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Stage 1's operand policy: how D = tanh(x1 - x2) and w4s enter M's product
// over r. The designs' bodies take it as a template parameter, stage1_of<TE>
// (from the type of x1s/x2s) by default.
//   kF32:  f32 D and w4s, 3xTF32 (three TF32 products a term);
//   kBf16: D and w4s rounded to bf16, one bf16 product with f32
//          accumulation (the unit op's bf16 form, the JAX kernels'
//          `mm_dtype`);
//   kK4:   the difference and the tanh each rounded to bf16 and w4 kept in
//          f32, as the JAX K4 (ctr_gc.py:_fused_kernel) computes on bf16
//          x1/x2: D takes bf16 values, exact in TF32, so D times w4's two
//          TF32 parts (two products a term) leaves only w4's TF32 remainder
//          truncated to its top 11 bits, ~2^-22 of each term.
enum class Stage1 { kF32, kBf16, kK4 };

template <typename TE>
constexpr Stage1 stage1_of() {
  return sizeof(TE) == 4 ? Stage1::kF32 : Stage1::kBf16;
}

// D as stage 1's A operand, from the f32 values of x1 and x2
template <Stage1 P>
__device__ inline float stage1_d(float x1, float x2) {
  if constexpr (P == Stage1::kF32) {
    return tanhf(x1 - x2);
  } else if constexpr (P == Stage1::kBf16) {
    return bf16_round(tanhf(x1 - x2));
  } else {
    return bf16_round(tanhf(bf16_round(x1 - x2)));
  }
}

// w4s as stage 1's B operand (split into TF32 parts unless kBf16)
template <Stage1 P>
__device__ inline float stage1_w(float w) {
  return P == Stage1::kBf16 ? bf16_round(w) : w;
}

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__device__ inline float4 fma4(float d, float4 w, float4 acc) {
  return make_float4(fmaf(d, w.x, acc.x), fmaf(d, w.y, acc.y),
                     fmaf(d, w.z, acc.z), fmaf(d, w.w, acc.w));
}

}  // namespace unit_ctr_gc
