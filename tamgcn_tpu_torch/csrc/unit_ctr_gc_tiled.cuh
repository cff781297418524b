// The joint-tiled design of the unit CTR-GC forward (K1t) and x3 gradient
// (K2t), for V where M of a channel tile for all V x V joint pairs does not
// fit a block's shared memory (V = 256 needs 4 MB at 16 channels).
//
// A block of 8 warps owns one sample n, one tile of kJ = 16 "own" joints (u
// for K1, v for K2), one tile of CT channels and, for K2, one subset s. It
// walks the tiles of 16 "summed" joints (v for K1, u for K2) and, for K1,
// the subsets: at each step it builds the M tile of (s, 16 u, 16 v, CT
// channels) in shared memory (stage 1) and adds M_c @ X_c to its outputs for
// every channel c (stage 2), where X is the step's chunk of TF frames of x3s
// (K1) or g (K2). It writes each output once and uses no atomics, so two
// launches are bitwise equal. Where T > TF it walks the frames in chunks
// and builds the M tiles again.
//
// What bounds it on this card. Per sample and subset the function does
// V*V*R*C FMAs to build M and T*V*V*C to aggregate; at configs/
// scene256.yaml's blocks that is 82 G FMAs per forward at batch 8: 2.45 ms
// at the 67 TFLOP/s of the CUDA cores, 1.0 ms at the 165 TFLOP/s of f32
// products on the tensor cores as 3xTF32, against ~0.2 ms of bytes. The
// operations bound it; what wastes them is frames padded past T, products
// from shared memory on the CUDA cores (a shared load per few FMAs),
// staging that does not overlap the products, and D = tanh(x1_u - x2_v)
// built again for every narrow channel tile.
//
// What this design does about it:
// - Frames sized to T: the frame tile TF (8, 16 or 32) is picked from T at
//   launch, and stage 2 multiplies only the 8-frame MMA tiles that hold a
//   frame < T.
// - Both products on the tensor cores with mma.sync m16n8k8. Stage 1 is a
//   (256 pairs x RP) @ (RP x CT) product per step (rows: the pairs, columns:
//   the channels; warp w takes the pairs of u rows w and w + 8); stage 2,
//   per channel, a (16 own x 16 summed) @ (16 summed x TF frames) product
//   (rows: the own joints, columns: the frames; a warp takes CT/32 groups of
//   4 channels). In f32 every product is 3xTF32: each operand splits into a
//   TF32 high part and its remainder, and lo*hi + hi*lo + hi*hi are taken
//   (the dropped lo*lo is ~2^-21 of the product). The tensor cores sum with
//   truncation, so stage 2 starts each step's 16-term sum from zero and adds
//   it to the running output with an f32 add (rounded to nearest). In bf16,
//   stage 1 is one bf16 product with f32 accumulation over D and w4s
//   rounded to bf16 (the JAX kernel's bf16 MXU product); M stays f32, and
//   stage 2 takes M's two TF32 parts against the bf16 activations, which
//   are exact in TF32.
// - D built once per CT = 64 channels where shared memory and registers
//   allow (TF <= 16), else 32, with the accurate tanhf, straight into stage
//   1's A fragments in registers (no D in shared memory), so the tanh runs
//   between the tensor-core products of the same warp.
// - Loads overlap compute: the next step's chunk is copied by the Tensor
//   Memory Accelerator (one tensor copy of 32 channels x 16 joints x TF
//   frames per 32 channels, zero past T and V, counted on an mbarrier) into
//   the second of two buffers, its A tile and x1/x2 rows by
//   cp.async (bf16: the rows through registers behind stage 1), and w4s is
//   reloaded behind stage 2 when the subset changes. Two barriers per step.
//   A tensor copy, not per-thread cp.async or one bulk copy per 128-byte
//   row: those stall the issuing warps for ~2 us a step at 64 KB.
// - Registers, not shared memory, limit it now: ~255 a thread at one block
//   of 8 warps an SM, so the products wait on their operands' latency.
// Shared memory holds the f32 chunks as the tensor copy writes them (128B
// swizzle), the bf16 chunks (rows only 8-byte aligned: cp.async) in padded
// rows, and M, w4s, the x1/x2 rows and the A tiles in f32. M is stored
// [own][summed][channels] in units of 4 channels, the unit XOR-ed with the
// rows, so that a warp's fragment loads of 4 channels at once hit distinct
// banks.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstdint>

#include "mma_tf32x3.cuh"
#include "unit_ctr_gc_common.cuh"

namespace unit_ctr_gc {
namespace tiled {

constexpr int kJ = 16;      // joints per tile, each side
constexpr int kWarps = kThreads / 32;

// the frame tile for T
__host__ __device__ constexpr int frame_tile(int T) { return T <= 8 ? 8 : T <= 16 ? 16 : 32; }

// The bf16 chunk buffer's frame stride in units of 4 channels: rows (frame,
// joint) of CT/4 units padded by one, frames padded by 4 more, so that the
// 16 lanes of a half warp, which read rows (frame + g, joint + t4) for g in
// 0..3 (mod 4) and t4 in 0..3, hit 16 distinct 8-byte bank slots. The f32
// chunk is as the tensor copy writes it: CT/32 boxes [TF][kJ][32 channels],
// each 128-byte row's 16-byte units XOR-ed with the row index mod 8.
__host__ __device__ constexpr int frame_units(int CT) { return kJ * (CT / 4 + 1) + 4; }
__host__ __device__ constexpr int chunk_bytes(int TF, int CT, int act_bytes) {
  return act_bytes == 4 ? TF * kJ * CT * 4 : TF * frame_units(CT) * 4 * act_bytes;
}

// shared memory in bytes: 1024 for aligning the start to the 128B swizzle's
// period, the two chunk buffers, M [kJ][kJ][CT], W [RP][CT+4] as (hi, lo)
// pairs, the bias [CT], E [2][2*kJ][RP+4] (the x1 and x2 rows of a step), the
// A tiles [2][kJ][kJ], two mbarriers
__host__ __device__ constexpr int smem_bytes(int TF, int CT, int RP, int act_bytes) {
  return 1024 + 2 * chunk_bytes(TF, CT, act_bytes) + 4 * kJ * kJ * CT + 8 * RP * (CT + 4) +
         4 * CT + 4 * 2 * 2 * kJ * (RP + 4) + 4 * 2 * kJ * kJ + 16;
}

// the channel tile for (TF, RP, activation bytes): 64 channels where TF <=
// 16 (stage 2's TF * CT / 16 accumulators a thread, twice over, stay within
// the registers) and the shared memory holds them, else 32
__host__ __device__ constexpr int channel_tile(int TF, int RP, int act_bytes) {
  return TF <= 16 && smem_bytes(TF, 64, RP, act_bytes) <= kSmemLimit ? 64 : 32;
}

// the unit (4 channels) q of joint row (outer, inner) of M [kJ][kJ][CT], in
// units: rows of CT/4 >= 8 units, the unit index XOR-ed with (inner % 4) +
// 4 * (outer % 2), so that the 8 lanes of a quarter warp, which read rows
// (outer + g, inner + t4) for g in {0, 1} (mod 2) and t4 in 0..3, hit 8
// distinct 16-byte bank groups
template <int CT>
__device__ inline int unit_at(int outer, int inner, int q) {
  return (outer * kJ + inner) * (CT / 4) + (q ^ ((inner & 3) | ((outer & 1) << 2)));
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of one bf16 unit of 4 channels (8 bytes), zero-filled where `ok`
// is false
__device__ inline void copy_unit(void* dst, const __nv_bfloat16* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}

// one mbarrier per chunk buffer: the f32 chunk arrives by tensor copies (the
// Tensor Memory Accelerator), which count their bytes on it
__device__ inline void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ inline void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ inline void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity) : "memory");
}
// one box of the f32 chunk map (32 channels x kJ joints x TF frames x 1
// sample) at (channel, joint, frame, sample), counted on bar
__device__ inline void tensor_copy(void* dst, const CUtensorMap* map, int c, int j, int t,
                                   int n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(j), "r"(t), "r"(n),
      "r"(smem_addr(bar)) : "memory");
}

// The map of an f32 (N, T, V, ld) tensor for tensor_copy: boxes of 32
// channels (128 bytes, swizzled in 16-byte units by the row, 128B mode) x kJ
// joints x TF frames x 1 sample, zero past each extent. Encoded on the host
// by cuTensorMapEncodeTiled, looked up at run time (no link to libcuda).
inline cudaError_t chunk_map(CUtensorMap* map, const float* base, int N, int T, int V,
                             int ld, int TF) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)ld, (cuuint64_t)V, (cuuint64_t)T, (cuuint64_t)N};
  const cuuint64_t strides[3] = {4ull * ld, 4ull * ld * V, 4ull * ld * V * T};
  const cuuint32_t box[4] = {32, (cuuint32_t)kJ, (cuuint32_t)TF, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__device__ inline void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ inline void copy_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// 4 channels of a unit as f32
__device__ inline float4 unit_load(const float* X, int unit) {
  return reinterpret_cast<const float4*>(X)[unit];
}
__device__ inline float4 unit_load(const __nv_bfloat16* X, int unit) {
  const uint2 raw = reinterpret_cast<const uint2*>(X)[unit];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

using mma_tf32x3::mma_tf32;  // one m16n8k8 TF32 product (mma_tf32x3.cuh)
using mma_tf32x3::split;     // an f32 value's TF32 high part and remainder

// bf16 m16n8k8: k slots 2j and 2j+1 of a lane hold the TF32 layout's k = j
// and j + 4 (the same permutation of k in A and B, so the same sum)
__device__ inline void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ inline uint32_t pack_bf16(float k_lo, float k_hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(k_lo, k_hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 4 channels rounded once to the output type
__device__ inline void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ inline void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The body of both kernels. kFwd (K1): own joints u (x1 rows), summed v (x2
// rows), the block walks the subsets and the v tiles; src x3s (row stride
// S*C, subset s at s*C), dst out (row stride C). !kFwd (K2): own v (x2
// rows), summed u (x1 rows), subset s_own, the block walks the u tiles; src
// g (row stride C), dst dx3s (row stride S*C, subset s at s*C). Row (n, t, j)
// of src or dst at ((n*T + t)*V + j) * stride. x1s/x2s are TE, src TX
// (its chunks by tensor copy in f32), dst TO, and stage 1 follows kS1, as
// in unit_ctr_gc_whole.cuh:run.
template <bool kFwd, int RP, int TF, int CT, typename TE, typename TX = TE, typename TO = TX,
          Stage1 kS1 = stage1_of<TE>()>
__device__ inline void run(const TE* __restrict__ x1s, const TE* __restrict__ x2s,
                           const TX* __restrict__ src, const float* __restrict__ w4s,
                           const float* __restrict__ b4s, float a,
                           const float* __restrict__ As, TO* __restrict__ dst,
                           const CUtensorMap* xmap, int n, int s_own, int own0, int c0,
                           int S, int T, int V, int R, int C) {
  constexpr bool kF32 = sizeof(TX) == 4;   // src: chunks by tensor copy, split into TF32 parts
  constexpr bool kEF32 = sizeof(TE) == 4;  // x1s/x2s: rows by cp.async (bf16: registers)
  constexpr int kU = CT / 4;           // units of 4 channels in the tile
  constexpr int kUW = kU / kWarps;     // units a warp owns in stage 2
  constexpr int kNT = TF / 8;          // 8-frame MMA tiles of a chunk
  constexpr int kNC = CT / 8;          // 8-channel MMA tiles of stage 1
  constexpr int kES = RP + 4;          // row stride of E
  constexpr int kWS = CT + 4;          // row stride of W, in (hi, lo) pairs
  constexpr int kE = 2 * kJ * kES;     // one buffer of E
  constexpr int kEPer = (2 * kJ * RP + kThreads - 1) / kThreads;
  static_assert(kU % kWarps == 0 && kU >= 8, "whole units per warp, 8 units a row");
  static_assert(RP % 8 == 0 && TF % 8 == 0, "whole MMA tiles");

  constexpr int kRS = kU + 1;          // bf16: row stride of a chunk, in units
  constexpr int kFS = frame_units(CT);  // bf16: frame stride of a chunk, in units
  constexpr int kXB = chunk_bytes(TF, CT, sizeof(TX)) / sizeof(TX);  // one chunk, in TX

  extern __shared__ float4 smem4[];
  TX* Xb = reinterpret_cast<TX*>(reinterpret_cast<char*>(smem4) +
                                 ((1024 - smem_addr(smem4) % 1024) % 1024));  // [2][kXB]
  float* M = reinterpret_cast<float*>(Xb + 2 * kXB);             // [kJ][kJ][CT]
  float2* W = reinterpret_cast<float2*>(M + kJ * kJ * CT);       // [RP][kWS]
  float* bias = reinterpret_cast<float*>(W + RP * kWS);          // [CT]
  float* E = bias + CT;                                           // [2][2*kJ][kES]
  float* Ab = E + 2 * kE;                                         // [2][kJ][kJ]
  uint64_t* bar = reinterpret_cast<uint64_t*>(Ab + 2 * kJ * kJ);  // [2]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int SC = S * C;
  const int nsum = (V + kJ - 1) / kJ;
  const int spc = (kFwd ? S : 1) * nsum;  // steps per chunk
  const int nchunks = (T + TF - 1) / TF;
  const int nsteps = nchunks * spc;
  const int src_ld = kFwd ? SC : C;

  struct Step { int tb, s, sum0; };
  auto step_of = [&](int i) {
    const int j = i % spc;
    return Step{(i / spc) * TF, kFwd ? j / nsum : s_own, (j % nsum) * kJ};
  };
  // the u tile's first joint and the v tile's
  auto u_of = [&](const Step& st) { return kFwd ? own0 : st.sum0; };
  auto v_of = [&](const Step& st) { return kFwd ? st.sum0 : own0; };
  // value i (row i / RP, r = i % RP) of step st's E: the x1 rows of the u
  // tile, then the x2 rows of the v tile; zero past R and V
  auto e_src = [&](const Step& st, int i) -> const TE* {
    const int r = i % RP, row = i / RP;
    const int j = (row < kJ ? u_of(st) : v_of(st)) + row % kJ;
    if (row >= 2 * kJ || r >= R || j >= V) return nullptr;
    return (row < kJ ? x1s : x2s) + (((size_t)n * S + st.s) * V + j) * R + r;
  };
  auto e_value = [&](const Step& st, int i) -> float {
    const TE* x = e_src(st, i);
    return x ? Act<TE>::load(x) : 0.f;
  };
  auto e_index = [&](int i) { return (i / RP) * kES + i % RP; };
  // step st's copies into buffer buf: the chunk and the A tile [iu][iv] of
  // As[s]. An f32 chunk: CT/32 tensor copies of TF frames counted on
  // bar[buf]; a bf16 chunk (rows only 8-byte aligned): cp.async a unit,
  // frames tb .. tb + 8 * ceil(nf / 8), zero past T, V and C. f32 x1/x2
  // rows into E[buf] by cp.async; bf16 ones go through registers.
  auto stage = [&](const Step& st, int buf) {
    const int coff = (kFwd ? st.s * C : 0) + c0;
    TX* X = Xb + buf * kXB;
    if constexpr (kF32) {
      if (tid == 0) {
        // whole boxes: past T, V and the tensor's width they read as zero;
        // channels past C (K1: the next subset's) reach only outputs that
        // are not written
        mbar_expect(bar + buf, TF * kJ * CT * 4);
        for (int h = 0; h < CT / 32; ++h) {
          tensor_copy(X + h * TF * kJ * 32, xmap, coff + 32 * h, st.sum0, st.tb, n, bar + buf);
        }
      }
    } else {
      const int nf8 = min(TF, (T - st.tb + 7) / 8 * 8);
      const int nfv = min(nf8, T - st.tb), njv = min(kJ, V - st.sum0);
      auto row_src = [&](int f, int j) {
        return src + (((size_t)n * T + st.tb + f) * V + st.sum0 + j) * src_ld + coff;
      };
      for (int i = tid; i < nf8 * kJ * kU; i += kThreads) {
        const int q = i % kU, j = (i / kU) % kJ, f = i / (kU * kJ);
        const bool ok = f < nfv && j < njv && c0 + 4 * q < C;
        copy_unit(X + 4 * (f * kFS + j * kRS + q), ok ? row_src(f, j) + 4 * q : src, ok);
      }
    }
    if constexpr (kEF32) {
      for (int i = tid; i < 2 * kJ * RP; i += kThreads) {
        const TE* x = e_src(st, i);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         smem_addr(E + buf * kE + e_index(i))),
                     "l"(x ? x : As), "r"(x ? 4 : 0));
      }
    }
    const int u = u_of(st) + tid / kJ, v = v_of(st) + tid % kJ;
    const bool ok = u < V && v < V;
    const float* p = ok ? As + ((size_t)st.s * V + u) * V + v : As;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(Ab + buf * kJ * kJ + tid)),
                 "l"(p), "r"(ok ? 4 : 0));
    copy_commit();
  };
  // W (RP x CT) of w4s[s] as stage 1's operand, split into TF32 parts but
  // for kBf16, and the bias of subset s
  auto load_w = [&](int s) {
    for (int k = tid; k < RP * CT; k += kThreads) {
      const int r = k / CT, c = k % CT;
      const float w = (r < R && c0 + c < C)
                          ? stage1_w<kS1>(w4s[((size_t)s * R + r) * C + c0 + c])
                          : 0.f;
      uint32_t hi = __float_as_uint(w), lo = 0u;
      if constexpr (kS1 != Stage1::kBf16) split(w, hi, lo);
      W[r * kWS + c] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
    }
    for (int c = tid; c < CT; c += kThreads) {
      bias[c] = c0 + c < C ? b4s[(size_t)s * C + c0 + c] : 0.f;
    }
  };

  // stage 2's outputs, rows own (g, g + 8), columns frames (2 t4, 2 t4 + 1)
  // of each 8-frame tile, for the warp's units of 4 channels
  float acc[kUW][kNT][4][4];
#pragma unroll
  for (int w = 0; w < kUW; ++w)
#pragma unroll
    for (int f = 0; f < kNT; ++f)
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[w][f][ch][k] = 0.f;

  // prologue: step 0's copies in flight, its rows in E[0], W of its subset
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  {
    const Step st = step_of(0);
    stage(st, 0);
    if constexpr (!kEF32) {
      for (int i = tid; i < 2 * kJ * RP; i += kThreads) E[e_index(i)] = e_value(st, i);
    }
    load_w(st.s);
  }
  // Step i: its chunk, rows and A tile were copied and W loaded during step
  // i-1. It copies step i+1's chunk and rows while it builds M and
  // aggregates.
  for (int i = 0; i < nsteps; ++i) {
    const int buf = i & 1;
    const Step st = step_of(i);
    copy_wait_all();
    if constexpr (kF32) mbar_wait(bar + buf, (i >> 1) & 1);
    __syncthreads();  // step i's copies, rows and W are in; step i-1 is done
    const bool more = i + 1 < nsteps;
    Step nx = st;
    float e_next[kEPer];
    if (more) {
      nx = step_of(i + 1);
      stage(nx, buf ^ 1);
      if constexpr (!kEF32) {
#pragma unroll
        for (int k = 0; k < kEPer; ++k) e_next[k] = e_value(nx, tid + k * kThreads);
      }
    }

    // ---- stage 1: M = (D @ W + b) * a + A with D = tanh(x1_u - x2_v) built
    // in registers as the A fragments: warp w takes the pairs of u rows w
    // and w + 8 (m tiles of 16 pairs iv = 0..15 of one iu), one after the
    // other, all CT channels
    {
      const int u0 = u_of(st), v0 = v_of(st);
      const float* Ex1 = E + buf * kE;
      const float* Ex2 = Ex1 + kJ * kES;
      const float* At = Ab + buf * kJ * kJ;
#pragma unroll 1
      for (int mi = 0; mi < 2; ++mi) {
        const int iu = warp + mi * kWarps;
        float m[kNC][4];
#pragma unroll
        for (int nc = 0; nc < kNC; ++nc)
#pragma unroll
          for (int k = 0; k < 4; ++k) m[nc][k] = 0.f;
#pragma unroll
        for (int kt = 0; kt < RP / 8; ++kt) {
          // A fragment: rows iv = g, g + 8; k = kt*8 + t4, + 4
          const float* x1 = Ex1 + iu * kES + kt * 8 + t4;
          const float* x2 = Ex2 + g * kES + kt * 8 + t4;
          const float av[4] = {stage1_d<kS1>(x1[0], x2[0]), stage1_d<kS1>(x1[0], x2[8 * kES]),
                               stage1_d<kS1>(x1[4], x2[4]),
                               stage1_d<kS1>(x1[4], x2[8 * kES + 4])};
          uint32_t ahi[4], alo[4];
          if constexpr (kS1 == Stage1::kF32) {
#pragma unroll
            for (int k = 0; k < 4; ++k) split(av[k], ahi[k], alo[k]);
          } else if constexpr (kS1 == Stage1::kK4) {
#pragma unroll
            for (int k = 0; k < 4; ++k) ahi[k] = __float_as_uint(av[k]);  // bf16: exact in TF32
          }
#pragma unroll
          for (int nc = 0; nc < kNC; ++nc) {
            const float2 w0 = W[(kt * 8 + t4) * kWS + nc * 8 + g];
            const float2 w1 = W[(kt * 8 + t4 + 4) * kWS + nc * 8 + g];
            if constexpr (kS1 != Stage1::kBf16) {
              mma_tf32(m[nc], ahi, __float_as_uint(w0.y), __float_as_uint(w1.y));
              if constexpr (kS1 == Stage1::kF32) {
                mma_tf32(m[nc], alo, __float_as_uint(w0.x), __float_as_uint(w1.x));
              }
              mma_tf32(m[nc], ahi, __float_as_uint(w0.x), __float_as_uint(w1.x));
            } else {
              mma_bf16(m[nc], pack_bf16(av[0], av[2]), pack_bf16(av[1], av[3]),
                       pack_bf16(w0.x, w1.x));
            }
          }
        }
        // M [own][summed][c], swizzled units; zero for pairs past V
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int iv = g + 8 * h;
          const bool ok = u0 + iu < V && v0 + iv < V;
          const int own = kFwd ? iu : iv, sum = kFwd ? iv : iu;
          const float Auv = At[iu * kJ + iv];
#pragma unroll
          for (int nc = 0; nc < kNC; ++nc) {
            const int c = nc * 8 + 2 * t4;
            float2 val = make_float2(0.f, 0.f);
            if (ok) {
              val = make_float2(fmaf(m[nc][2 * h] + bias[c], a, Auv),
                                fmaf(m[nc][2 * h + 1] + bias[c + 1], a, Auv));
            }
            *reinterpret_cast<float2*>(M + 4 * unit_at<CT>(own, sum, c / 4) + c % 4) = val;
          }
        }
      }
    }
    if (!kEF32 && more) {
      // step i+1's rows, into the E buffer step i-1 read
      float* En = E + (buf ^ 1) * kE;
#pragma unroll
      for (int k = 0; k < kEPer; ++k) {
        if (tid + k * kThreads < 2 * kJ * RP) En[e_index(tid + k * kThreads)] = e_next[k];
      }
    }
    __syncthreads();  // M is complete; W and the bias are read
    if (more && nx.s != st.s) load_w(nx.s);

    // ---- stage 2: for each of the warp's channels c, out_c[own, t] +=
    // M_c[own, summed] @ X_c[summed, t] over this step's 16 summed joints,
    // summed from zero on the tensor cores, then added in f32 ----
    {
      const int nta = min(kNT, (T - st.tb + 7) / 8);  // MMA tiles with a frame < T
      const TX* X = Xb + buf * kXB;
#pragma unroll
      for (int w = 0; w < kUW; ++w) {
        const int q = warp * kUW + w;
        float part[kNT][4][4];
#pragma unroll
        for (int f = 0; f < kNT; ++f)
#pragma unroll
          for (int ch = 0; ch < 4; ++ch)
#pragma unroll
            for (int k = 0; k < 4; ++k) part[f][ch][k] = 0.f;
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          // A: M rows own g, g + 8; columns summed kt*8 + t4, + 4; 4 channels
          const float4 mv[4] = {
              reinterpret_cast<const float4*>(M)[unit_at<CT>(g, kt * 8 + t4, q)],
              reinterpret_cast<const float4*>(M)[unit_at<CT>(g + 8, kt * 8 + t4, q)],
              reinterpret_cast<const float4*>(M)[unit_at<CT>(g, kt * 8 + t4 + 4, q)],
              reinterpret_cast<const float4*>(M)[unit_at<CT>(g + 8, kt * 8 + t4 + 4, q)]};
          uint32_t mhi[4][4], mlo[4][4];  // [channel][fragment register]
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            split(mv[k].x, mhi[0][k], mlo[0][k]);
            split(mv[k].y, mhi[1][k], mlo[1][k]);
            split(mv[k].z, mhi[2][k], mlo[2][k]);
            split(mv[k].w, mhi[3][k], mlo[3][k]);
          }
#pragma unroll
          for (int f = 0; f < kNT; ++f) {
            if (f < nta) {
              // B: X rows summed kt*8 + t4, + 4; column frame f*8 + g
              float4 x0, x1;
              if constexpr (kF32) {
                // box q / 8, row (f*8 + g)*kJ + j, unit (q % 8) ^ (j % 8)
                const int row = (q / 8) * TF * kJ + (f * 8 + g) * kJ + kt * 8 + t4;
                x0 = unit_load(X, row * 8 + ((q % 8) ^ t4));
                x1 = unit_load(X, (row + 4) * 8 + ((q % 8) ^ (t4 + 4)));
              } else {
                const int u = (f * 8 + g) * kFS + (kt * 8 + t4) * kRS + q;
                x0 = unit_load(X, u);
                x1 = unit_load(X, u + 4 * kRS);
              }
              const float xs0[4] = {x0.x, x0.y, x0.z, x0.w};
              const float xs1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
              for (int ch = 0; ch < 4; ++ch) {
                if constexpr (kF32) {
                  uint32_t h0, l0, h1, l1;
                  split(xs0[ch], h0, l0);
                  split(xs1[ch], h1, l1);
                  mma_tf32(part[f][ch], mhi[ch], l0, l1);
                  mma_tf32(part[f][ch], mlo[ch], h0, h1);
                  mma_tf32(part[f][ch], mhi[ch], h0, h1);
                } else {
                  // a bf16 value is exact in TF32: no remainder
                  const uint32_t b0 = __float_as_uint(xs0[ch]), b1 = __float_as_uint(xs1[ch]);
                  mma_tf32(part[f][ch], mlo[ch], b0, b1);
                  mma_tf32(part[f][ch], mhi[ch], b0, b1);
                }
              }
            }
          }
        }
#pragma unroll
        for (int f = 0; f < kNT; ++f)
#pragma unroll
          for (int ch = 0; ch < 4; ++ch)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[w][f][ch][k] += part[f][ch][k];
      }
    }

    // the chunk's last step: write its frames < T, own joints < V, channels
    // < C (4 at a time, rounded once to TO), and start the next chunk at 0
    if ((i + 1) % spc == 0) {
      const int dst_ld = kFwd ? C : SC;
      const int coff = (kFwd ? 0 : st.s * C) + c0;
#pragma unroll
      for (int w = 0; w < kUW; ++w) {
        const int c = 4 * (warp * kUW + w);
#pragma unroll
        for (int f = 0; f < kNT; ++f) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int own = own0 + g + 8 * (k / 2);
            const int t = st.tb + f * 8 + 2 * t4 + k % 2;
            if (t < T && own < V && c0 + c < C) {
              store4(dst + (((size_t)n * T + t) * V + own) * dst_ld + coff + c,
                     make_float4(acc[w][f][0][k], acc[w][f][1][k], acc[w][f][2][k],
                                 acc[w][f][3][k]));
            }
            acc[w][f][0][k] = acc[w][f][1][k] = acc[w][f][2][k] = acc[w][f][3][k] = 0.f;
          }
        }
      }
    }
  }
}

}  // namespace tiled
}  // namespace unit_ctr_gc
