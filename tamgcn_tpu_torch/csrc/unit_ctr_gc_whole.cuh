// The whole-V design of the unit CTR-GC forward (K1) and x3 gradient (K2),
// for V <= kMaxV joints, where M of 16 channels of one subset for all V x V
// joint pairs fits a block's shared memory. K5's aggregation phase
// (gcn_tcn_block.cu) runs the forward's body and K6's first phase
// (unit_ctr_gc_bwd_conv3.cu) the x3 gradient's, under their own names.
//
// A block of 8 warps owns one sample n and kCT = 16 channels, and walks
// steps: K1's block owns one tile of at most kFT = 16 frames and steps over
// the subsets (the subset sum stays in its registers); K2's owns one subset
// and steps over the frame tiles, building M_s once. At a step it builds M_s
// of its channels in shared memory (stage 1) and adds, for every channel c,
// the product A_c (frames x summed joints) @ B_c (summed x own joints) on
// the tensor cores (stage 2), where A is the step's tile of x3s (K1, summed
// v, own u, B = M_s^T) or of g (K2, summed u, own v, B = M_s). It writes
// each output once, through shared memory in whole 64-byte rows, and uses
// no atomics, so two launches are bitwise equal.
//
// What held the design before this one back (a block per sample and 16
// channels, M of all subsets in shared memory, both stages on the CUDA
// cores): at the training batch 16 a launch had 64-256 blocks of ~109-135
// KB, one or two an SM, 40-80 us whatever its work; its aggregation read 7
// shared words for 10 FMAs; each chunk of frames was loaded between two
// barriers with nothing else in flight; stage 1 ran on the CUDA cores.
//
// What this design does about it (PERF.md says what the card showed on
// the way):
// - Fills the card: K1's frames split into ceil(T / 16) balanced tiles (13
//   frames each at T = 13, 26, 52) and K2 splits over subsets, so a
//   NW-UCLA launch at batch 16 has 192-512 blocks of ~100 KB, two an SM.
//   K1's stage 1 is built again per frame tile: cheap where T is long (R =
//   8 at T = 52); at T = 13 (R = 32) there is one tile.
// - Both products on the tensor cores with mma.sync m16n8k8. Stage 1:
//   (16 pairs (u, v) x RP) @ (RP x 16 channels) per m tile, D = tanh(x1_u -
//   x2_v) computed (accurate tanhf) straight into the A fragments from the
//   x1/x2 rows in shared memory, warps over the pair tiles. Stage 2: per
//   channel, (16 frames x JP) @ (JP x JP), JP = V rounded up to 8, warp w
//   takes channels 2w and 2w + 1, one 8-byte load per fragment element
//   pair. In f32 every product is 3xTF32 (mma_tf32x3.cuh: hi/lo split, lo*hi
//   + hi*lo + hi*hi); the tensor cores sum with truncation, and stage 2
//   keeps at most S * JT * 3 products of a block in one accumulator, well
//   within the 1e-5 of max|out| the kernels are held to. In bf16, stage 1
//   is one bf16 product with f32 accumulation over D and w4s rounded to
//   bf16 (the JAX kernel's), and stage 2 takes M's two TF32 parts against
//   the bf16 activations, exact in TF32 (held in f32 in shared memory).
// - Loads in flight during the products, without registers: the next
//   step's f32 tile is copied by cp.async into the other of two tile
//   buffers while this step runs (bf16: loaded into registers and stored at
//   the next step), and the next subset's x1/x2 rows, w4s rows, bias and
//   A_s by cp.async once stage 1 has read this subset's. (Held in
//   registers, they spilled at 128 registers a thread, two blocks an SM,
//   and every spilled load stalled its thread.)
// - Index arithmetic without divisions: a thread walks its rows (t, j) of a
//   tile by adding; the pairs of stage 1 are decoded with a float
//   reciprocal.
// - Shared memory without bank conflicts for the fragments: the tiles and
//   M are stored in 8-byte units of two channels, the unit index XOR-ed
//   with the row (x_at, m_at), so the 16 lanes of a half warp hit 16
//   distinct 8-byte bank slots.
// Past V = 24 (JT = 4) two tiles and M of 32 x 32 pairs take ~150 KB, one
// block an SM, and the joint-tiled design is faster at most NW-UCLA widths
// (V = 25-32; tools/design_ab.py): kMaxV is 24.
// What bounds it now: at R = 32 stage 1's tanh (the MUFU and its ~25
// instructions a value, D rebuilt by each of C / 16 channel tiles); then
// stage 2's mma.sync rate (3 products per f32 product, ~56% of each MMA
// useful at V = 20, T = 13). Tried on the card and slower: clusters of
// K1's frame-tile blocks sharing M_s through distributed shared memory, and
// blocks of 16 warps over 32 frames.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32x3.cuh"
#include "unit_ctr_gc_common.cuh"
#include "unit_ctr_gc_tiled.cuh"

namespace unit_ctr_gc {
namespace whole {

constexpr int kCT = 16;             // channels per block
constexpr int kFT = 16;             // frames per block at most: one m16 tile
constexpr int kPU = kCT / 2;        // 8-byte units (two channels) of a row
constexpr int kWarps = kThreads / 32;
constexpr int kMaxV = 24;           // joints it takes: JT = ceil(V / 8) <= 3
static_assert(kPU == kWarps, "warp w owns the channel pair w in stage 2");

__host__ __device__ inline int joint_tiles(int V) { return (V + 7) / 8; }
__host__ __device__ inline int frame_tiles(int T) { return (T + kFT - 1) / kFT; }

// Whether the design takes V joints (any S, R <= 32).
__host__ __device__ inline bool takes(int V) { return V >= 1 && V <= kMaxV; }

// The launch of K1 (kFwd: channel tiles, frame tiles, N) or K2 (channel
// tiles, S, N).
inline dim3 grid(bool kFwd, int N, int S, int T, int C) {
  return dim3((C + kCT - 1) / kCT, kFwd ? frame_tiles(T) : S, N);
}

// shared memory in floats: two activation tiles [kFT][JP][kPU] (a step's
// tile, then its output tile; the next step's tile), M [JP][JP][kPU], E
// [2][JP][RP + 4] (the x1 rows, then the x2 rows), w4s's [RP][kCT] as
// copied, W [RP][kCT + 4] as (hi, lo) pairs, the bias [kCT], A_s [JP*JP]
__host__ __device__ inline int smem_floats(int JT, int RP) {
  const int JP = 8 * JT;
  return 2 * kFT * JP * kCT + JP * JP * kCT + 2 * JP * (RP + 4) + RP * kCT +
         2 * RP * (kCT + 4) + kCT + JP * JP;
}

// unit p (channels 2p, 2p + 1) of row (t, k) of X and of the output tile,
// and of row (k, j) of M, in 8-byte units: the unit index XOR-ed with the
// row so that a half warp's fragment loads (X: t = g, k = t4; M: k = t4, j =
// g; g = lane / 4 in 0..3, t4 = lane % 4) hit distinct 8-byte bank slots
template <int JP>
__device__ inline int x_at(int t, int k, int p) {
  return (t * JP + k) * kPU + (p ^ (((k >> 1) + 2 * t) & 7));
}
template <int JP>
__device__ inline int m_at(int k, int j, int p) {
  return (k * JP + j) * kPU + (p ^ ((k + 4 * (j >> 1)) & 7));
}

// two f32 values rounded once to the output type
__device__ inline void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ inline void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

using mma_tf32x3::mma_tf32;
using mma_tf32x3::split;
using tiled::copy_commit;
using tiled::copy_wait_all;

// cp.async of two f32 channels (8 bytes), zero-filled where `ok` is false
__device__ inline void copy8(float2* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 8 : 0));
}
using mma_tf32x3::copy4;  // one f32 value, zero-filled where `ok` is false

// The body of both kernels, a block of kThreads threads at blockIdx =
// (channel tile, K1: frame tile / K2: subset, n). kFwd (K1): src x3s (row
// stride S*C, subset s at s*C), dst out (row stride C), summed v, own u.
// !kFwd (K2): src g (row stride C), dst dx3s (row stride S*C, subset s at
// s*C), summed u, own v. Row (n, t, j) of src or dst at ((n*T + t)*V + j) *
// stride. V <= 8 * JT. x1s/x2s are TE, src TX, dst TO (each float or bf16;
// the unit op's forms take one type for all three) and stage 1 follows kS1.
// kColSum (K2's body alone, K6-bf16's first phase): the block also sums
// each of its output columns over all its rows in f32, before the rounding
// to TO, in a fixed order, into colsum[n * S*C + s*C + c].
template <bool kFwd, int RP, int JT, typename TE, typename TX = TE, typename TO = TX,
          Stage1 kS1 = stage1_of<TE>(), bool kColSum = false>
__device__ inline void run(const TE* __restrict__ x1s, const TE* __restrict__ x2s,
                           const TX* __restrict__ src, const float* __restrict__ w4s,
                           const float* __restrict__ b4s, const float* __restrict__ alpha,
                           const float* __restrict__ As, TO* __restrict__ dst, int S, int T,
                           int V, int R, int C, float* __restrict__ colsum = nullptr) {
  static_assert(!(kColSum && kFwd), "column sums of K2's output only");
  constexpr bool kF32 = sizeof(TX) == 4;   // src: copied, split into TF32 parts
  constexpr bool kEF32 = sizeof(TE) == 4;  // x1s/x2s: copied (bf16: through registers)
  constexpr int JP = 8 * JT;
  constexpr int kES = RP + 4;   // row stride of E
  constexpr int kWS = kCT + 4;  // row stride of W, in (hi, lo) pairs
  constexpr int kXU = kFT * JP * kPU;  // units of one activation tile
  constexpr int kXPer = kXU / kThreads;  // tile units a thread copies
  constexpr int kRows = kThreads / kPU;  // rows (t, j) the block covers per pass
  constexpr int kEPer = (2 * JP * RP + kThreads - 1) / kThreads;
  constexpr int kWPer = (RP * kCT + kThreads - 1) / kThreads;
  constexpr int kAPer = (JP * JP + kThreads - 1) / kThreads;
  static_assert(JP * JP % 4 == 0 && RP * kCT % 4 == 0, "16-byte aligned regions");
  static_assert(kXU % kThreads == 0, "whole tile units per thread");
  static_assert(RP % 8 == 0, "whole k steps in stage 1");

  extern __shared__ float4 smem4[];
  float2* Xb = reinterpret_cast<float2*>(smem4);              // [2][kFT][JP][kPU]
  float2* M = Xb + 2 * kXU;                                    // [JP][JP][kPU]
  float* E = reinterpret_cast<float*>(M + JP * JP * kPU);     // [2][JP][kES]
  float* Wc = E + 2 * JP * kES;                                // [RP][kCT], as copied
  float2* W = reinterpret_cast<float2*>(Wc + RP * kCT);       // [RP][kWS]
  float* bias = reinterpret_cast<float*>(W + RP * kWS);       // [kCT]
  float* Asm = bias + kCT;                                     // [V*V]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c0 = blockIdx.x * kCT;
  const int n = blockIdx.z;
  const int nft = frame_tiles(T);
  // the steps: K1's block owns frame tile blockIdx.y and steps over the
  // subsets; K2's owns subset blockIdx.y and steps over the frame tiles. M
  // is built at every step of K1 and at K2's first.
  const int nsteps = kFwd ? S : nft;
  auto step_s = [&](int i) { return kFwd ? i : (int)blockIdx.y; };
  auto step_ft = [&](int i) { return kFwd ? (int)blockIdx.y : i; };
  auto builds_m = [&](int i) { return kFwd || i == 0; };
  auto frame0 = [&](int i) { return step_ft(i) * T / nft; };
  auto frames = [&](int i) { return (step_ft(i) + 1) * T / nft - frame0(i); };
  const int SC = S * C;
  const int src_ld = kFwd ? SC : C;
  const int dst_ld = kFwd ? C : SC;
  const float a = alpha[0];
  const int VV = V * V;
  const float inv_v = 1.f / V;

  // A thread moves the units p = tid % kPU of the rows r = t * V + j (frame
  // t, joint j) r0, r0 + kRows, ...; (t, j) advance without a division.
  const int up = tid % kPU, r0 = tid / kPU;
  const int t_r0 = r0 / V, j_r0 = r0 % V;
  const int dt = kRows / V, dj = kRows % V;
  const bool c_ok = c0 + 2 * up < C;  // C % 4 == 0: both channels or neither

  // ---- the inputs of a step, loaded ahead of use: the activation tile
  // (f32: copied straight into shared memory; bf16: into registers); and,
  // where M is built, E (f32 copied; bf16 into registers), w4s's rows of
  // the tile's channels, the bias and A_s, all copied ----
  uint32_t xr[kF32 ? 1 : kXPer];  // bf16: two channels a unit
  float er[kEF32 ? 1 : kEPer];     // bf16: E, the x1 rows, then the x2 rows
  auto fetch_x = [&](int step) {
    const int nr = frames(step) * V;
    const TX* p = src + ((size_t)(n * T + frame0(step)) * V + r0) * src_ld +
                  (kFwd ? step_s(step) * C : 0) + c0 + 2 * up;
    float2* X = Xb + (step & 1) * kXU;
    int t = t_r0, j = j_r0;
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      const int r = r0 + k * kRows;
      if (r < nr) {
        if constexpr (kF32) {
          // past C nothing is read (src stands in for the address)
          copy8(X + x_at<JP>(t, j, up), reinterpret_cast<const float*>(c_ok ? p : src), c_ok);
        } else {
          xr[k] = c_ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        }
      }
      p += (size_t)kRows * src_ld;
      t += dt;
      j += dj;
      if (j >= V) {
        j -= V;
        ++t;
      }
    }
    if constexpr (kF32) copy_commit();
  };
  auto put_x = [&](int step) {  // bf16: the registers into the step's tile
    const int nr = frames(step) * V;
    float2* X = Xb + (step & 1) * kXU;
    int t = t_r0, j = j_r0;
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      if (r0 + k * kRows < nr) {
        X[x_at<JP>(t, j, up)] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[k]));
      }
      t += dt;
      j += dj;
      if (j >= V) {
        j -= V;
        ++t;
      }
    }
  };
  // E, w4s's rows and the bias of subset s and A_s, zero past V, R and C;
  // stage 1 of the step before has read them
  auto fetch_params = [&](int s) {
#pragma unroll
    for (int k = 0; k < kEPer; ++k) {
      const int i = tid + k * kThreads;
      const int r = i % RP, row = i / RP, j = row % JP;
      if (row < 2 * JP) {
        const bool ok = j < V && r < R;
        const TE* x = (row < JP ? x1s : x2s) + (((size_t)n * S + s) * V + j) * R + r;
        if constexpr (kEF32) {
          copy4(E + row * kES + r, ok ? x : x1s, ok);
        } else {
          er[k] = ok ? Act<TE>::load(x) : 0.f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWPer; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / kCT, c = i % kCT;
      const bool ok = i < RP * kCT && r < R && c0 + c < C;
      if (i < RP * kCT) copy4(Wc + i, ok ? w4s + ((size_t)s * R + r) * C + c0 + c : w4s, ok);
    }
    if (tid < kCT) {
      const bool ok = c0 + tid < C;
      copy4(bias + tid, ok ? b4s + (size_t)s * C + c0 + tid : b4s, ok);
    }
#pragma unroll
    for (int k = 0; k < kAPer; ++k) {
      const int i = tid + k * kThreads;
      if (i < VV) copy4(Asm + i, As + (size_t)s * VV + i, true);
    }
    copy_commit();
  };
  // W as stage 1's operand (split into TF32 parts but for kBf16); bf16: E
  auto put_params = [&]() {
    if constexpr (!kEF32) {
#pragma unroll
      for (int k = 0; k < kEPer; ++k) {
        const int i = tid + k * kThreads;
        if (i < 2 * JP * RP) E[(i / RP) * kES + i % RP] = er[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kWPer; ++k) {
      const int i = tid + k * kThreads;
      if (i < RP * kCT) {
        const float w = stage1_w<kS1>(Wc[i]);
        uint32_t hi = __float_as_uint(w), lo = 0u;
        if constexpr (kS1 != Stage1::kBf16) split(w, hi, lo);
        W[(i / kCT) * kWS + i % kCT] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
      }
    }
  };

  // ---- stage 1: M_s = (D @ W + b) * a + A_s, D = tanh(x1_u - x2_v) built
  // in registers as the A fragments; warp w takes the tiles of 16 pairs
  // (u, v) w, w + 8, ...; M stored [summed][own][channels] ----
  auto stage1 = [&]() {
    const float* Ex2 = E + JP * kES;
    const int nmt = (VV + 15) / 16;
    for (int mt = warp; mt < nmt; mt += kWarps) {
      const int p0 = mt * 16 + g, p1 = p0 + 8;
      const int q0 = min(p0, VV - 1), q1 = min(p1, VV - 1);
      // u = q / V exactly: q < 2^10 and V <= 24 keep the f32 product within
      // 1e-4 of q / V, and q / V is 1/V or more from the next integer
      const int u0 = (int)(((float)q0 + 0.5f) * inv_v), u1 = (int)(((float)q1 + 0.5f) * inv_v);
      const int v0 = q0 - u0 * V, v1 = q1 - u1 * V;
      const float* xa = E + u0 * kES + t4;
      const float* ya = Ex2 + v0 * kES + t4;
      const float* xb = E + u1 * kES + t4;
      const float* yb = Ex2 + v1 * kES + t4;
      float m[kCT / 8][4];
#pragma unroll
      for (int nc = 0; nc < kCT / 8; ++nc)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[nc][i] = 0.f;
#pragma unroll
      for (int kt = 0; kt < RP / 8; ++kt) {
        // A fragment: rows p0, p1; k = kt*8 + t4, + 4
        const int r = kt * 8;
        const float av[4] = {stage1_d<kS1>(xa[r], ya[r]), stage1_d<kS1>(xb[r], yb[r]),
                             stage1_d<kS1>(xa[r + 4], ya[r + 4]),
                             stage1_d<kS1>(xb[r + 4], yb[r + 4])};
        uint32_t ahi[4], alo[4];
        if constexpr (kS1 == Stage1::kF32) {
#pragma unroll
          for (int i = 0; i < 4; ++i) split(av[i], ahi[i], alo[i]);
        } else if constexpr (kS1 == Stage1::kK4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ahi[i] = __float_as_uint(av[i]);  // bf16: exact in TF32
        }
#pragma unroll
        for (int nc = 0; nc < kCT / 8; ++nc) {
          const float2 w0 = W[(r + t4) * kWS + nc * 8 + g];
          const float2 w1 = W[(r + t4 + 4) * kWS + nc * 8 + g];
          if constexpr (kS1 != Stage1::kBf16) {
            mma_tf32(m[nc], ahi, __float_as_uint(w0.y), __float_as_uint(w1.y));
            if constexpr (kS1 == Stage1::kF32) {
              mma_tf32(m[nc], alo, __float_as_uint(w0.x), __float_as_uint(w1.x));
            }
            mma_tf32(m[nc], ahi, __float_as_uint(w0.x), __float_as_uint(w1.x));
          } else {
            tiled::mma_bf16(m[nc], tiled::pack_bf16(av[0], av[2]),
                            tiled::pack_bf16(av[1], av[3]), tiled::pack_bf16(w0.x, w1.x));
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = h ? p1 : p0;
        if (p < VV) {
          const int u = h ? u1 : u0, v = h ? v1 : v0;
          const int k = kFwd ? v : u, j = kFwd ? u : v;
          const float Auv = Asm[p];
#pragma unroll
          for (int nc = 0; nc < kCT / 8; ++nc) {
            const int c = nc * 8 + 2 * t4;
            M[m_at<JP>(k, j, c / 2)] = make_float2(fmaf(m[nc][2 * h] + bias[c], a, Auv),
                                                   fmaf(m[nc][2 * h + 1] + bias[c + 1], a, Auv));
          }
        }
      }
    }
  };

  // ---- stage 2: out_c[t, j] += sum_k X_c[t, k] M_c[k, j] for the warp's
  // channels 2w, 2w + 1, on the tensor cores ----
  float acc[2][JT][4];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch)
#pragma unroll
    for (int nt = 0; nt < JT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ch][nt][i] = 0.f;
  auto stage2 = [&](const float2* X) {
#pragma unroll
    for (int kt = 0; kt < JT; ++kt) {
      const int k0 = kt * 8 + t4;
      // A: rows (frames) g, g + 8; k = k0, k0 + 4; two channels
      const float2 x00 = X[x_at<JP>(g, k0, warp)], x10 = X[x_at<JP>(g + 8, k0, warp)];
      const float2 x01 = X[x_at<JP>(g, k0 + 4, warp)], x11 = X[x_at<JP>(g + 8, k0 + 4, warp)];
      const float av[2][4] = {{x00.x, x10.x, x01.x, x11.x}, {x00.y, x10.y, x01.y, x11.y}};
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kF32) {
            split(av[ch][i], ahi[ch][i], alo[ch][i]);
          } else {
            ahi[ch][i] = __float_as_uint(av[ch][i]);  // a bf16 value is exact in TF32
            alo[ch][i] = 0u;
          }
        }
#pragma unroll
      for (int nt = 0; nt < JT; ++nt) {
        // B: k = k0, k0 + 4; column (own joint) nt*8 + g
        const float2 b0 = M[m_at<JP>(k0, nt * 8 + g, warp)];
        const float2 b1 = M[m_at<JP>(k0 + 4, nt * 8 + g, warp)];
        const float bv[2][2] = {{b0.x, b1.x}, {b0.y, b1.y}};
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          uint32_t h0, l0, h1, l1;
          split(bv[ch][0], h0, l0);
          split(bv[ch][1], h1, l1);
          if constexpr (kF32) mma_tf32(acc[ch][nt], alo[ch], h0, h1);
          mma_tf32(acc[ch][nt], ahi[ch], l0, l1);
          mma_tf32(acc[ch][nt], ahi[ch], h0, h1);
        }
      }
    }
  };

  float2 csum = make_float2(0.f, 0.f);  // kColSum: the unit's column sums over this thread's rows

  // ---- the steps: each one's inputs are on their way during the previous
  // one's products, into the other of two tile buffers; every part has one
  // call site, so the register arrays stay registers ----
  for (int i = -1; i < nsteps; ++i) {
    if (i < 0) {
      // the tiles and M start at zero: the rows and columns past V stay
      // zero (M) or finite (the tiles), and stage 2 multiplies whole tiles
      for (int z = tid; z < (2 * kXU + JP * JP * kPU) / 2; z += kThreads) {
        smem4[z] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
    } else {
      copy_wait_all();
      __syncthreads();  // step i's inputs are in; step i - 1's products and output are done
      if (builds_m(i)) put_params();
      if constexpr (!kF32) put_x(i);
      __syncthreads();
    }
    if (i + 1 < nsteps) fetch_x(i + 1);
    if (i >= 0 && builds_m(i)) {
      stage1();
      __syncthreads();  // M is in; E, W, the bias and A_s are read
    }
    if (i + 1 < nsteps && builds_m(i + 1)) fetch_params(step_s(i + 1));
    if (i < 0) continue;
    float2* X = Xb + (i & 1) * kXU;
    stage2(X);
    if (kFwd && i + 1 < nsteps) continue;

    // ---- the output of the step's frames: the tile through this step's
    // buffer, then rows of 16 channels (frames < nf, own joints < V,
    // channels < C), rounded once to TO ----
    __syncthreads();  // the tile is read
#pragma unroll
    for (int nt = 0; nt < JT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        X[x_at<JP>(g + 8 * (k / 2), nt * 8 + 2 * t4 + k % 2, warp)] =
            make_float2(acc[0][nt][k], acc[1][nt][k]);
        acc[0][nt][k] = acc[1][nt][k] = 0.f;
      }
    __syncthreads();
    const int nr = frames(i) * V;
    TO* p = dst + ((size_t)(n * T + frame0(i)) * V + r0) * dst_ld +
            (kFwd ? 0 : step_s(i) * C) + c0 + 2 * up;
    int t = t_r0, j = j_r0;
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      if (r0 + k * kRows < nr && c_ok) {
        const float2 o = X[x_at<JP>(t, j, up)];
        store2(p, o);
        if constexpr (kColSum) {
          csum.x += o.x;
          csum.y += o.y;
        }
      }
      p += (size_t)kRows * dst_ld;
      t += dt;
      j += dj;
      if (j >= V) {
        j -= V;
        ++t;
      }
    }
  }
  if constexpr (kColSum) {
    // the kRows threads of unit up, in row order, through the tile buffers
    __syncthreads();  // the last output tile is read
    Xb[tid] = csum;
    __syncthreads();
    if (tid < kPU && c0 + 2 * tid < C) {
      float2 sum = make_float2(0.f, 0.f);
      for (int k = 0; k < kRows; ++k) {
        const float2 v = Xb[k * kPU + tid];
        sum.x += v.x;
        sum.y += v.y;
      }
      float* out = colsum + (size_t)n * SC + step_s(0) * C + c0 + 2 * tid;
      out[0] = sum.x;
      out[1] = sum.y;
    }
  }
}

// Launches the whole-V design through L::whole<RP, JT>(grid, smem,
// stream, x1s, x2s, src, w4s, b4s, alpha, As, dst, S, T, V, R, C) (the
// element types deduced from the pointers), which sets the kernel's shared
// memory, launches it and returns cudaGetLastError(). V <= kMaxV.
template <class L, bool kFwd, int RP, typename TE, typename TX, typename TO>
int launch(const TE* x1s, const TE* x2s, const TX* src, const float* w4s, const float* b4s,
           const float* alpha, const float* As, TO* dst, int N, int S, int T, int V, int R,
           int C, cudaStream_t st) {
  const int JT = joint_tiles(V);
  const dim3 g = grid(kFwd, N, S, T, C);
  const size_t smem = sizeof(float) * (size_t)smem_floats(JT, RP);
  switch (JT) {
    case 1: return L::template whole<RP, 1>(g, smem, st, x1s, x2s, src, w4s, b4s, alpha, As, dst, S, T, V, R, C);
    case 2: return L::template whole<RP, 2>(g, smem, st, x1s, x2s, src, w4s, b4s, alpha, As, dst, S, T, V, R, C);
    case 3: return L::template whole<RP, 3>(g, smem, st, x1s, x2s, src, w4s, b4s, alpha, As, dst, S, T, V, R, C);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace whole
}  // namespace unit_ctr_gc
