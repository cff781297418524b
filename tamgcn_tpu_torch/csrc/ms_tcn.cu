// Eval multi-scale TCN (T1) for Hopper (sm_90a), f32.
//
// Replaces tools/exp_ms_tcn.py:_kernel (launched by ms_tcn_fused) and
// computes the same function. On the prefix p (N, T, V, 3*BC), with the
// out_bn affines folded into the branch weights, for the branches i = 0, 1
// with dilation d = 1 + i and the stride s:
//
//   y_i[n,t',u,o] = b[i,o] + sum_{k<5} sum_c p[n, t'*s + (k-2)*d, u, i*BC+c] w[i,k,c,o]
//   y_2[n,t',u,c] = max_{j in -1,0,1} p[n, t'*s + j, u, 2*BC+c] * mp[0,c] + mp[1,c]
//
// (frames outside [0, T) are zero for the convs and left out of the max),
// written side by side to out (N, ceil(T/s), V, 3*BC). Any T: at stride 2
// an odd T gives ceil(T/2) frames, as XLA's and PyTorch's convolutions do.
//
// What bounds it on this card. At the NW-UCLA shapes at batch 64 it moves
// 13-26 MB (the prefix in, the output out: 4-8 us at 3.35 TB/s) and does
// 0.09-0.68 G FMAs, which run on the tensor cores as 3xTF32 (3-8 us at 165
// TFLOP/s): the bytes bound it at BC <= 32 and at stride 2, the products
// at BC = 64 and stride 1 (l9-l10).
//
// What the design does about it. Each dilated branch is an implicit GEMM:
// the rows are (output frame, joint), the depth the BC input channels of a
// tap, summed over the five taps. A block owns (sample, TO output frames,
// VJ joints, branch, a slice of NC output channels) and stages once, by
// cp.async (16 bytes where BC % 4 == 0 and the pointers allow, else 4):
// its input frames with the halo, zero outside [0, T) and for the channels
// padded to BCP (a multiple of the MMA's k of 8), rows [frame][joint] with
// a stride of BCP + 4 floats against bank conflicts; at stride 2 the frames
// split by parity into two planes, so that every tap's A operand is one
// contiguous row range (tap k reads plane (k*d) % s from row (k*d / s) *
// VJ); and all five taps' (BCP, NC) weights. A warp takes items of 32
// output rows and up to 32 columns and runs mma_tf32x3.cuh:warp_mma
// (m16n8k8, 3xTF32) over the five taps with the accumulators in registers,
// then writes them with the bias through a shared-memory tile as 16-byte
// stores along the channels. A block has 8 warps where two fit an SM, 16
// where its tile fills the SM's shared memory (BC = 64): the MMAs of one
// warp wait on their operands, so an SM needs 16 warps to keep its tensor
// cores busy. The copies, the max-pool and the weights take their index
// arithmetic once per row (for_rows), not once per copy.
// The max-pool branch needs no product: every conv block takes a share of
// it (its slice of channels, every other row), float4 along the channels,
// while its copies are in flight.
//
// The bf16 form (ms_tcn_bf16): a bf16 prefix and output, f32 w, b and mp, as
// the JAX kernel widens a bf16 prefix to f32 and writes the prefix's dtype
// (tools/exp_ms_tcn.py:51, :69, :78). The same kernel on TP = __nv_bfloat16.
// Its bound is the bytes (the prefix and the output at 2 bytes a value), but
// on an H100 the products took half its time as two TF32 terms on bf16
// planes (with them left out, the tool's pass ran in 48% of the time;
// without the copies in 82%, without the max-pool in 89%), so both the
// staging and the products are redesigned. The input frames are staged as
// 2-byte values by cp.async (16 bytes, 8 channels, where bc % 8 == 0 and the
// prefix is 16-byte aligned; else 8 or 2 bytes) into bf16 planes, half the
// f32 form's. The products are bf16 MMAs (ldmatrix + mma.sync m16n8k16,
// mma_bf16.cuh) over k = bc rounded up to 16: w is split as it is staged
// into three bf16 parts, w = hi + mid + lo exactly (8 significant bits
// each), and a bf16 prefix value times each part is exact in f32, so three
// MMAs a k16 step give the f32 product where two TF32 terms took four MMAs
// of k8 and a split per fragment load. The parts take 6 bytes a weight, so
// they are laid out without padding, each row's 16-byte chunks XOR-swizzled
// by the row (conflict-free ldmatrix), and the outputs go straight from the
// accumulators (no epilogue tile): at bc = 64 a block still holds every
// frame of the tool shapes. The max-pool reads bf16 and every output is
// rounded once to bf16 as it is stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "unit_ctr_gc_common.cuh"

namespace {

using namespace mma_tf32x3;
using bf16 = __nv_bfloat16;

// a prefix value loaded as f32, a result rounded once to the output type
template <typename TP>
using Act = unit_ctr_gc::Act<TP>;

constexpr int kMaxThreads = 512;      // 16 warps where one block fills an SM, else 8
constexpr int kKS = 5;                // taps of the branch convs
constexpr int kSmemLimit = 232448;    // bytes a block may use on sm_90
constexpr int kSmemTwo = 113 * 1024;  // two blocks per SM
constexpr int kSMs = 132;

__host__ __device__ inline int round8(int a) { return (a + 7) / 8 * 8; }
__host__ __device__ inline int round16(int a) { return (a + 15) / 16 * 16; }
// row strides (floats) of the staged input (A) and of the weights and the
// epilogue tile (B): lda % 32 in {4, 12, 20, 28}, ldb % 32 in {8, 24}
__host__ __device__ inline int lda_of(int BCP) { return BCP + 4; }
// the bf16 form's product depth, bc rounded up to an MMA's k of 16, and its
// planes' row stride (values): 16 mod 128 bytes, so that the 8 rows of an
// ldmatrix fall in 8 distinct 16-byte bank groups
__host__ __device__ inline int lda_bf16(int BCK) { return BCK + 8; }
// bytes of one staged row of a plane, for 4-byte (f32) or 2-byte values
__host__ __device__ inline int plane_row_bytes(int BC, int act_bytes) {
  return act_bytes == 4 ? 4 * lda_of(round8(BC)) : 2 * lda_bf16(round16(BC));
}
constexpr int kParts = 3;  // the bf16 parts of a weight
__host__ __device__ inline int ldb_of(int NC) { return NC <= 16 ? 24 : NC + 8; }

struct Tiling {
  int TO = 0, VJ = 0, NC = 0;  // frames, joints and output channels of a block
  int warps = 8;               // 16 where one block fills an SM's shared memory
};

// staged rows of one plane: the frames of TO outputs at dilation 2 (the
// larger halo) times VJ joints, and the rows an item reads past them
constexpr int kMT = 2;  // 16-row MMA tiles of a warp's item (1 was slower)
__host__ __device__ inline int plane_rows(int TO, int VJ, int stride) {
  const int frames = stride == 1 ? TO + 8 : TO + 4;
  const int rows = TO * VJ, tile = 16 * kMT;
  return frames * VJ + ((rows + tile - 1) / tile * tile - rows);
}

// the columns of a warp's item (at most 32: NC = 64 is two items a row
// tile); its epilogue tile holds 8 rows of 16 columns (row stride 24)
constexpr int kItemCols = 32, kStCols = 16, kLdSt = 24;
__host__ __device__ inline int item_cols(int NC) { return NC < kItemCols ? NC : kItemCols; }

// f32: the planes, the weights [5][BCP][ldb] and the epilogue tiles; bf16:
// the planes and the weights' parts [3][5][BCK][NC]
__host__ __device__ inline size_t smem_bytes(const Tiling& t, int BC, int stride,
                                             int act_bytes) {
  const size_t planes = (size_t)stride * plane_rows(t.TO, t.VJ, stride) *
                        plane_row_bytes(BC, act_bytes);
  if (act_bytes == 2) return planes + 2 * (size_t)kParts * kKS * round16(BC) * t.NC;
  const int BCP = round8(BC);
  return planes +
         sizeof(float) * ((size_t)kKS * BCP * ldb_of(t.NC) + (size_t)t.warps * 8 * kLdSt);
}

// the bf16 weights' layout: row R (part, tap, input channel) of NC values,
// its 16-byte chunk j stored at chunk j ^ ((R >> (3 - log2(NC / 8))) & (NC /
// 8 - 1)), so that the 8 rows an ldmatrix reads at one chunk fall in 8
// distinct bank groups
__device__ inline int wswz(int R, int j, int NC) {
  const int L = NC / 8, shift = NC == 64 ? 0 : NC == 32 ? 1 : NC == 16 ? 2 : 3;
  return R * NC + 8 * (j ^ ((R >> shift) & (L - 1)));
}

// w = hi + mid + lo, each bf16 (8 significant bits, the same exponent range
// as f32): exact, each remainder exact in f32
__device__ inline void split3(float w, bf16 (&p)[kParts]) {
  p[0] = __float2bfloat16_rn(w);
  const float r1 = w - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

// rows x units of work over the block's threads without a division per
// unit: a thread keeps one unit column (of at most blockDim.x) and walks rows;
// fn(row, unit)
template <class Fn>
__device__ inline void for_rows(int rows, int units, Fn fn) {
  const int threads = blockDim.x;
  const int cols = units < threads ? units : threads;
  const int step = threads / cols;
  if (threadIdx.x >= step * cols) return;
  for (int r = threadIdx.x / cols; r < rows; r += step) {
    for (int c = threadIdx.x % cols; c < units; c += cols) fn(r, c);
  }
}

// conv block (sample, frame tile and joint tile, branch and channel slice of
// NC columns); a warp's item is 16 * kMT rows of NTW * 8 <= 32 columns. TP:
// the prefix's and the output's type, and the planes' (f32, or bf16: the
// header). vec: 4 values a load, store or weight copy; pv: prefix values a
// copy into the planes (4 or 1 in f32; 8, 4 or 1 in bf16)
template <int NTW, typename TP>
__global__ void __launch_bounds__(kMaxThreads, 1)
ms_tcn_kernel(const TP* __restrict__ prefix, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ mp,
              TP* __restrict__ out, int T, int V, int BC, int stride, int To, int TO,
              int VJ, int vtiles, int NC, int vec, int pv) {
  constexpr bool kF32 = std::is_same_v<TP, float>;
  constexpr int NW = 8 * NTW;  // columns of an item
  extern __shared__ __align__(16) float4 smem4[];
  const int n = blockIdx.z;
  const int nslices = (BC + NC - 1) / NC;
  const int branch = blockIdx.y / nslices, o0 = blockIdx.y % nslices * NC;
  const int t0 = blockIdx.x / vtiles * TO, u0 = blockIdx.x % vtiles * VJ;
  const int nt = min(TO, To - t0), vj = min(VJ, V - u0);
  const int d = branch + 1;
  // the product's depth: bc rounded up to 8 (f32) or 16 (bf16)
  const int P = 3 * BC, BCP = kF32 ? round8(BC) : round16(BC), ldb = ldb_of(NC);
  const int lda = kF32 ? lda_of(BCP) : lda_bf16(BCP);
  constexpr int SC = NW < kStCols ? NW : kStCols;  // columns of the epilogue tile
  const int prow = plane_rows(TO, VJ, stride);
  TP* planes = reinterpret_cast<TP*>(smem4);                         // [stride][prow][lda]
  // f32: [5][BCP][ldb] then St [warps][8][kLdSt]; bf16: Wh [3][5][BCP][NC] swizzled
  float* Ws = reinterpret_cast<float*>(planes + (size_t)stride * prow * lda);
  bf16* Wh = reinterpret_cast<bf16*>(Ws);
  float* St = Ws + (size_t)kKS * BCP * ldb;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int vw = vec ? 4 : 1;  // floats a copy, load or store

  // ---- copies: the input frames of this branch, plane par holding frames
  // tlo + stride*q + par, and the five taps' weights of the slice ----
  const int frames = stride == 1 ? nt + 4 * d : nt + 2 * d;  // per plane
  const int tlo = t0 * stride - 2 * d;
  const TP* pin = prefix + (size_t)n * T * V * P + branch * BC;
  for_rows(stride * frames * vj, BCP / pv, [&](int r, int unit) {
    const int ul = r % vj, pq = r / vj;
    const int q = pq % frames, par = pq / frames;
    const int f = tlo + stride * q + par, c = unit * pv;
    const bool ok = f >= 0 && f < T && c < BC;
    TP* dst = planes + ((size_t)par * prow + q * VJ + ul) * lda + c;
    const TP* src = ok ? pin + ((size_t)f * V + u0 + ul) * P + c : prefix;
    if constexpr (kF32) {
      if (vec) {
        copy16(dst, src, ok);
      } else {
        copy4(dst, src, ok);
      }
    } else if (pv == 8) {  // bf16: 2-byte values as they are
      mma_bf16::copy16(dst, src, ok);
    } else if (pv == 4) {
      mma_bf16::copy8(dst, src, ok);
    } else {
      *dst = ok ? *src : __float2bfloat16(0.f);
    }
  });
  const float* wb = w + (size_t)branch * kKS * BC * BC;
  for_rows(kKS * BCP, NC / vw, [&](int kc, int unit) {  // kc = k * BCP + c
    const int k = kc / BCP, c = kc % BCP, o = unit * vw;
    const bool ok = c < BC && o0 + o < BC;
    const float* src = ok ? wb + ((size_t)k * BC + c) * BC + o0 + o : w;
    if constexpr (kF32) {
      float* dst = Ws + (size_t)kc * ldb + o;
      if (vec) {
        copy16(dst, src, ok);
      } else {
        copy4(dst, src, ok);
      }
    } else {  // through registers, split into the three parts
      const float4 v = !ok ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : vec ? __ldg(reinterpret_cast<const float4*>(src))
                                 : make_float4(__ldg(src), 0.f, 0.f, 0.f);
      const float e[4] = {v.x, v.y, v.z, v.w};
      bf16 parts[4][kParts];
#pragma unroll
      for (int i = 0; i < 4; ++i) split3(e[i], parts[i]);
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const int R = p * kKS * BCP + kc;
        bf16* dst = Wh + wswz(R, o / 8, NC) + o % 8;
        if (vec) {
          const __nv_bfloat162 pair[2] = {__halves2bfloat162(parts[0][p], parts[1][p]),
                                          __halves2bfloat162(parts[2][p], parts[3][p])};
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(pair);
        } else {
          *dst = parts[0][p];
        }
      }
    }
  });
  commit();

  // ---- while the copies fly: this block's share of the max-pool branch,
  // channels o0 .. o0 + NC of the rows r % 2 == branch, kPool rows a thread
  // with all their loads in flight (placed after the products, it was
  // slower) ----
  constexpr int kPool = 4;
  const ptrdiff_t step = (ptrdiff_t)V * P;
  for_rows(((nt * VJ + 1 - branch) / 2 + kPool - 1) / kPool, NC / vw, [&](int i, int unit) {
    const int c = o0 + unit * vw;
    if (c >= BC) return;
    float4 m4[kPool];
    bool keep[kPool];
#pragma unroll
    for (int j = 0; j < kPool; ++j) {
      const int r = 2 * (i * kPool + j) + branch;
      const int ul = r % VJ, tl = r / VJ;
      keep[j] = r < nt * VJ && ul < vj;
      m4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!keep[j]) continue;
      const int tc = (t0 + tl) * stride;
      const TP* p = prefix + (((size_t)n * T + tc) * V + u0 + ul) * P + 2 * BC + c;
      if (vec) {
        float4 a = Act<TP>::load4(p);
        if (tc >= 1) {
          const float4 e = Act<TP>::load4(p - step);
          a = make_float4(fmaxf(a.x, e.x), fmaxf(a.y, e.y), fmaxf(a.z, e.z), fmaxf(a.w, e.w));
        }
        if (tc + 1 < T) {
          const float4 e = Act<TP>::load4(p + step);
          a = make_float4(fmaxf(a.x, e.x), fmaxf(a.y, e.y), fmaxf(a.z, e.z), fmaxf(a.w, e.w));
        }
        m4[j] = a;
      } else {
        float mv = Act<TP>::load(p);
        if (tc >= 1) mv = fmaxf(mv, Act<TP>::load(p - step));
        if (tc + 1 < T) mv = fmaxf(mv, Act<TP>::load(p + step));
        m4[j].x = mv;
      }
    }
#pragma unroll
    for (int j = 0; j < kPool; ++j) {
      if (!keep[j]) continue;
      const int r = 2 * (i * kPool + j) + branch;
      const int ul = r % VJ, tl = r / VJ;
      TP* o = out + (((size_t)n * To + t0 + tl) * V + u0 + ul) * P + 2 * BC + c;
      if (vec) {
        const float4 sc = *reinterpret_cast<const float4*>(mp + c);
        const float4 bi = *reinterpret_cast<const float4*>(mp + BC + c);
        Act<TP>::store4(o, make_float4(fmaf(m4[j].x, sc.x, bi.x), fmaf(m4[j].y, sc.y, bi.y),
                                       fmaf(m4[j].z, sc.z, bi.z), fmaf(m4[j].w, sc.w, bi.w)));
      } else {
        Act<TP>::store(o, fmaf(m4[j].x, mp[c], mp[BC + c]));
      }
    }
  });
  wait<0>();
  __syncthreads();

  // ---- the branch: items of 16 * MT rows and NW columns, by warp ----
  constexpr int MT = kMT;
  const int g = lane / 4, t4 = lane % 4;
  const int rows = nt * VJ;
  const int chunks = NC / NW, items = (rows + 16 * MT - 1) / (16 * MT) * chunks;
  for (int item = warp; item < items; item += warps) {
    const int r0 = item / chunks * 16 * MT, oc = item % chunks * NW;  // first row, column
    float acc[MT][NTW][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 1
    for (int k = 0; k < kKS; ++k) {
      const int kd = k * d;
      const TP* A = planes + ((size_t)(kd % stride) * prow + kd / stride * VJ + r0) * lda;
      if constexpr (kF32) {
        warp_mma<MT, NTW, false>(A, lda, Ws + (size_t)k * BCP * ldb + oc, ldb, BCP / 8, acc);
      } else {
#pragma unroll 2
        for (int ks = 0; ks < BCP / 16; ++ks) {
          uint32_t af[MT][4], bfr[kParts][NTW][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16::ldmatrix4<false>(
                af[mt], A + (mt * 16 + (lane & 15)) * lda + ks * 16 + (lane >> 4) * 8);
          }
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            const int R = (p * kKS + k) * BCP + ks * 16 + (lane & 15);
#pragma unroll
            for (int np = 0; np < NTW / 2; ++np) {
              uint32_t r[4];
              mma_bf16::ldmatrix4<true>(r, Wh + wswz(R, oc / 8 + 2 * np + (lane >> 4), NC));
              bfr[p][2 * np][0] = r[0];
              bfr[p][2 * np][1] = r[1];
              bfr[p][2 * np + 1][0] = r[2];
              bfr[p][2 * np + 1][1] = r[3];
            }
            if constexpr (NTW % 2 == 1) {
              mma_bf16::ldmatrix2_trans(bfr[p][NTW - 1], Wh + wswz(R, oc / 8 + NTW - 1, NC));
            }
          }
#pragma unroll
          for (int p = kParts - 1; p >= 0; --p)  // the small parts first
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int j = 0; j < NTW; ++j) {
                mma_bf16::mma(acc[mt][j], af[mt], bfr[p][j][0], bfr[p][j][1]);
              }
        }
      }
    }
    const float* brow = b + branch * BC + o0 + oc;
    if constexpr (!kF32) {
      // the bias, then straight from the accumulators, each value rounded
      // once to bf16: pairs of channels (vec) or single values
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + mt * 16 + g + 8 * h;
          const int ul = r % VJ, tl = r / VJ;
          if (r >= rows || ul >= vj) continue;
          TP* orow = out + (((size_t)n * To + t0 + tl) * V + u0 + ul) * P + branch * BC + o0 + oc;
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            const int col = j * 8 + 2 * t4, ch = o0 + oc + col;
            if (ch >= BC) continue;
            const float v0 = acc[mt][j][2 * h] + brow[col];
            if (vec) {  // bc % 4 == 0: ch + 1 < bc
              Act<TP>::store2(orow + col, v0, acc[mt][j][2 * h + 1] + brow[col + 1]);
            } else {
              Act<TP>::store(orow + col, v0);
              if (ch + 1 < BC) Act<TP>::store(orow + col + 1, acc[mt][j][2 * h + 1] + brow[col + 1]);
            }
          }
        }
      continue;
    }
    // f32 epilogue: 8 rows and SC columns at a time through the warp's
    // tile, with the bias, then 16-byte stores along the channels
    float* st = St + (size_t)warp * 8 * kLdSt;
#pragma unroll
    for (int part = 0; part < 2 * MT * NW / SC; ++part) {
      // rows 8*half.. of m-tile mi, columns c0..
      const int half = part % 2, mi = part / 2 % MT, c0 = part / (2 * MT) * SC;
#pragma unroll
      for (int j = c0 / 8; j < (c0 + SC) / 8; ++j) {
        const int col = j * 8 + 2 * t4;
        const float b0 = o0 + oc + col < BC ? brow[col] : 0.f;
        const float b1 = o0 + oc + col + 1 < BC ? brow[col + 1] : 0.f;
        *reinterpret_cast<float2*>(st + g * kLdSt + col - c0) =
            make_float2(acc[mi][j][2 * half] + b0, acc[mi][j][2 * half + 1] + b1);
      }
      __syncwarp();
      for (int i = lane; i < 8 * SC / 4; i += 32) {
        const int rl = i / (SC / 4), c = c0 + i % (SC / 4) * 4;
        const int r = r0 + mi * 16 + half * 8 + rl;
        const int ul = r % VJ, tl = r / VJ;
        const int oc4 = o0 + oc + c;  // the slice's channel of the four
        if (r >= rows || ul >= vj || oc4 >= BC) continue;
        TP* o = out + (((size_t)n * To + t0 + tl) * V + u0 + ul) * P + branch * BC + oc4;
        const float4 v4 = *reinterpret_cast<const float4*>(st + rl * kLdSt + c - c0);
        if (vec) {
          Act<TP>::store4(o, v4);
        } else {
          const float e4[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (oc4 + e < BC) Act<TP>::store(o + e, e4[e]);
          }
        }
      }
      __syncwarp();
    }
  }
}

// the tiling of (N, T, V, BC, stride): a slice of NC output channels (the
// smallest of 8, 16, 32, 64 that holds BC, at most 64); the most frames
// whose block of 8 warps fits two an SM (at least 4 frames, or all), else
// whose block of 16 warps fits one, with every joint; fewer joints, then
// narrower slices, where one frame does not fit. At two blocks an SM the
// frame tiles are then cut further while that fills the waves of blocks
// better (the bytes bound these shapes); the tiles are evened out. TO = 0
// where even (1 frame, 1 joint, 8 channels) does not fit. act_bytes: 4 for
// the f32 planes, 2 for the bf16 ones.
inline Tiling tiling(int N, int T, int V, int BC, int stride, int act_bytes) {
  if (T < 1 || V < 1 || BC < 1 || (stride != 1 && stride != 2)) return Tiling{};
  const int To = (T + stride - 1) / stride;
  const int BCP = round8(BC);
  for (int NC = BCP <= 8 ? 8 : BCP <= 16 ? 16 : BCP <= 32 ? 32 : 64; NC >= 8; NC /= 2) {
    for (int VJ = V; VJ >= 1; VJ = VJ > 1 ? (VJ + 1) / 2 : 0) {
      for (const int warps : {8, 16}) {
        const bool two = warps == 8;  // two blocks an SM
        const size_t budget = two ? kSmemTwo : kSmemLimit;
        // bytes of a block without frames, then of each frame (the padding
        // to whole items, at most 31 rows, is left to the loop)
        const size_t fixed = smem_bytes(Tiling{0, VJ, NC, warps}, BC, stride, act_bytes);
        const size_t frame = (size_t)stride * plane_row_bytes(BC, act_bytes) * VJ;
        int TO = budget > fixed ? (int)std::min<size_t>(To, (budget - fixed) / frame) : 0;
        while (TO >= 1 && smem_bytes(Tiling{TO, VJ, NC, warps}, BC, stride, act_bytes) > budget) {
          --TO;
        }
        if (TO < 1 || (two && TO < 4 && TO < To)) continue;
        int tiles = (To + TO - 1) / TO;
        if (two) {
          const long long per_tile =
              (long long)N * ((V + VJ - 1) / VJ) * 2 * ((BC + NC - 1) / NC);
          const long long slots = 2LL * kSMs;
          auto fill = [&](int t) {  // the share of the waves' slots the blocks use
            const long long blocks = per_tile * t;
            return (double)blocks / ((blocks + slots - 1) / slots * slots);
          };
          int best = tiles;
          for (int t = tiles + 1; t <= 4 * tiles && (To + t - 1) / t >= 4; ++t) {
            if (fill(t) > fill(best) + 0.05) best = t;
          }
          tiles = best;
        }
        return Tiling{(To + tiles - 1) / tiles, VJ, NC, warps};
      }
    }
  }
  return Tiling{};
}

template <int NTW, typename TP>
int launch(const TP* prefix, const float* w, const float* b, const float* mp, TP* out,
           int N, int T, int V, int BC, int stride, const Tiling& t, cudaStream_t stream) {
  const size_t smem = smem_bytes(t, BC, stride, sizeof(TP));
  cudaError_t err = cudaFuncSetAttribute(
      ms_tcn_kernel<NTW, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int To = (T + stride - 1) / stride;
  const int vtiles = (V + t.VJ - 1) / t.VJ;
  // 4 values a copy, load or store: 16 bytes of f32, 8 of bf16
  const uintptr_t align = 4 * sizeof(TP);
  const int vec = BC % 4 == 0 && (uintptr_t)prefix % align == 0 && (uintptr_t)w % 16 == 0 &&
                  (uintptr_t)mp % 16 == 0 && (uintptr_t)out % align == 0;
  // the planes' copies: f32 as vec says; bf16 16 bytes where 8 channels of
  // a row are 16-byte aligned, else 8 bytes where vec holds, else 2
  const int pv = sizeof(TP) == 4 ? (vec ? 4 : 1)
                 : BC % 8 == 0 && (uintptr_t)prefix % 16 == 0 ? 8
                 : BC % 4 == 0 && (uintptr_t)prefix % 8 == 0 ? 4 : 1;
  const dim3 grid(((To + t.TO - 1) / t.TO) * vtiles, 2 * ((BC + t.NC - 1) / t.NC), N);
  ms_tcn_kernel<NTW, TP><<<grid, 32 * t.warps, smem, stream>>>(
      prefix, w, b, mp, out, T, V, BC, stride, To, t.TO, t.VJ, vtiles, t.NC, vec, pv);
  return cudaGetLastError();
}

template <typename TP>
int run(const TP* prefix, const float* w, const float* b, const float* mp, TP* out, int N,
        int T, int V, int BC, int stride, void* stream) {
  const Tiling t = tiling(N, T, V, BC, stride, sizeof(TP));
  if (N < 1 || N > 65535 || t.TO < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (item_cols(t.NC)) {
    case 8: return launch<1>(prefix, w, b, mp, out, N, T, V, BC, stride, t, st);
    case 16: return launch<2>(prefix, w, b, mp, out, N, T, V, BC, stride, t, st);
    default: return launch<4>(prefix, w, b, mp, out, N, T, V, BC, stride, t, st);
  }
}

}  // namespace

// The output frames a block owns for one sample of (T, V, BC, stride) in
// the f32 form (bf16 = 0) or the bf16 one, or 0 where the kernel does not
// take the shape: one frame of one joint with the halo, the five taps'
// weights of 8 output channels and the epilogue tiles must fit a block's
// shared memory (BC <= 336 at stride 1 in f32).
extern "C" int ms_tcn_frames_per_block(int T, int V, int BC, int stride, int bf16) {
  return tiling(1, T, V, BC, stride, bf16 ? 2 : 4).TO;
}

// prefix (N,T,V,3*BC), w (2,5,BC,BC) as (in,out), b (2,BC), mp (2,BC) as
// (scale, bias), out (N,ceil(T/stride),V,3*BC): contiguous f32 on the
// device (16-byte copies and stores where BC % 4 == 0 and the pointers are
// 16-byte aligned, else 4-byte ones). Launches on `stream` and returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int ms_tcn_f32(const float* prefix, const float* w, const float* b,
                          const float* mp, float* out, int N, int T, int V, int BC,
                          int stride, void* stream) {
  return run(prefix, w, b, mp, out, N, T, V, BC, stride, stream);
}

// The bf16 form (the header): prefix and out bf16 (8-byte loads and stores
// where BC % 4 == 0 and they are 8-byte aligned), w, b and mp f32 as
// ms_tcn_f32's.
extern "C" int ms_tcn_bf16(const bf16* prefix, const float* w, const float* b,
                           const float* mp, bf16* out, int N, int T, int V, int BC,
                           int stride, void* stream) {
  return run(prefix, w, b, mp, out, N, T, V, BC, stride, stream);
}
