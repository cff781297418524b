// bf16 products on the tensor cores with f32 accumulation, for K6's bf16
// form (unit_ctr_gc_bwd_conv3.cu): a block's 64 x 64 tile of a product
// (tile_product_bf16), the same tile and warp layout as mma_tf32x3.cuh's
// tile_product, with mma.sync m16n8k16 bf16 x bf16 and the fragments read
// from shared memory by ldmatrix. A bf16 x bf16 product is exact in f32, so
// one MMA takes a term where 3xTF32 takes three.
//
// The A operand is f32 in device memory (K6's x3 gradient, which the JAX
// kernel keeps in f32 and rounds to bf16 only as the operand of its two
// products, tamgcn_tpu/ops/pallas/ctr_gc.py:545-555): each chunk is loaded
// into registers, handed to the caller's hook unrounded (K6 sums db3 from
// it), rounded once to bf16 and stored. B is bf16 in device memory. The
// next chunk's loads are in flight while the warps multiply this one (two
// buffers, one barrier a chunk). As in tile_product, the tensor cores'
// sum of a chunk starts from zero and is added to the caller's
// accumulators with an f32 add.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32x3.cuh"

namespace mma_bf16 {

constexpr int kTileThreads = mma_tf32x3::kTileThreads;  // 2 x 2 warps, each 32 x 32
constexpr int kTileM = mma_tf32x3::kTileM, kTileN = mma_tf32x3::kTileN;
constexpr int kKC = 32;             // k per staged chunk: two m16n8k16 steps
constexpr int kLdK = kKC + 8;       // row stride (bf16) of an A chunk [m][k]: 80 bytes
constexpr int kLdT = kTileN + 8;    // row stride (bf16) of a chunk [k][64]: 144 bytes
// bf16 of one A and one B chunk buffer; strides of 80 and 144 bytes put the
// 8 rows of an ldmatrix 8x8 in 8 distinct 16-byte bank groups
constexpr int kAChunk = kTileM * kLdK > kKC * kLdT ? kTileM * kLdK : kKC * kLdT;
constexpr int kBChunk = kKC * kLdT;
// the dynamic shared memory of tile_product_bf16's buffers (two of each)
constexpr int kTileSmemBytes = 2 * (kAChunk + kBChunk) * 2;

__device__ inline uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the four 8x8 bf16 matrices whose rows the lanes address (lanes 8i..8i+7
// the rows of matrix i), each lane's share in r[i]; kTrans transposed
template <bool kTrans>
__device__ inline void ldmatrix4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(shared_addr(p)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(shared_addr(p)));
  }
}

__device__ inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint2 pack4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// acc (warp (wm, wn) = (warp / 2, warp % 2): rows m0 + 32*wm + 16*mt + lane/4
// + 8*(i/2), columns n0 + 32*wn + 8*nt + 2*(lane%4) + i%2 of acc[mt][nt][i],
// as tile_product's) += A @ B over k in [k_begin, k_end), with the
// operands rounded to bf16 and the products summed in f32. A is f32: [m][k]
// with row stride lda (rows < m_end, k_end % 4 == 0), or with kAT [k][m]
// (columns < m_end, m_end % 4 == 0), 16-byte aligned rows; B is bf16 [k][n]
// with row stride ldb (columns < n_end); zero past the ends. kVecB: 16-byte
// loads of B (ldb and n_end multiples of 8, B 16-byte aligned), else one
// value at a time. Smem holds kTileSmemBytes, 16-byte aligned. hook(v) runs
// on every float4 of A a thread loads, before its rounding; with kAT a
// thread's float4s are always columns m0 + 4 * (tid % 16) .. + 3.
template <bool kAT, bool kVecB, class Hook>
__device__ inline void tile_product_bf16(const float* __restrict__ A, int lda, int m_end,
                                         const __nv_bfloat16* __restrict__ B, int ldb,
                                         int n_end, int m0, int n0, int k_begin, int k_end,
                                         __nv_bfloat16* smem, float (&acc)[2][4][4],
                                         Hook hook) {
  constexpr int kAPer = kTileM * kKC / 4 / kTileThreads;  // float4s of A a thread loads
  constexpr int kBPer = kVecB ? kKC * kTileN / 8 / kTileThreads : kKC * kTileN / kTileThreads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  __nv_bfloat16* Ab = smem;                 // [2][kAChunk]
  __nv_bfloat16* Bb = smem + 2 * kAChunk;   // [2][kBChunk]
  const int nk = (k_end - k_begin + kKC - 1) / kKC;

  float4 ar[kAPer];
  uint4 br[kVecB ? kBPer : 1];
  unsigned short bs[kVecB ? 1 : kBPer];
  // element (row, column) of a's float4 i of this thread in the chunk: [m][k]
  // rows of 8 float4s, or with kAT [k][m] rows of 16 (column tid % 16)
  auto a_at = [&](int i, int& row, int& col) {
    const int q = tid + i * kTileThreads;
    if (kAT) {
      row = q / (kTileM / 4);
      col = 4 * (q % (kTileM / 4));
    } else {
      row = q / (kKC / 4);
      col = 4 * (q % (kKC / 4));
    }
  };
  auto load = [&](int kc) {
    const int k0 = k_begin + kc * kKC;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      int row, col;
      a_at(i, row, col);
      const int m = kAT ? m0 + col : m0 + row, k = kAT ? k0 + row : k0 + col;
      const bool ok = m < m_end && k < k_end;
      ar[i] = ok ? *reinterpret_cast<const float4*>(kAT ? A + (size_t)k * lda + m
                                                         : A + (size_t)m * lda + k)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      hook(ar[i]);
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int q = tid + i * kTileThreads;
      if constexpr (kVecB) {
        const int row = q / (kTileN / 8), col = 8 * (q % (kTileN / 8));
        const bool ok = k0 + row < k_end && n0 + col < n_end;
        br[i] = ok ? *reinterpret_cast<const uint4*>(B + (size_t)(k0 + row) * ldb + n0 + col)
                   : make_uint4(0u, 0u, 0u, 0u);
      } else {
        const int row = q / kTileN, col = q % kTileN;
        const bool ok = k0 + row < k_end && n0 + col < n_end;
        bs[i] = ok ? *reinterpret_cast<const unsigned short*>(B + (size_t)(k0 + row) * ldb +
                                                              n0 + col)
                   : (unsigned short)0;
      }
    }
  };
  auto store = [&](int buf) {
    __nv_bfloat16* a = Ab + buf * kAChunk;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      int row, col;
      a_at(i, row, col);
      *reinterpret_cast<uint2*>(a + row * (kAT ? kLdT : kLdK) + col) = pack4(ar[i]);
    }
    __nv_bfloat16* b = Bb + buf * kBChunk;
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int q = tid + i * kTileThreads;
      if constexpr (kVecB) {
        *reinterpret_cast<uint4*>(b + (q / (kTileN / 8)) * kLdT + 8 * (q % (kTileN / 8))) = br[i];
      } else {
        *reinterpret_cast<unsigned short*>(b + (q / kTileN) * kLdT + q % kTileN) = bs[i];
      }
    }
  };

  if (nk > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) load(kc + 1);  // in flight during the products
    const __nv_bfloat16* a = Ab + buf * kAChunk;
    const __nv_bfloat16* b = Bb + buf * kBChunk;
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int mb = wm * 32 + mt * 16;
        if constexpr (kAT) {
          // [k][m]: matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
          // (k 8-15, m 8-15), transposed
          ldmatrix4<true>(af[mt], a + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdT + mb +
                                      ((lane >> 3) & 1) * 8);
        } else {
          // [m][k]: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
          // (m 8-15, k 8-15)
          ldmatrix4<false>(af[mt], a + (mb + (lane & 15)) * kLdK + ks * 16 + (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // [k][n]: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
        // (k 8-15, n 8-15), transposed: the B fragments of two n tiles
        uint32_t r[4];
        ldmatrix4<true>(r, b + (ks * 16 + (lane & 15)) * kLdT + wn * 32 + np * 16 +
                               (lane >> 4) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(part[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    if (kc + 1 < nk) store(buf ^ 1);  // the buffer chunk kc - 1 was read from
    __syncthreads();
  }
}

}  // namespace mma_bf16
