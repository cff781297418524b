// bf16 products on the tensor cores with f32 accumulation: mma.sync
// m16n8k16 with its fragments read from shared memory by ldmatrix (K3's bf16
// form, unit_ctr_gc_bwd_param_bf16.cu), and a block's 128 x 64 tile of a
// product of two bf16 matrices in device memory (tile_product_bf16, K6's
// bf16 form, unit_ctr_gc_bwd_conv3.cu; also K5's bf16 x3 product,
// gcn_tcn_block.cu, whose epilogue and T1's bf16 form, ms_tcn.cu, take the
// fragments and the MMA alone). A bf16 x bf16 product is exact in f32, so
// one MMA takes a term where 3xTF32 takes three.
//
// tile_product_bf16: 8 warps, each 32 x 32 of the tile; the operands arrive
// by cp.async in chunks of 64 k into a ring of kStages buffers, kStages - 1
// chunks in flight while the warps multiply the oldest, one barrier a chunk
// (110 KB of ring: two blocks an SM). The MMAs sum into the caller's f32
// accumulators: the tensor cores truncate once an MMA (k = 16), ~2^-24 of
// the running sum, so that even K = 768 leaves a bf16 output's rounding
// where an f32 sum puts it in all but ~0.2% of the elements.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma_bf16 {

constexpr int kTileM = 128, kTileN = 64;
constexpr int kWarpM = 32;            // rows of a warp's share of the tile (32 columns)
constexpr int kMT = kWarpM / 16;      // its m16 tiles
constexpr int kWarpsN = kTileN / 32;  // warps across a tile's columns
constexpr int kTileThreads = 32 * (kTileM / kWarpM) * kWarpsN;
constexpr int kKC = 64;             // k per staged chunk: four m16n8k16 steps
constexpr int kStages = 4;          // chunks in the ring
// row strides (bf16) of a chunk: A [m][k] (144 bytes), A [k][m] (272 bytes),
// B [k][n] (144 bytes); each puts the 8 rows of an ldmatrix 8x8 in 8
// distinct 16-byte bank groups
constexpr int kLdA = kKC + 8, kLdAT = kTileM + 8, kLdB = kTileN + 8;
constexpr int kAChunk = kTileM * kLdA > kKC * kLdAT ? kTileM * kLdA : kKC * kLdAT;
constexpr int kBChunk = kKC * kLdB;
// the dynamic shared memory of tile_product_bf16's ring
constexpr int kTileSmemBytes = kStages * (kAChunk + kBChunk) * 2;

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

// the two 8x8 bf16 matrices whose rows lanes 0-15 address (lanes 0-7 the
// rows of matrix 0, 8-15 of matrix 1), transposed, each lane's share in r[i]:
// the B fragments (k 0-7, k 8-15) of one n8 tile from a [k][n] tile
__device__ inline void ldmatrix2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(shared_addr(p)));
}

__device__ inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of 16 (8) bytes, zero-filled where `ok` is false (src is then not
// read, but must be a valid address)
__device__ inline void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ inline void copy8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ inline void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc (warp (wm, wn) = (warp / kWarpsN, warp % kWarpsN): rows m0 + kWarpM*wm + 16*mt +
// lane/4 + 8*(i/2), columns n0 + 32*wn + 8*nt + 2*(lane%4) + i%2 of acc[mt][nt][i])
// += A @ B over k in [k_begin, k_end), the products summed in f32. A is bf16
// [m][k] with row stride lda (rows < m_end), or with kAT [k][m] (columns <
// m_end); B is bf16 [k][n] with row stride ldb (columns < n_end); zero past
// the ends. kVecA: A's copies in 16-byte units (lda, k_end or m_end multiples
// of 8), else in 8-byte units (multiples of 4); A 16-byte aligned either
// way. kVecB: B's copies in 16-byte units (ldb and n_end multiples of 8, B
// 16-byte aligned), else B is loaded one value at a time and stored
// synchronously. Smem holds kTileSmemBytes, 16-byte aligned.
template <bool kAT, bool kVecA, bool kVecB>
__device__ inline void tile_product_bf16(const __nv_bfloat16* __restrict__ A, int lda, int m_end,
                                         const __nv_bfloat16* __restrict__ B, int ldb,
                                         int n_end, int m0, int n0, int k_begin, int k_end,
                                         __nv_bfloat16* smem, float (&acc)[kMT][4][4]) {
  constexpr int kAU = kVecA ? 8 : 4;                     // bf16 of one A copy
  constexpr int kARow = kAT ? kTileM / kAU : kKC / kAU;  // copies of one A row
  constexpr int kAPer = kTileM * kKC / kAU / kTileThreads;
  constexpr int kBPer = kVecB ? kKC * kTileN / 8 / kTileThreads : kKC * kTileN / kTileThreads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  __nv_bfloat16* Ab = smem;                       // [kStages][kAChunk]
  __nv_bfloat16* Bb = smem + kStages * kAChunk;   // [kStages][kBChunk]
  const int nk = (k_end - k_begin + kKC - 1) / kKC;

  // chunk kc into buffer kc % kStages
  auto load = [&](int kc) {
    const int k0 = k_begin + kc * kKC;
    __nv_bfloat16* a = Ab + (kc % kStages) * kAChunk;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int q = tid + i * kTileThreads;
      const int row = q / kARow, col = kAU * (q % kARow);
      const int m = kAT ? m0 + col : m0 + row, k = kAT ? k0 + row : k0 + col;
      const bool ok = m < m_end && k < k_end;
      const __nv_bfloat16* src = ok ? (kAT ? A + (size_t)k * lda + m : A + (size_t)m * lda + k) : A;
      __nv_bfloat16* dst = a + row * (kAT ? kLdAT : kLdA) + col;
      if constexpr (kVecA) {
        copy16(dst, src, ok);
      } else {
        copy8(dst, src, ok);
      }
    }
    __nv_bfloat16* b = Bb + (kc % kStages) * kBChunk;
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int q = tid + i * kTileThreads;
      if constexpr (kVecB) {
        const int row = q / (kTileN / 8), col = 8 * (q % (kTileN / 8));
        const bool ok = k0 + row < k_end && n0 + col < n_end;
        copy16(b + row * kLdB + col, ok ? B + (size_t)(k0 + row) * ldb + n0 + col : B, ok);
      } else {
        const int row = q / kTileN, col = q % kTileN;
        const bool ok = k0 + row < k_end && n0 + col < n_end;
        b[row * kLdB + col] = ok ? B[(size_t)(k0 + row) * ldb + n0 + col] : __float2bfloat16(0.f);
      }
    }
  };

#pragma unroll
  for (int kc = 0; kc < kStages - 1; ++kc) {
    if (kc < nk) load(kc);
    commit();  // one group per chunk, empty past the last, so wait<> counts chunks
  }
  for (int kc = 0; kc < nk; ++kc) {
    wait<kStages - 2>();  // chunk kc is in
    __syncthreads();      // ... for every thread; chunk kc - 1's buffer is read
    if (kc + kStages - 1 < nk) load(kc + kStages - 1);
    commit();
    const __nv_bfloat16* a = Ab + (kc % kStages) * kAChunk;
    const __nv_bfloat16* b = Bb + (kc % kStages) * kBChunk;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // [k][n]: matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
        // (k 8-15, n 8-15), transposed: the B fragments of two n tiles
        uint32_t r[4];
        ldmatrix4<true>(r, b + (ks * 16 + (lane & 15)) * kLdB + wn * 32 + np * 16 +
                               (lane >> 4) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int mb = wm * kWarpM + mt * 16;
        uint32_t af[4];
        if constexpr (kAT) {
          // [k][m]: matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
          // (k 8-15, m 8-15), transposed
          ldmatrix4<true>(af, a + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdAT + mb +
                                  ((lane >> 3) & 1) * 8);
        } else {
          // [m][k]: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
          // (m 8-15, k 8-15)
          ldmatrix4<false>(af, a + (mb + (lane & 15)) * kLdA + ks * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }
  wait<0>();  // no copy is left in flight into the caller's shared memory
}

}  // namespace mma_bf16
