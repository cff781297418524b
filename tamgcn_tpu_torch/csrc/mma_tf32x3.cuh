// f32 products on the tensor cores as 3xTF32, shared by the joint-tiled
// unit-op design (unit_ctr_gc_tiled.cuh), K5 (gcn_tcn_block.cu) and K6
// (unit_ctr_gc_bwd_conv3.cu): the TF32 split, one mma.sync m16n8k8, a warp's
// product of two tiles in shared memory, the cp.async copies that stage
// those tiles, and a block's 64 x 64 tile of a product (tile_product).
//
// 3xTF32: each f32 operand splits into its TF32 high part and the remainder,
// and lo*hi + hi*lo + hi*hi are taken (the dropped lo*lo is ~2^-21 of the
// product). The tensor cores sum with truncation, so warp_mma sums each call's
// k range from zero and adds it to the caller's accumulators with an f32 add
// (rounded to nearest): called once per staged chunk of 16 or 32 k, the
// truncation stays within a chunk.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mma_tf32x3 {

// The TF32 high part of x (round to nearest) and the remainder x - hi
// (exact in f32; the MMA reads its top 11 bits).
__device__ inline void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (4) bytes, zero-filled where `ok` is false (src is then
// not read, but must be a valid address)
__device__ inline void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ inline void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ inline void commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ inline void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[mt][nt] (the m16n8 tile at rows 16*mt, columns 8*nt) += A @ B over k
// = 0 .. 8*ksteps, from shared memory, 3xTF32, summed from zero and then
// added in f32. A is row-major, A[row * lda + k], or with kAT transposed,
// A[k * lda + row]; B is B[k * ldb + col]. Bank-conflict free where lda % 32
// is 4, 12, 20 or 28 (row-major A) or 8 or 24 (transposed A), and ldb % 32
// is 8 or 24. A fragment's lane holds rows g, g+8 and k t4, t4+4 (g = lane /
// 4, t4 = lane % 4); acc[mt][nt][i] is row 16*mt + g + 8*(i / 2), column
// 8*nt + 2*t4 + i % 2. Each k step loads and splits every fragment first,
// then issues the three products term by term, so the MT*NT sums of a term
// are in flight together; every tile is whole (a test per tile in this loop
// slows it).
template <int MT, int NT, bool kAT>
__device__ inline void warp_mma(const float* A, int lda, const float* B, int ldb, int ksteps,
                                float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  float part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float av[4];
      if (kAT) {
        const float* a = A + mt * 16 + (ks * 8 + t4) * lda + g;
        av[0] = a[0];
        av[1] = a[8];
        av[2] = a[4 * lda];
        av[3] = a[4 * lda + 8];
      } else {
        const float* a = A + (mt * 16 + g) * lda + ks * 8 + t4;
        av[0] = a[0];
        av[1] = a[8 * lda];
        av[2] = a[4];
        av[3] = a[8 * lda + 4];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split(av[i], ahi[mt][i], alo[mt][i]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* b = B + (ks * 8 + t4) * ldb + nt * 8 + g;
      split(b[0], bhi[nt][0], blo[nt][0]);
      split(b[4 * ldb], bhi[nt][1], blo[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], alo[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], ahi[mt], blo[nt][0], blo[nt][1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], ahi[mt], bhi[nt][0], bhi[nt][1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

// ---- one 64 x 64 tile of a product by a block of 128 threads ----

constexpr int kTileThreads = 128;  // 2 x 2 warps, each 32 x 32 of the tile
constexpr int kTileM = 64, kTileN = 64;  // the tile
constexpr int kTileLd = kTileM + 8;  // transposed A chunk and B chunk [KC][kTileLd]
// KC (32 or 64) k per staged chunk: the floats of one staged A or B chunk
// (a row-major A chunk is [kTileM][KC + 4]), and the dynamic shared memory
// of tile_product's buffers, Ab then Bb (36 or 72 KB: three blocks an SM)
template <int KC>
__host__ __device__ constexpr int tile_chunk() {
  return KC * kTileLd > kTileM * (KC + 4) ? KC * kTileLd : kTileM * (KC + 4);
}
template <int KC>
__host__ __device__ constexpr int tile_smem_bytes() {
  return 4 * tile_chunk<KC>() * (int)sizeof(float);
}

// Chunk rows k0 .. k0 + KC (those < k_end) and columns c0 .. c0 + 64
// (those < c_end) of a matrix with row stride ld into dst [KC][kTileLd],
// zero elsewhere; 16-byte copies with kVec (ld, c_end and the base multiples
// of 4 floats), else 4-byte ones.
template <int KC, bool kVec>
__device__ inline void tile_rows(float* dst, const float* __restrict__ src, int ld, int k0,
                                 int k_end, int c0, int c_end) {
  if (kVec) {
    for (int i = threadIdx.x; i < KC * kTileN / 4; i += kTileThreads) {
      const int k = i / (kTileN / 4), c = 4 * (i % (kTileN / 4));
      const bool ok = k0 + k < k_end && c0 + c < c_end;
      copy16(dst + k * kTileLd + c, ok ? src + (size_t)(k0 + k) * ld + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < KC * kTileN; i += kTileThreads) {
      const int k = i / kTileN, c = i % kTileN;
      const bool ok = k0 + k < k_end && c0 + c < c_end;
      copy4(dst + k * kTileLd + c, ok ? src + (size_t)(k0 + k) * ld + c0 + c : src, ok);
    }
  }
}

// acc (warp (wm, wn) = (warp / 2, warp % 2): rows m0 + 32*wm + 16*mt + lane/4
// + 8*(i/2), columns n0 + 32*wn + 8*nt + 2*(lane%4) + i%2 of acc[mt][nt][i])
// += A @ B over k in [k_begin, k_end), the tile's operands staged in chunks
// of KC by cp.async into Ab and Bb ([2][tile_chunk<KC>()] floats each,
// 16-byte aligned; tile_smem_bytes<KC>() together), the next chunk copied
// while the warps multiply this one. A is
// [m][k] with row stride lda (rows m0.., those < m_end), or with kAT [k][m]
// (columns m0..); B is [k][n] with row stride ldb (columns n0.., those <
// n_end); zero past the ends. kVecA, kVecB: 16-byte copies (strides, ends
// and bases multiples of 4 floats; for a row-major A, k_end too). After the
// warps have multiplied a chunk, hook(A chunk) runs on every thread.
template <int KC, bool kAT, bool kVecA, bool kVecB, class Hook>
__device__ inline void tile_product(const float* __restrict__ A, int lda, int m_end,
                                    const float* __restrict__ B, int ldb, int n_end, int m0,
                                    int n0, int k_begin, int k_end, float* Ab, float* Bb,
                                    float (&acc)[2][4][4], Hook hook) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  constexpr int kChunk = tile_chunk<KC>(), kLdA = KC + 4;
  const int nk = (k_end - k_begin + KC - 1) / KC;
  auto stage = [&](int kc, int buf) {
    const int k0 = k_begin + kc * KC;
    float* a = Ab + buf * kChunk;
    if (kAT) {
      tile_rows<KC, kVecA>(a, A, lda, k0, k_end, m0, m_end);
    } else if (kVecA) {
      for (int i = tid; i < kTileM * KC / 4; i += kTileThreads) {
        const int r = i / (KC / 4), c = 4 * (i % (KC / 4));
        const bool ok = m0 + r < m_end && k0 + c < k_end;
        copy16(a + r * kLdA + c, ok ? A + (size_t)(m0 + r) * lda + k0 + c : A, ok);
      }
    } else {
      for (int i = tid; i < kTileM * KC; i += kTileThreads) {
        const int r = i / KC, c = i % KC;
        const bool ok = m0 + r < m_end && k0 + c < k_end;
        copy4(a + r * kLdA + c, ok ? A + (size_t)(m0 + r) * lda + k0 + c : A, ok);
      }
    }
    tile_rows<KC, kVecB>(Bb + buf * kChunk, B, ldb, k0, k_end, n0, n_end);
    commit();
  };
  if (nk > 0) stage(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) {
      stage(kc + 1, buf ^ 1);
      wait<1>();
    } else {
      wait<0>();
    }
    __syncthreads();  // chunk kc is in
    const float* a = Ab + buf * kChunk;
    const float* b = Bb + buf * kChunk + wn * 32;
    if (kAT) {
      warp_mma<2, 4, true>(a + wm * 32, kTileLd, b, kTileLd, KC / 8, acc);
    } else {
      warp_mma<2, 4, false>(a + wm * 32 * kLdA, kLdA, b, kTileLd, KC / 8, acc);
    }
    hook(a);
    __syncthreads();  // chunk kc is consumed before its buffer is refilled
  }
}

}  // namespace mma_tf32x3
