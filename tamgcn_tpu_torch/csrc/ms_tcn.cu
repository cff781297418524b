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
// 0.09-0.68 G FMAs (3-20 us at the 67 TFLOP/s f32 peak): the bytes bound it
// where BC = 16 (l1-l4), the operations where BC = 64 (l8-l10).
//
// What the design does about it. The TPU kernel keeps the whole (T, V,
// 3*BC) slab of a sample in VMEM and computes every frame, dropping every
// other one at stride 2. Here a block owns (sample, tile of TO output
// frames, role), role 0/1 a conv branch and role 2 the max-pool; it
// computes only the frames it keeps. A conv block stages its input frames
// with their halo of 2*d frames (zero outside [0, T)) in shared memory,
// transposed to [channel][frame*V + joint] so that the rows a warp reads
// sit in different banks, and walks the five taps: for each, it stages that
// tap's (BC, BC) weights and every thread multiplies its RPT rows by its 4
// output channels, one 16-byte weight load and RPT input loads for 4*RPT
// FMAs, with the accumulators in registers over all taps. Output channels
// map to threads, so the stores run along C, which is contiguous in NTVC.
// The max-pool block needs no weights: one thread per output value, loads
// along C. Tensor cores, TMA and keeping the slab for all three roles in
// one block are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKS = 5;                // taps of the branch convs
constexpr int kMaxRPT = 8;            // rows per thread in a conv block
constexpr int kSmemLimit = 232448;    // bytes a block may use on sm_90

__host__ __device__ inline int round4(int a) { return (a + 3) / 4 * 4; }

__device__ inline float4 fma4(float a, float4 w, float4 acc) {
  return make_float4(fmaf(a, w.x, acc.x), fmaf(a, w.y, acc.y),
                     fmaf(a, w.z, acc.z), fmaf(a, w.w, acc.w));
}

// frames a conv block stages for TO output frames at dilation 2 (the larger
// halo), and the row stride of the transposed input (odd: the staging
// stores of consecutive channels fall into other banks)
__host__ __device__ inline int staged_frames(int TO, int stride) {
  return (TO - 1) * stride + 4 * 2 + 1;
}
__host__ __device__ inline int ldx(int TO, int stride, int V) {
  return staged_frames(TO, stride) * V | 1;
}

template <int RPT>
__global__ void __launch_bounds__(kThreads, 2)
ms_tcn_kernel(const float* __restrict__ prefix, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ mp,
              float* __restrict__ out, int T, int V, int BC, int stride,
              int To, int TO, int LDX) {
  extern __shared__ float4 smem4[];
  const int n = blockIdx.z;
  const int role = blockIdx.y;
  const int t0 = blockIdx.x * TO;  // first output frame of the block
  const int nt = min(TO, To - t0);
  const int P = 3 * BC;
  const int tid = threadIdx.x;

  if (role == 2) {
    // ---- max-pool branch: window 3, stride s, padding 1 (left out) ----
    const int items = nt * V * BC;
    for (int idx = tid; idx < items; idx += kThreads) {
      const int c = idx % BC, r = idx / BC;
      const int u = r % V, tc = (t0 + r / V) * stride;
      const float* p = prefix + ((size_t)n * T + tc) * V * P + (size_t)u * P + 2 * BC + c;
      float m = p[0];
      if (tc >= 1) m = fmaxf(m, p[-(ptrdiff_t)V * P]);
      if (tc + 1 < T) m = fmaxf(m, p[(size_t)V * P]);
      out[(((size_t)n * To + t0) * V + r) * P + 2 * BC + c] = fmaf(m, mp[c], mp[BC + c]);
    }
    return;
  }

  // ---- conv branch role, dilation d ----
  const int d = role + 1;
  const int BCP = round4(BC);
  float* Xs = reinterpret_cast<float*>(smem4);  // [BC][LDX]
  float* Ws = Xs + round4(BC * LDX);            // [BC][BCP], one tap
  const int F = (nt - 1) * stride + 4 * d + 1;  // staged input frames
  const int tlo = t0 * stride - 2 * d;          // frame of staged row 0

  // stage the input frames, transposed, zero outside [0, T)
  const float* pin = prefix + (size_t)n * T * V * P + role * BC;
  for (int idx = tid; idx < F * V * BC; idx += kThreads) {
    const int c = idx % BC, row = idx / BC;  // row = local frame * V + joint
    const int t = tlo + row / V;
    Xs[c * LDX + row] =
        (t >= 0 && t < T) ? pin[((ptrdiff_t)tlo * V + row) * P + c] : 0.f;
  }

  // this thread's 4 output channels and RPT rows (local frame, joint)
  const int CG = BCP / 4;
  const int RG = kThreads / CG;
  const int cg = tid % CG, rg = tid / CG;
  const bool active = rg < RG;
  const int o0 = 4 * cg;
  const int rows = nt * V;
  int base[RPT];
  float4 acc[RPT];
  const float* brow = b + role * BC;
  const float4 bias = make_float4(o0 < BC ? brow[o0] : 0.f, o0 + 1 < BC ? brow[o0 + 1] : 0.f,
                                  o0 + 2 < BC ? brow[o0 + 2] : 0.f,
                                  o0 + 3 < BC ? brow[o0 + 3] : 0.f);
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = rg + j * RG;
    // a row past the last computes staged row 0 again and is not kept
    base[j] = r < rows ? (r / V) * stride * V + r % V : 0;
    acc[j] = bias;
  }

  for (int k = 0; k < kKS; ++k) {
    __syncthreads();  // the inputs are staged; the previous tap is consumed
    const float* wk = w + ((size_t)(role * kKS + k) * BC) * BC;
    for (int idx = tid; idx < BC * BCP; idx += kThreads) {
      const int c = idx / BCP, o = idx % BCP;
      Ws[idx] = o < BC ? wk[c * BC + o] : 0.f;
    }
    __syncthreads();
    if (active) {
      const float* xk = Xs + k * d * V;
#pragma unroll 4
      for (int c = 0; c < BC; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(Ws + c * BCP + o0);
        const float* xc = xk + c * LDX;
#pragma unroll
        for (int j = 0; j < RPT; ++j) acc[j] = fma4(xc[base[j]], wv, acc[j]);
      }
    }
  }

  if (!active) return;
  const bool vec = BC % 4 == 0;  // 16-byte aligned rows of 4 channels
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = rg + j * RG;
    if (r >= rows) continue;
    float* o = out + (((size_t)n * To + t0) * V + r) * P + role * BC + o0;
    if (vec) {
      *reinterpret_cast<float4*>(o) = acc[j];
    } else {
      const float v4[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (o0 + q < BC) o[q] = v4[q];
      }
    }
  }
}

template <int RPT>
int launch(const float* prefix, const float* w, const float* b,
           const float* mp, float* out, int N, int T, int V, int BC,
           int stride, int To, int TO, cudaStream_t stream) {
  const int LDX = ldx(TO, stride, V);
  const size_t smem = sizeof(float) * ((size_t)round4(BC * LDX) + (size_t)BC * round4(BC));
  cudaError_t err = cudaFuncSetAttribute(
      ms_tcn_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((To + TO - 1) / TO, 3, N);
  ms_tcn_kernel<RPT><<<grid, kThreads, smem, stream>>>(prefix, w, b, mp, out, T, V, BC,
                                                       stride, To, TO, LDX);
  return cudaGetLastError();
}

}  // namespace

// The output frames a conv block owns for (T, V, BC, stride), or 0 where
// the kernel does not take the shape: a block's rows must fit its threads'
// registers (V <= 8 * 256 / ceil(BC / 4)) and its staged frames and one
// tap's weights its shared memory.
extern "C" int ms_tcn_frames_per_block(int T, int V, int BC, int stride) {
  if (T < 1 || V < 1 || BC < 1 || (stride != 1 && stride != 2)) return 0;
  const int CG = round4(BC) / 4;
  if (CG > kThreads) return 0;
  const int To = (T + stride - 1) / stride;
  int TO = kThreads / CG * kMaxRPT / V;
  if (TO > To) TO = To;
  auto smem = [&](int to) {
    return sizeof(float) * ((size_t)round4(BC * ldx(to, stride, V)) + (size_t)BC * round4(BC));
  };
  while (TO >= 1 && smem(TO) > (size_t)kSmemLimit) --TO;
  if (TO < 1) return 0;
  const int tiles = (To + TO - 1) / TO;
  return (To + tiles - 1) / tiles;  // the same work in fewer, even tiles
}

// prefix (N,T,V,3*BC), w (2,5,BC,BC) as (in,out), b (2,BC), mp (2,BC) as
// (scale, bias), out (N,ceil(T/stride),V,3*BC): contiguous f32 on the
// device, out 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int ms_tcn_f32(const float* prefix, const float* w, const float* b,
                          const float* mp, float* out, int N, int T, int V,
                          int BC, int stride, void* stream) {
  const int TO = ms_tcn_frames_per_block(T, V, BC, stride);
  if (N < 1 || N > 65535 || TO < 1) return cudaErrorInvalidValue;
  const int To = (T + stride - 1) / stride;
  const int CG = round4(BC) / 4;
  const int RPT = (TO * V + kThreads / CG - 1) / (kThreads / CG);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (RPT) {
    case 1: return launch<1>(prefix, w, b, mp, out, N, T, V, BC, stride, To, TO, st);
    case 2: return launch<2>(prefix, w, b, mp, out, N, T, V, BC, stride, To, TO, st);
    case 3: return launch<3>(prefix, w, b, mp, out, N, T, V, BC, stride, To, TO, st);
    case 4: return launch<4>(prefix, w, b, mp, out, N, T, V, BC, stride, To, TO, st);
    case 5: return launch<5>(prefix, w, b, mp, out, N, T, V, BC, stride, To, TO, st);
    case 6: return launch<6>(prefix, w, b, mp, out, N, T, V, BC, stride, To, TO, st);
    case 7: return launch<7>(prefix, w, b, mp, out, N, T, V, BC, stride, To, TO, st);
    default: return launch<kMaxRPT>(prefix, w, b, mp, out, N, T, V, BC, stride, To, TO, st);
  }
}
