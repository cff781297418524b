// Native skeleton-augmentation core for the NW-UCLA/NTU data pipeline.
//
// Implements the per-sample preprocessing math of the Python feeder
// (tamgcn_tpu_torch/data/feeder_nucla_gcn.py, reference feeder/feeder_nucla_gcn.py
// :85-130): center on joint 1 of frame 0, random 3-D view rotation + scale
// (train), per-sample min-max normalisation to [-1, 1], temporal resampling
// (train: sorted sample without replacement from the 100x-replicated frame
// list, the exact reference distribution; eval: linspace), and bone/motion
// modality derivation — batched and OpenMP-parallel, so the host CPU keeps the
// device fed where the Python/numpy path cannot.
//
// Randomness: numpy-bit-compatible Philox4x64-10 counter streams keyed on
// (seed, epoch, index) — the SAME streams as the Python feeder's
// np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, epoch,
// index])), including numpy's masked-rejection bounded integers and
// 53-bit-double uniforms, so a given seed yields bit-identical training
// batches regardless of which backend is active.
//
// C ABI only (consumed via ctypes; no pybind11 in this environment).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <unordered_map>
#include <vector>

namespace {

// numpy's Philox4x64-10 bit generator (numpy/random/src/philox/philox.h,
// Random123 constants), exposed with the two draw primitives the feeder
// uses: Generator.integers (masked rejection) and Generator.uniform
// (53-bit next_double).
struct Philox {
  uint64_t ctr[4];
  uint64_t key[2];
  uint64_t buf[4];
  int pos;
  // numpy bitgen-level half-word cache: next_uint32 returns the LOW half of
  // a fresh 64-bit draw first and caches the high half across calls
  // (numpy/random/src/philox/philox.h philox_next32)
  uint32_t uinteger;
  bool has_uint32;

  explicit Philox(uint64_t seed, uint64_t epoch, uint64_t index) {
    ctr[0] = 0;
    ctr[1] = 0;
    ctr[2] = epoch;
    ctr[3] = index;
    key[0] = seed;  // np.random.Philox(key=seed): little-endian 128-bit key
    key[1] = 0;
    pos = 4;  // empty buffer: first next() increments the counter and fills
    uinteger = 0;
    has_uint32 = false;
  }

  static void mulhilo(uint64_t a, uint64_t b, uint64_t* hi, uint64_t* lo) {
    const __uint128_t p = static_cast<__uint128_t>(a) * b;
    *hi = static_cast<uint64_t>(p >> 64);
    *lo = static_cast<uint64_t>(p);
  }

  void block() {
    // numpy increments the counter BEFORE generating each block
    if (++ctr[0] == 0)
      if (++ctr[1] == 0)
        if (++ctr[2] == 0) ++ctr[3];
    uint64_t c0 = ctr[0], c1 = ctr[1], c2 = ctr[2], c3 = ctr[3];
    uint64_t k0 = key[0], k1 = key[1];
    for (int r = 0; r < 10; ++r) {
      if (r) {  // bump the key between rounds (Weyl constants)
        k0 += 0x9E3779B97F4A7C15ULL;
        k1 += 0xBB67AE8584CAA73BULL;
      }
      uint64_t hi0, lo0, hi1, lo1;
      mulhilo(0xD2E7470EE14C6C93ULL, c0, &hi0, &lo0);
      mulhilo(0xCA5A826395121157ULL, c2, &hi1, &lo1);
      const uint64_t n0 = hi1 ^ c1 ^ k0;
      const uint64_t n2 = hi0 ^ c3 ^ k1;
      c0 = n0;
      c1 = lo1;
      c2 = n2;
      c3 = lo0;
    }
    buf[0] = c0;
    buf[1] = c1;
    buf[2] = c2;
    buf[3] = c3;
    pos = 0;
  }

  uint64_t next() {
    if (pos >= 4) block();
    return buf[pos++];
  }

  // numpy philox_next32: low half first, high half cached in the state
  uint32_t next32() {
    if (has_uint32) {
      has_uint32 = false;
      return uinteger;
    }
    const uint64_t v = next();
    uinteger = static_cast<uint32_t>(v >> 32);
    has_uint32 = true;
    return static_cast<uint32_t>(v);
  }

  // numpy next_double: top 53 bits of a full 64-bit draw (the half-word
  // cache is untouched — it only feeds next32)
  double uniform() { return (next() >> 11) * 0x1.0p-53; }

  // numpy Generator.uniform(lo, hi)
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }

  // numpy Generator.integers(lo, hi_inclusive): int64 dtype with the range
  // in 32 bits takes the buffered 32-bit LEMIRE path
  // (numpy/random/src/distributions: bounded_lemire_uint32 via
  // random_bounded_uint64_fill with use_masked=false)
  int64_t randint(int64_t lo, int64_t hi_inclusive) {
    const uint64_t rng = static_cast<uint64_t>(hi_inclusive - lo);
    if (rng == 0) return lo;
    if (rng >= 0xFFFFFFFFULL) {
      // not used by the feeder (ranges are rotation degrees / frame counts);
      // 64-bit Lemire kept for completeness
      const uint64_t rng_excl = rng + 1;
      __uint128_t m = static_cast<__uint128_t>(next()) * rng_excl;
      uint64_t leftover = static_cast<uint64_t>(m);
      if (leftover < rng_excl) {
        const uint64_t threshold = (uint64_t)(-rng_excl) % rng_excl;
        while (leftover < threshold) {
          m = static_cast<__uint128_t>(next()) * rng_excl;
          leftover = static_cast<uint64_t>(m);
        }
      }
      return lo + static_cast<int64_t>(m >> 64);
    }
    const uint32_t rng32 = static_cast<uint32_t>(rng);
    const uint32_t rng_excl = rng32 + 1;
    uint64_t m = static_cast<uint64_t>(next32()) * rng_excl;
    uint32_t leftover = static_cast<uint32_t>(m);
    if (leftover < rng_excl) {
      const uint32_t threshold =
          static_cast<uint32_t>(0xFFFFFFFFu - rng32) % rng_excl;
      while (leftover < threshold) {
        m = static_cast<uint64_t>(next32()) * rng_excl;
        leftover = static_cast<uint32_t>(m);
      }
    }
    return lo + static_cast<int64_t>(m >> 32);
  }
};

// bone (child, parent) pairs, 1-based, NW-UCLA 20 joints
// (reference feeder_nucla_gcn.py:27-28)
const int kBonesNucla[20][2] = {
    {1, 2},  {2, 3},   {3, 3},   {4, 3},   {5, 3},   {6, 5},   {7, 6},
    {8, 7},  {9, 3},   {10, 9},  {11, 10}, {12, 11}, {13, 1},  {14, 13},
    {15, 14}, {16, 15}, {17, 1},  {18, 17}, {19, 18}, {20, 19}};

// NTU RGB+D Kinect-v2 25-joint bone pairs (graphs/ntu_rgb_d.py inward edges
// plus the spine-shoulder root)
const int kBonesNtu[25][2] = {
    {1, 2},   {2, 21},  {3, 21},  {4, 3},   {5, 21},  {6, 5},   {7, 6},
    {8, 7},   {9, 21},  {10, 9},  {11, 10}, {12, 11}, {13, 1},  {14, 13},
    {15, 14}, {16, 15}, {17, 1},  {18, 17}, {19, 18}, {20, 19}, {21, 21},
    {22, 23}, {23, 8},  {24, 25}, {25, 12}};

// bone table for a joint count; nullptr when none exists
inline const int (*bone_table(int V))[2] {
  if (V == 20) return kBonesNucla;
  if (V == 25) return kBonesNtu;
  return nullptr;
}

enum Modality { kJoint = 0, kBone = 1, kMotion = 2 };

// One sample: skeleton (T_in, V, 3) float64 -> out (3, T_out, V, 1) float32.
void augment_one(const double* skel, int t_in, int V, int t_out, int train,
                 int modality, uint64_t seed, uint64_t epoch, uint64_t index,
                 float* out) {
  Philox rng(seed, epoch, index);

  double agx = 0.0, agy = 0.0, sc = 1.0;
  if (train) {
    // parenthesised like CPython's math.radians: x * (pi / 180)
    agx = double(rng.randint(-60, 60)) * (M_PI / 180.0);
    agy = double(rng.randint(-60, 60)) * (M_PI / 180.0);
    sc = rng.uniform(0.5, 1.5);
  }
  // rotation matrix Ry @ Rx @ S (reference :75-83); applied as row-vector
  // x' = x @ M, i.e. out[j] = sum_i x[i] * M[i][j]
  const double cx = std::cos(agx), sx = std::sin(agx);
  const double cy = std::cos(agy), sy = std::sin(agy);
  // Rx = [[1,0,0],[0,cx,sx],[0,-sx,cx]], Ry = [[cy,0,-sy],[0,1,0],[sy,0,cy]]
  // M = Ry @ Rx @ diag(s), with each element written as the exact product
  // chain numpy's two small f64 matmuls produce (zeros drop out of the
  // k-sums), so the train path matches the Python feeder bit-for-bit
  double M[3][3] = {
      {cy * sc, sy * sx * sc, -(sy * cx) * sc},
      {0.0, cx * sc, sx * sc},
      {sy * sc, -(cy * sx) * sc, cy * cx * sc},
  };

  const int n = t_in * V;
  std::vector<double> buf(size_t(n) * 3);
  // center on joint 1 (index 1) of frame 0, then rotate/scale
  const double c0 = skel[0 * V * 3 + 1 * 3 + 0];
  const double c1 = skel[0 * V * 3 + 1 * 3 + 1];
  const double c2 = skel[0 * V * 3 + 1 * 3 + 2];
  double vmin[3] = {1e300, 1e300, 1e300}, vmax[3] = {-1e300, -1e300, -1e300};
  for (int i = 0; i < n; ++i) {
    const double x = skel[i * 3 + 0] - c0;
    const double y = skel[i * 3 + 1] - c1;
    const double z = skel[i * 3 + 2] - c2;
    for (int j = 0; j < 3; ++j) {
      const double v = x * M[0][j] + y * M[1][j] + z * M[2][j];
      buf[size_t(i) * 3 + j] = v;
      vmin[j] = std::min(vmin[j], v);
      vmax[j] = std::max(vmax[j], v);
    }
  }
  // min-max normalise to [-1, 1] per coordinate axis (reference :102-105)
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < 3; ++j)
      buf[size_t(i) * 3 + j] =
          (buf[size_t(i) * 3 + j] - vmin[j]) / (vmax[j] - vmin[j] + 1e-6) * 2.0 -
          1.0;

  // temporal resample indices (reference :108-117). Train: sorted sample
  // WITHOUT replacement from the 100x-replicated frame list — the exact
  // reference distribution (`random.sample(list(np.arange(length)) * 100,
  // time_steps)`), drawn as the same partial Fisher-Yates loop of
  // Generator.integers as transforms.sample_positions_without_replacement
  // so the two backends stay bit-identical.
  std::vector<int> idx(t_out);
  if (train) {
    // partial Fisher-Yates over the VIRTUAL replicated list: only the
    // O(t_out) touched positions live in the map (the feeding path is
    // hot; a materialised t_in*100 pool would be O(100*t_in) per sample)
    const int64_t n = int64_t(t_in) * 100;
    std::unordered_map<int64_t, int64_t> swapped;
    swapped.reserve(size_t(t_out) * 2);
    for (int t = 0; t < t_out; ++t) {
      const int64_t j = rng.randint(t, n - 1);  // numpy integers(t, n)
      auto itj = swapped.find(j);
      idx[t] = int((itj == swapped.end() ? j : itj->second) % t_in);
      auto itt = swapped.find(t);
      swapped[j] = (itt == swapped.end()) ? t : itt->second;
    }
    std::sort(idx.begin(), idx.end());
  } else {
    for (int t = 0; t < t_out; ++t)
      idx[t] = (t_in == 1) ? 0
                           : int(double(t) * double(t_in - 1) / double(t_out - 1));
  }

  // gather to (T_out, V, 3)
  std::vector<double> data(size_t(t_out) * V * 3);
  for (int t = 0; t < t_out; ++t)
    std::memcpy(&data[size_t(t) * V * 3], &buf[size_t(idx[t]) * V * 3],
                sizeof(double) * V * 3);

  const int(*bones)[2] = bone_table(V);
  if (modality == kBone && bones != nullptr) {  // (reference :119-123)
    std::vector<double> bone(size_t(t_out) * V * 3, 0.0);
    for (int t = 0; t < t_out; ++t)
      for (int b = 0; b < V; ++b) {
        const int child = bones[b][0] - 1, parent = bones[b][1] - 1;
        for (int c = 0; c < 3; ++c)
          bone[(size_t(t) * V + child) * 3 + c] =
              data[(size_t(t) * V + child) * 3 + c] -
              data[(size_t(t) * V + parent) * 3 + c];
      }
    data.swap(bone);
  } else if (modality == kMotion) {  // (reference :124-127)
    std::vector<double> motion(size_t(t_out) * V * 3, 0.0);
    for (int t = 0; t + 1 < t_out; ++t)
      for (int i = 0; i < V * 3; ++i)
        motion[size_t(t) * V * 3 + i] =
            data[size_t(t + 1) * V * 3 + i] - data[size_t(t) * V * 3 + i];
    data.swap(motion);
  }

  // layout to (3, T_out, V, 1) float32
  for (int c = 0; c < 3; ++c)
    for (int t = 0; t < t_out; ++t)
      for (int v = 0; v < V; ++v)
        out[(size_t(c) * t_out + t) * V + v] =
            float(data[(size_t(t) * V + v) * 3 + c]);
}

}  // namespace

extern "C" {

// Batched augmentation.
//   skeletons: concatenated (T_i, V, 3) float64 samples
//   offsets:   batch+1 prefix offsets (in frames) into `skeletons`
//   indices:   per-slot RNG stream index (the dataset index)
//   out:       (batch, 3, t_out, V, 1) float32
void tamgcn_augment_batch(const double* skeletons, const int64_t* offsets,
                          const int64_t* indices, int batch, int V, int t_out,
                          int train, int modality, uint64_t seed,
                          uint64_t epoch, float* out) {
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < batch; ++b) {
    const int64_t begin = offsets[b], end = offsets[b + 1];
    augment_one(skeletons + begin * V * 3, int(end - begin), V, t_out, train,
                modality, seed, epoch, uint64_t(indices[b]),
                out + size_t(b) * 3 * t_out * V);
  }
}

int tamgcn_version() { return 3; }

}  // extern "C"
