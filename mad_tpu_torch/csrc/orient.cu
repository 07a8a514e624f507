// K6: canonical orientation frames, one block per anchor.
//
// Replaces mad_tpu/ops/orient.py:212 (_orient_bodies; its per-anchor
// one_anchor :248-336 with zone_hist_fn, _quantize and _first_k_flagged
// :118-173). Per anchor of one octave (stride 1, or 2 on the upsampled
// octave), as the plain version (kernels/orient.py) computes it:
//   1. border test (the upper bound conservative by one voxel) and the
//      clamped (2r+1)^3 gradient patch; d = g / max(|g|, 1e-30), weight
//      w = sphere mask * (|g| >= cutoff);
//   2. the weighted zone histogram of d with the strict 4-decimal bounds
//      (a direction may fall in several zones or none), quantized to
//      int(c / max(max, 1e-30) * 50);
//   3. up to M main bins with q > 0.8 * max q, the first flagged ones in
//      ascending order (the anchor is rejected with none or more than M);
//   4. per main bin: d @ rot_to_pole[main]^T, its histogram, zones
//      1..Z-2 re-quantized by int(q / max(max, 1) * 50), up to S
//      secondary bins the same way;
//   5. R_final = Rz(-(p_theta - belt_first)[sec]) @ rot_to_pole[main].
// Each product and sum is rounded on its own in the plain version's order;
// atan2f / acosf as core/geometry.spherical_angles calls them.
//
// Offset form (capacity mode, orient.py:356-387 orient_shard, its gathers
// at orient.py:255-263): grad is a shard's x-slab extended by its
// neighbours' rows, its row 0 global row goff. The border test and the
// clamped patch centre stay global; the gathers move into the block (x
// minus goff, clamped to it). The halo of radius * stride * 2 rows covers
// the patch of every anchor inside the border that the shard owns; the
// others are rejected by the border test and written as zeros. The
// single-device call is goff = 0.
//
// Histogram sums: each weight is rounded to a multiple of 2^-40 and added
// with 64-bit integer atomics, so a sum is exact and independent of the
// order of the atomics: the kernel is deterministic. With the default
// Gaussian window off every weight is 0 or 1 and the counts are the plain
// version's integer counts. With gw_sig != 0 the plain version's float
// sums round differently (relative 1e-7), which can flip a quantized bin
// that lies within rounding of an integer; the tests hold both to the same
// agreement share as at gw_sig = 0 (tests/test_torch_orient_refine_cuda.py).
//
// Bound: per anchor the distinct patch voxels (4,913 x 12 B at the default
// patch, overlapping patches counted once) and, per sample of nonzero
// weight and histogram, atan2 / acos, a rotation and the zone tests: the
// phi test of each belt and the theta tests of the zones of the belts
// that hold phi. It is bound by operations. The kernel tests the phi
// bounds of every zone (2 compares x 112), several times what the belts
// need; chip_smoke.py reports the share.
// Design: one block of 256 threads per anchor; the zone bounds and the
// 1 + M histograms live in shared memory (under 23 KB at any patch size),
// so the (anchors, P, zones) masks of the plain version never exist. The
// patch is gathered from the field twice, once per pass, with the same
// arithmetic (the second gather hits L2), so no per-sample state is kept;
// samples of weight 0 skip the zone tests; the rotated histograms of all
// main bins share the second pass; the serial bin selection runs on one
// thread per main bin.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMain = 8;
constexpr int kMaxSec = 16;
constexpr int kMaxZones = 256;
constexpr int kMaxPatch = 1 << 23;  // P weights of 2^40 sum within 64 bits
constexpr float kFixedScale = 1099511627776.0f;  // 2^40
constexpr double kFixedInv = 1.0 / 1099511627776.0;

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

// Patch sample p of the anchor at ``safe``: its direction and weight.
template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ grad, int X,
                                        int Y, int Z, const int safe[3],
                                        int radius, int stride, int p,
                                        const float* __restrict__ mask,
                                        float cutoff, float d[3]) {
  const int D = 2 * radius + 1;
  const int o[3] = {p / (D * D), (p / D) % D, p % D};
  const int dims[3] = {X, Y, Z};
  int q[3];
  for (int j = 0; j < 3; ++j) {
    const int t = safe[j] + (o[j] - radius) * stride;
    q[j] = t < 0 ? 0 : (t > dims[j] - 1 ? dims[j] - 1 : t);
  }
  const T* gp = grad + (((long long)q[0] * Y + q[1]) * Z + q[2]) * 3;
  const float g0 = load_f(gp), g1 = load_f(gp + 1), g2 = load_f(gp + 2);
  const float magn = sqrtf(add_rn(add_rn(mul_rn(g0, g0), mul_rn(g1, g1)),
                                  mul_rn(g2, g2)));
  const float m = magn < 1e-30f ? 1e-30f : magn;
  d[0] = __fdiv_rn(g0, m);
  d[1] = __fdiv_rn(g1, m);
  d[2] = __fdiv_rn(g2, m);
  return mul_rn(__ldg(mask + p), magn >= cutoff ? 1.0f : 0.0f);
}

// Add the fixed-point weight fw to every zone whose strict bounds hold
// for direction d.
__device__ __forceinline__ void add_to_zones(const float d[3],
                                             unsigned long long fw,
                                             const float* zb, int nz,
                                             unsigned long long* hist) {
  float theta = atan2f(d[1], d[0]);
  if (theta < 0.0f) theta = add_rn(theta, MAD_TWO_PI_F);
  const float sth = add_rn(theta, MAD_TWO_PI_F);
  const float c = d[2] < -1.0f ? -1.0f : (d[2] > 1.0f ? 1.0f : d[2]);
  const float phi = acosf(c);
  for (int z = 0; z < nz; ++z) {
    const float* b = zb + 4 * z;
    if (!(phi > b[1] && phi < b[3])) continue;
    if ((theta > b[0] && theta < b[2]) || (sth > b[0] && sth < b[2]))
      atomicAdd(hist + z, fw);
  }
}

__device__ __forceinline__ unsigned long long fixed(float w) {
  return __float2ull_rn(w * kFixedScale);  // exact: a power-of-two scale
}

__device__ __forceinline__ float count(unsigned long long h) {
  return __double2float_rn(__ull2double_rn(h) * kFixedInv);
}

// int(c / m * 50) of every bin, m = max(max bin, lo)
// (kernels/orient._quantize with lo = 1e-30; the secondary
// re-quantization with lo = 1 on ints).
__device__ __forceinline__ int quantize(float c, float m) {
  return (int)mul_rn(__fdiv_rn(c, m), 50.0f);
}

// kernels/orient._first_k_flagged: the first k flagged indices in ascending
// order, padded with the unflagged ones; returns the flagged count.
__device__ __forceinline__ int first_k_flagged(const bool* flag, int n, int k,
                                               int* out) {
  int cnt = 0, got = 0;
  for (int i = 0; i < n; ++i) {
    if (flag[i]) {
      if (got < k) out[got++] = i;
      ++cnt;
    }
  }
  for (int i = 0; i < n && got < k; ++i)
    if (!flag[i]) out[got++] = i;
  return cnt;
}

// core/geometry.rotation_about_z: axis_angle_mat((0, 0, 1), angle).
__device__ __forceinline__ void rot_z(float angle, float R[9]) {
  const float h = mul_rn(angle, 0.5f);
  const float a = cosf(h), s = sinf(h);
  const float b = mul_rn(-0.0f, s), c = mul_rn(-0.0f, s), d = mul_rn(-1.0f, s);
  const float aa = mul_rn(a, a), bb = mul_rn(b, b), cc = mul_rn(c, c),
              dd = mul_rn(d, d);
  const float bc = mul_rn(b, c), ad = mul_rn(a, d), ac = mul_rn(a, c),
              ab = mul_rn(a, b), bd = mul_rn(b, d), cd = mul_rn(c, d);
  R[0] = sub_rn(sub_rn(add_rn(aa, bb), cc), dd);
  R[1] = mul_rn(2.0f, add_rn(bc, ad));
  R[2] = mul_rn(2.0f, sub_rn(bd, ac));
  R[3] = mul_rn(2.0f, sub_rn(bc, ad));
  R[4] = sub_rn(sub_rn(add_rn(aa, cc), bb), dd);
  R[5] = mul_rn(2.0f, add_rn(cd, ab));
  R[6] = mul_rn(2.0f, add_rn(bd, ac));
  R[7] = mul_rn(2.0f, sub_rn(cd, ab));
  R[8] = sub_rn(sub_rn(add_rn(aa, dd), bb), cc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) orient_kernel(
    const T* __restrict__ grad, int X, int Y, int Z, int rx, int ry, int rz,
    int goff, const int* __restrict__ coords,
    const unsigned char* __restrict__ valid, int radius, int stride,
    const float* __restrict__ mask,
    const float* __restrict__ bounds, int nz,
    const float* __restrict__ rot_to_pole, const float* __restrict__ p_theta,
    const float* __restrict__ belt_first, int M, int S, float cutoff,
    int* __restrict__ mains_out, int* __restrict__ secs_out,
    float* __restrict__ rfin_out, unsigned char* __restrict__ ok_out) {
  extern __shared__ unsigned long long smem[];
  const int D = 2 * radius + 1, P = D * D * D;
  unsigned long long* hist = smem;                      // [1 + M][nz]
  float* zb = reinterpret_cast<float*>(hist + (1 + M) * nz);  // [nz][4]
  __shared__ int safe[3], s_ok, s_nmain, s_main[kMaxMain];
  __shared__ float s_R[kMaxMain * 9];
  const int k = blockIdx.x, tid = threadIdx.x;

  for (int i = tid; i < 4 * nz; i += blockDim.x) zb[i] = bounds[i];
  for (int i = tid; i < (1 + M) * nz; i += blockDim.x) hist[i] = 0ull;
  if (tid == 0) {
    const int rs[3] = {rx, ry, rz};
    const int half = radius * stride;
    bool ok = valid[k] != 0;
    for (int j = 0; j < 3; ++j) {
      const int c = coords[3 * k + j];
      ok = ok && (c - half >= 0) && (c + half + 1 <= rs[j] - 1);
      const int lo = c < half ? half : c;
      const int hi = rs[j] - half - 1 < half ? half : rs[j] - half - 1;
      safe[j] = lo < hi ? lo : hi;
    }
    s_ok = ok;
    s_nmain = 0;
    for (int m = 0; m < M; ++m) s_main[m] = 0;
  }
  __syncthreads();
  const int at[3] = {safe[0] - goff, safe[1], safe[2]};   // in the block

  if (s_ok) {
    for (int p = tid; p < P; p += blockDim.x) {
      float d[3];
      const float w = sample(grad, X, Y, Z, at, radius, stride, p, mask,
                             cutoff, d);
      if (w == 0.0f) continue;
      add_to_zones(d, fixed(w), zb, nz, hist);
    }
    __syncthreads();
    if (tid == 0) {
      float mx = count(hist[0]);
      for (int z = 1; z < nz; ++z) mx = fmaxf(mx, count(hist[z]));
      mx = mx < 1e-30f ? 1e-30f : mx;
      int qmax = 0;
      for (int z = 0; z < nz; ++z) {
        const int q = quantize(count(hist[z]), mx);
        qmax = q > qmax ? q : qmax;
      }
      const float thr = mul_rn((float)qmax, 0.8f);
      bool flag[kMaxZones];
      for (int z = 0; z < nz; ++z)
        flag[z] = (float)quantize(count(hist[z]), mx) > thr;
      const int n_main = first_k_flagged(flag, nz, M, s_main);
      s_nmain = n_main;
      s_ok = n_main >= 1 && n_main <= M && qmax > 0;
    }
    __syncthreads();
  }

  if (s_ok) {
    const int n_main = s_nmain;
    for (int i = tid; i < n_main * 9; i += blockDim.x)
      s_R[i] = rot_to_pole[s_main[i / 9] * 9 + i % 9];
    __syncthreads();
    for (int p = tid; p < P; p += blockDim.x) {
      float v[3];
      const float w = sample(grad, X, Y, Z, at, radius, stride, p, mask,
                             cutoff, v);
      if (w == 0.0f) continue;
      const unsigned long long fw = fixed(w);
      for (int m = 0; m < n_main; ++m) {
        const float* R = s_R + 9 * m;
        float d[3];
        for (int j = 0; j < 3; ++j)
          d[j] = add_rn(add_rn(mul_rn(v[0], R[3 * j]),
                               mul_rn(v[1], R[3 * j + 1])),
                        mul_rn(v[2], R[3 * j + 2]));
        add_to_zones(d, fw, zb, nz, hist + (1 + m) * nz);
      }
    }
    __syncthreads();
  }

  // One thread per main slot: its secondary bins, frames and lanes.
  if (tid < M) {
    const int m = tid;
    const bool active = s_ok && m < s_nmain;
    int sec[kMaxSec];
    int n_sec = 0, m1 = 0;
    if (active) {
      const unsigned long long* h = hist + (1 + m) * nz;
      float mx = count(h[0]);
      for (int z = 1; z < nz; ++z) mx = fmaxf(mx, count(h[z]));
      mx = mx < 1e-30f ? 1e-30f : mx;
      for (int z = 1; z < nz - 1; ++z) {
        const int q = quantize(count(h[z]), mx);
        m1 = q > m1 ? q : m1;
      }
      const float den = (float)(m1 < 1 ? 1 : m1);
      int nqmax = 0;
      for (int z = 1; z < nz - 1; ++z) {
        const int nq = quantize((float)quantize(count(h[z]), mx), den);
        nqmax = nq > nqmax ? nq : nqmax;
      }
      const float thr = mul_rn((float)nqmax, 0.8f);
      bool flag[kMaxZones];
      for (int z = 1; z < nz - 1; ++z)
        flag[z - 1] =
            (float)quantize((float)quantize(count(h[z]), mx), den) > thr
            && m1 > 0;
      n_sec = first_k_flagged(flag, nz - 2, S, sec);
    }
    const bool main_ok = active && m1 > 0 && n_sec >= 1 && n_sec <= S;
    mains_out[k * M + m] = s_main[m];
    for (int s = 0; s < S; ++s) {
      const long long lane = ((long long)k * M + m) * S + s;
      float* out = rfin_out + lane * 9;
      if (active) {
        const int sb = sec[s] + 1;
        float Rz[9];
        rot_z(-sub_rn(p_theta[sb], belt_first[sb]), Rz);
        const float* Rm = s_R + 9 * m;
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j)
            out[3 * i + j] = add_rn(add_rn(mul_rn(Rz[3 * i], Rm[j]),
                                           mul_rn(Rz[3 * i + 1], Rm[3 + j])),
                                    mul_rn(Rz[3 * i + 2], Rm[6 + j]));
        secs_out[lane] = sb;
      } else {
        for (int i = 0; i < 9; ++i) out[i] = 0.0f;
        secs_out[lane] = 0;
      }
      ok_out[lane] = (main_ok && s < n_sec) ? 1 : 0;
    }
  }
}

template <typename T>
int launch(const T* grad, int X, int Y, int Z, int rx, int ry, int rz,
           int goff, const int* coords, const unsigned char* valid, int K,
           int radius,
           int stride, const float* mask, const float* bounds, int nz,
           const float* rot_to_pole, const float* p_theta,
           const float* belt_first, int M, int S, float cutoff, int* mains,
           int* secs, float* rfin, unsigned char* ok, cudaStream_t stream) {
  const size_t smem = (size_t)(1 + M) * nz * sizeof(unsigned long long) +
                      (size_t)4 * nz * sizeof(float);
  orient_kernel<T><<<K, kThreads, smem, stream>>>(
      grad, X, Y, Z, rx, ry, rz, goff, coords, valid, radius, stride, mask,
      bounds, nz, rot_to_pole, p_theta, belt_first, M, S, cutoff, mains, secs,
      rfin, ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad_dtype: 0 = float32, 1 = bfloat16 (the (X, Y, Z, 3) field); coords
// (K, 3) int32 voxel coords; tables as ops/orient._OrientTables builds them.
MAD_EXPORT int mad_orient(const void* grad, int grad_dtype, int X, int Y,
                          int Z, int rx, int ry, int rz, int goff,
                          const int* coords,
                          const unsigned char* valid, int K, int radius,
                          int stride, const float* mask, const float* bounds,
                          int nz, const float* rot_to_pole,
                          const float* p_theta, const float* belt_first,
                          int M, int S, float cutoff, int* mains, int* secs,
                          float* rfin, unsigned char* ok,
                          cudaStream_t stream) {
  if (K == 0) return 0;
  const long long D = 2LL * radius + 1;
  if (M < 1 || M > kMaxMain || S < 1 || S > kMaxSec || nz < 3 ||
      nz > kMaxZones || radius < 0 || D * D * D > kMaxPatch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (grad_dtype == 0)
    return launch(static_cast<const float*>(grad), X, Y, Z, rx, ry, rz,
                  goff, coords, valid, K, radius, stride, mask, bounds, nz,
                  rot_to_pole, p_theta, belt_first, M, S, cutoff, mains,
                  secs, rfin, ok, stream);
  return launch(static_cast<const __nv_bfloat16*>(grad), X, Y, Z, rx, ry, rz,
                goff, coords, valid, K, radius, stride, mask, bounds, nz,
                rot_to_pole, p_theta, belt_first, M, S, cutoff, mains, secs,
                rfin, ok, stream);
}
