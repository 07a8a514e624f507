// K2: x2 Catmull-Rom upsampling of a 3D float32 volume along one axis,
// n -> 2n - 1.
//
// Replaces mad_tpu/ops/convolve.py:184-215 (_upsample_axis). The volume is
// viewed as (outer, n, inner) with the upsampled axis in the middle; the
// output is (outer, 2n - 1, inner) and
//   out[o, 2i, q]     = in[o, i, q]
//   out[o, 2i + 1, q] = ((t0 + t1) + t2) + t3,
//   t_m = w[3 - m] * in[o, clamp(i + m - 1, 0, n - 1), q],
//   w = (-1/16, 9/16, 9/16, -1/16),
// one rounding per product and per sum in that order: the order of the
// shift-add in kernels/upsample.py:upsample_axis_plain (and of
// mad_tpu/ops/convolve.py:200-203), so the two agree bit for bit.
//
// Bound: device memory bandwidth. One thread per output voxel reads its
// one or four inputs (neighbouring threads on neighbouring q, or, on the
// contiguous axis, on overlapping inputs, so each input line comes from
// device memory about once) and writes one float: 4 B in and 4 B out per
// voxel of each pass, against ~10 full-volume passes of the plain version
// (padded copy, four scaled terms, two strided scatters). Index math is
// 32-bit where the volume allows it (64-bit division is emulated).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kEdge = -0.0625f;    // w[0] = w[3] = -1/16
constexpr float kInner = 0.5625f;    // w[1] = w[2] = 9/16

template <typename Idx>
__global__ void upsample_axis(const float* __restrict__ in,
                              float* __restrict__ out, Idx n, Idx inner,
                              Idx total) {
  const Idx t = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const Idx m = 2 * n - 1;
  const Idx q = t % inner;
  const Idx r = t / inner;
  const Idx j = r % m;
  const Idx o = r / m;
  const float* src = in + o * n * inner + q;
  const Idx i = j >> 1;
  if ((j & 1) == 0) {
    out[t] = src[i * inner];
    return;
  }
  // odd output: 0 <= i <= n - 2, so i and i + 1 are in range
  const Idx lo = i > 0 ? i - 1 : 0;
  const Idx hi = i + 2 < n ? i + 2 : n - 1;
  float acc = mul_rn(src[lo * inner], kEdge);
  acc = add_rn(acc, mul_rn(src[i * inner], kInner));
  acc = add_rn(acc, mul_rn(src[(i + 1) * inner], kInner));
  acc = add_rn(acc, mul_rn(src[hi * inner], kEdge));
  out[t] = acc;
}

}  // namespace

// in (outer, n, inner) float32; out (outer, 2n - 1, inner), written whole.
MAD_EXPORT int mad_upsample_axis(const float* in, float* out,
                                 long long outer, long long n,
                                 long long inner, cudaStream_t stream) {
  const long long total = outer * (2 * n - 1) * inner;
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (total + kThreads < (1LL << 32)) {
    upsample_axis<unsigned><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(
        in, out, static_cast<unsigned>(n), static_cast<unsigned>(inner),
        static_cast<unsigned>(total));
  } else {
    upsample_axis<long long><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(in, out, n, inner, total);
  }
  return static_cast<int>(cudaGetLastError());
}
