// K13: exact pose repeatability, one block per descriptor pair.
//
// Replaces mad_tpu/engine/match.py:176-200 (_exact_repeat_body). For pair
// k with rotation R_k, subunit anchor h_k and map anchor l_k, every unique
// subunit anchor x moves to y = (x - h_k) @ R_k^T + l_k (the pose of
// engine/docking.py's start coordinates); the pair's score is
// 100 * #{x : min_b |y - b|^2 < thresh2} / A_hi over the map cloud b.
// Distances are taken directly as (y - b)^2 summed over x, y, z instead
// of the |y|^2 + |b|^2 - 2 y.b expansion of the JAX body; the two differ
// only for anchors within float rounding of the threshold radius.
//
// Bound: arithmetic, A_hi * A_lo * 8 flops a pair (10^9+ a call at bench
// shapes) with no reuse problem: the map cloud is a few tens of KB. Design:
// the map cloud streams through shared memory in tiles that all threads of
// the block share; each thread keeps the moved positions and running
// minima of its anchors in registers. The (pairs, A_hi, A_lo) distance
// tensor of the plain version never exists.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;            // anchors per thread per sweep
constexpr int kTile = 1024;        // map-cloud points per shared tile

__global__ void exact_repeat(const float* __restrict__ hi_cloud, int A_hi,
                             const float* __restrict__ lo_cloud, int A_lo,
                             const float* __restrict__ rot,
                             const float* __restrict__ hi,
                             const float* __restrict__ lo, float thresh2,
                             float* __restrict__ out) {
  __shared__ float tile[kTile * 3];
  __shared__ float R[9], h[3], l[3];
  __shared__ int count;
  const int k = blockIdx.x;
  if (threadIdx.x < 9) R[threadIdx.x] = rot[k * 9 + threadIdx.x];
  if (threadIdx.x < 3) {
    h[threadIdx.x] = hi[k * 3 + threadIdx.x];
    l[threadIdx.x] = lo[k * 3 + threadIdx.x];
  }
  if (threadIdx.x == 0) count = 0;
  __syncthreads();

  for (int base = 0; base < A_hi; base += kThreads * kPer) {
    float y[kPer][3], dmin[kPer];
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int a = base + s * kThreads + threadIdx.x;
      dmin[s] = INFINITY;
      if (a < A_hi) {
        const float x0 = hi_cloud[3 * a] - h[0];
        const float x1 = hi_cloud[3 * a + 1] - h[1];
        const float x2 = hi_cloud[3 * a + 2] - h[2];
#pragma unroll
        for (int e = 0; e < 3; ++e)
          y[s][e] = add_rn(add_rn(add_rn(mul_rn(x0, R[3 * e]),
                                         mul_rn(x1, R[3 * e + 1])),
                                  mul_rn(x2, R[3 * e + 2])),
                           l[e]);
      } else {
        y[s][0] = y[s][1] = y[s][2] = 0.0f;
      }
    }
    for (int t0 = 0; t0 < A_lo; t0 += kTile) {
      const int nt = min(kTile, A_lo - t0);
      __syncthreads();
      for (int j = threadIdx.x; j < nt * 3; j += kThreads)
        tile[j] = lo_cloud[3 * t0 + j];
      __syncthreads();
      for (int b = 0; b < nt; ++b) {
        const float b0 = tile[3 * b], b1 = tile[3 * b + 1],
                    b2 = tile[3 * b + 2];
#pragma unroll
        for (int s = 0; s < kPer; ++s) {
          const float e0 = y[s][0] - b0, e1 = y[s][1] - b1,
                      e2 = y[s][2] - b2;
          dmin[s] = fminf(dmin[s], e0 * e0 + e1 * e1 + e2 * e2);
        }
      }
    }
    int hits = 0;
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int a = base + s * kThreads + threadIdx.x;
      hits += (a < A_hi && dmin[s] < thresh2) ? 1 : 0;
    }
    if (hits) atomicAdd(&count, hits);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int denom = A_hi > 1 ? A_hi : 1;
    out[k] = __fdiv_rn(__fmul_rn(100.0f, (float)count), (float)denom);
  }
}

}  // namespace

MAD_EXPORT int mad_exact_repeat(const float* hi_cloud, int A_hi,
                                const float* lo_cloud, int A_lo,
                                const float* rot, const float* hi,
                                const float* lo, int P, float thresh2,
                                float* out, cudaStream_t stream) {
  if (P == 0) return 0;
  exact_repeat<<<P, kThreads, 0, stream>>>(hi_cloud, A_hi, lo_cloud, A_lo,
                                           rot, hi, lo, thresh2, out);
  return static_cast<int>(cudaGetLastError());
}
