// K12: approximate pose repeatability, one warp per descriptor pair.
//
// Replaces mad_tpu/engine/match.py:126-155 (_approx_repeat_body). For
// pair k every unique subunit anchor x moves to
// y = (x - h_k) @ R_k^T + l_k, summed as core/geometry.rows_times does
// (((x0 R_e0 + x1 R_e1) + x2 R_e2) + l_e, each step rounded, no FMA), and
// rounds to the voxel v = rint((y - origin) * inv_voxsp) (half to even, as
// torch.round). The pair's score is 100 * #{x : v in the grid and
// field[v] != 0} / A_hi. The in-grid test is made on the rounded floats, so
// a pose far off the map cannot wrap an integer cast; NaN is out.
//
// Bound: P * A_hi one-byte gathers from the field and ~20 flops each
// (46,848 pairs x 32 anchors at the bench); the field (19.7 MB) stays in
// the 50 MB L2. Design: the whole pair axis in one launch (the plain
// version loops over chunks of 256 pairs with ~15 launches each); a warp
// per pair, since the bench's subunit cloud has only a few tens of unique
// anchors, its lanes striding over them and the count reduced by shuffles.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // pairs per block

__global__ void approx_repeat(const signed char* __restrict__ field, int X,
                              int Y, int Z, const float* __restrict__ cloud,
                              int A_hi, const float* __restrict__ origin,
                              float inv, const float* __restrict__ rot,
                              const float* __restrict__ hi,
                              const float* __restrict__ lo, int P,
                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= P) return;
  float R[9], h[3], l[3], org[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = rot[k * 9 + i];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    h[e] = hi[k * 3 + e];
    l[e] = lo[k * 3 + e];
    org[e] = origin[e];
  }
  const float dims[3] = {static_cast<float>(X), static_cast<float>(Y),
                         static_cast<float>(Z)};
  int cnt = 0;
  for (int a = lane; a < A_hi; a += 32) {
    const float x0 = __fsub_rn(cloud[3 * a], h[0]);
    const float x1 = __fsub_rn(cloud[3 * a + 1], h[1]);
    const float x2 = __fsub_rn(cloud[3 * a + 2], h[2]);
    float v[3];
    bool inb = true;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float y = add_rn(add_rn(add_rn(mul_rn(x0, R[3 * e]),
                                           mul_rn(x1, R[3 * e + 1])),
                                    mul_rn(x2, R[3 * e + 2])),
                             l[e]);
      v[e] = rintf(mul_rn(__fsub_rn(y, org[e]), inv));
      inb = inb && v[e] >= 0.0f && v[e] < dims[e];
    }
    if (inb) {
      const long long idx =
          (static_cast<long long>(v[0]) * Y + static_cast<int>(v[1])) * Z
          + static_cast<int>(v[2]);
      cnt += field[idx] > 0 ? 1 : 0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if (lane == 0) {
    const int denom = A_hi > 1 ? A_hi : 1;
    out[k] = __fdiv_rn(__fmul_rn(100.0f, static_cast<float>(cnt)),
                       static_cast<float>(denom));
  }
}

}  // namespace

// field (X, Y, Z) int8; cloud (A_hi, 3), origin (3), rot (P, 3, 3),
// hi / lo (P, 3) float32; out (P) float32.
MAD_EXPORT int mad_approx_repeat(const signed char* field, int X, int Y,
                                 int Z, const float* cloud, int A_hi,
                                 const float* origin, float inv_voxsp,
                                 const float* rot, const float* hi,
                                 const float* lo, int P, float* out,
                                 cudaStream_t stream) {
  if (P == 0) return 0;
  const int blocks = (P + kWarps - 1) / kWarps;
  approx_repeat<<<blocks, 32 * kWarps, 0, stream>>>(
      field, X, Y, Z, cloud, A_hi, origin, inv_voxsp, rot, hi, lo, P, out);
  return static_cast<int>(cudaGetLastError());
}
