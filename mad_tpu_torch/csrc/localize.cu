// K5: Newton subvoxel localization of LoG peaks, with saddle rejection.
//
// Replaces mad_tpu/ops/detect.py:125-163 (localize) with _hessian_grad
// (:54-70), _inv3 (:73-88) and _neg_semidefinite (:91-103). One thread
// per peak runs up to n_iter steps:
//   1. gather the 3x3x3 patch at pos;
//   2. finite-difference H and G;
//   3. H^-1 by adjugate over the cofactor determinant, ok = |det| > 1e-20;
//   4. off = -(((Hinv[:,0] G0) + (Hinv[:,1] G1)) + (Hinv[:,2] G2));
//   5. accepted now when every |off| < max_offset and ok;
//   6. otherwise walk one voxel per axis where |off| > max_offset, if
//      pos - 1 > 0 (down) or pos + 1 < real - 1 (up);
//   7. accepted or bad (not ok) freezes the peak.
// A frozen peak's state never changes again (kernels/localize.py's
// update keeps accepted and bad exclusive), so the thread stops there.
// After the loop the last H takes the saddle test (trace <= 0, principal
// 2x2 minors summed >= 0, det <= 0).
//
// Every product, sum and quotient is one IEEE rounding in the order of
// the plain version's torch ops (no FMA contraction), and max_offset and
// 1e-20 are compared as float (what PyTorch does with a Python float
// against a float32 tensor), so the kernel equals localize_plain bit for
// bit. The patch is placed as mad_tpu's lax.dynamic_slice places it: per
// axis the start s = pos - 1 becomes s + n when negative (n the volume's
// extent), then is clamped to [0, n - 3] (kernels/localize.patch_index);
// pos itself is not clamped.
//
// Offset form (capacity mode, detect.py:236-275 detect_shard): vol is a
// shard's x-slab extended by its neighbours' rows, whose row 0 is global
// row goff of a field of nx rows. The walk and its bounds stay global; the
// x start is placed by the rule above with the field's extent nx, then
// moved into the block (minus goff, clamped to [0, X - 3]). The halo of
// 2 + n_iter rows covers the walk of every seed the shard owns. The
// single-device call is goff = 0, nx = X.
//
// Bound: latency. ~400 peaks an octave, each a chain of 5 dependent
// steps of 27 gathers and ~150 flops: the work (~0.2 MB, ~1 kflop a
// peak) is under a microsecond of the card; one launch replaces the
// ~300 small launches of the plain walk.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

// ((a00 a11) a22 + (a01 a12) a20 + (a02 a10) a21
//  - (a02 a11) a20 - (a00 a12) a21 - (a01 a10) a22), left to right.
__device__ __forceinline__ float det3(const float* a) {
  float d = mul_rn(mul_rn(a[0], a[4]), a[8]);
  d = add_rn(d, mul_rn(mul_rn(a[1], a[5]), a[6]));
  d = add_rn(d, mul_rn(mul_rn(a[2], a[3]), a[7]));
  d = sub_rn(d, mul_rn(mul_rn(a[2], a[4]), a[6]));
  d = sub_rn(d, mul_rn(mul_rn(a[0], a[5]), a[7]));
  d = sub_rn(d, mul_rn(mul_rn(a[1], a[3]), a[8]));
  return d;
}

// a b - c d
__device__ __forceinline__ float cross(float a, float b, float c, float d) {
  return sub_rn(mul_rn(a, b), mul_rn(c, d));
}

// Patch start on an axis of n_full samples, moved into a block of n_blk
// samples that starts at sample off.
__device__ __forceinline__ long long patch_start(long long pos, int n_full,
                                                 long long off, int n_blk) {
  long long s = pos - 1;
  if (s < 0) s += n_full;
  s = (s < 0 ? 0 : (s > n_full - 3 ? n_full - 3 : s)) - off;
  return s < 0 ? 0 : (s > n_blk - 3 ? n_blk - 3 : s);
}

__global__ void localize(const float* __restrict__ vol, int X, int Y, int Z,
                         const long long* __restrict__ seeds, int K, int rx,
                         int ry, int rz, float max_offset, int n_iter,
                         int goff, int nx, long long* __restrict__ pos_out,
                         float* __restrict__ subvox,
                         unsigned char* __restrict__ good) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  const int real[3] = {rx, ry, rz};
  long long pos[3] = {seeds[3 * k], seeds[3 * k + 1], seeds[3 * k + 2]};
  float off[3] = {0.0f, 0.0f, 0.0f};
  float H[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  bool accepted = false, bad = false;
  for (int it = 0; it < n_iter; ++it) {
    float p[27];   // p[a][b][c] at (x0 + a, y0 + b, z0 + c)
    const long long x0 = patch_start(pos[0], nx, goff, X),
                    y0 = patch_start(pos[1], Y, 0, Y),
                    z0 = patch_start(pos[2], Z, 0, Z);
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) {
        const float* row = vol + ((x0 + a) * Y + y0 + b) * Z + z0;
        for (int c = 0; c < 3; ++c) p[a * 9 + b * 3 + c] = row[c];
      }
    }
#define P(a, b, c) p[(a) * 9 + (b) * 3 + (c)]
    const float c2 = mul_rn(2.0f, P(1, 1, 1));
    const float xx = sub_rn(add_rn(P(0, 1, 1), P(2, 1, 1)), c2);
    const float yy = sub_rn(add_rn(P(1, 0, 1), P(1, 2, 1)), c2);
    const float zz = sub_rn(add_rn(P(1, 1, 0), P(1, 1, 2)), c2);
    const float xy = mul_rn(0.25f, sub_rn(sub_rn(P(2, 2, 1), P(2, 0, 1)),
                                          sub_rn(P(0, 2, 1), P(0, 0, 1))));
    const float xz = mul_rn(0.25f, sub_rn(sub_rn(P(2, 1, 2), P(2, 1, 0)),
                                          sub_rn(P(0, 1, 2), P(0, 1, 0))));
    const float yz = mul_rn(0.25f, sub_rn(sub_rn(P(1, 2, 2), P(1, 2, 0)),
                                          sub_rn(P(1, 0, 2), P(1, 0, 0))));
    const float G[3] = {mul_rn(0.5f, sub_rn(P(2, 1, 1), P(0, 1, 1))),
                        mul_rn(0.5f, sub_rn(P(1, 2, 1), P(1, 0, 1))),
                        mul_rn(0.5f, sub_rn(P(1, 1, 2), P(1, 1, 0)))};
#undef P
    const float h[9] = {xx, xy, xz, xy, yy, yz, xz, yz, zz};
    const float det = det3(h);
    const bool ok = fabsf(det) > 1e-20f;
    const float den = ok ? det : 1.0f;
    const float adj[9] = {
        cross(h[4], h[8], h[5], h[7]), cross(h[2], h[7], h[1], h[8]),
        cross(h[1], h[5], h[2], h[4]),
        cross(h[5], h[6], h[3], h[8]), cross(h[0], h[8], h[2], h[6]),
        cross(h[2], h[3], h[0], h[5]),
        cross(h[3], h[7], h[4], h[6]), cross(h[1], h[6], h[0], h[7]),
        cross(h[0], h[4], h[1], h[3])};
    float o[3];
    bool acc_now = ok;
    for (int r = 0; r < 3; ++r) {
      const float s = add_rn(add_rn(mul_rn(__fdiv_rn(adj[3 * r], den), G[0]),
                                    mul_rn(__fdiv_rn(adj[3 * r + 1], den),
                                           G[1])),
                             mul_rn(__fdiv_rn(adj[3 * r + 2], den), G[2]));
      o[r] = -s;
      acc_now = acc_now && fabsf(o[r]) < max_offset;
    }
    // The peak is not frozen here (a frozen thread has left the loop).
    if (!acc_now) {
      for (int a = 0; a < 3; ++a) {
        if (o[a] < -max_offset && pos[a] - 1 > 0) pos[a] -= 1;
        if (o[a] > max_offset && pos[a] + 1 < real[a] - 1) pos[a] += 1;
      }
    }
    for (int a = 0; a < 3; ++a) off[a] = o[a];
    for (int e = 0; e < 9; ++e) H[e] = h[e];
    accepted = acc_now;
    bad = !ok;
    if (accepted || bad) break;
  }
  // Saddle rejection on the last H (all zeros when n_iter is 0).
  const float i1 = add_rn(add_rn(H[0], H[4]), H[8]);
  float i2 = cross(H[0], H[4], H[1], H[3]);
  i2 = add_rn(i2, mul_rn(H[0], H[8]));
  i2 = sub_rn(i2, mul_rn(H[2], H[6]));
  i2 = add_rn(i2, mul_rn(H[4], H[8]));
  i2 = sub_rn(i2, mul_rn(H[5], H[7]));
  const float i3 = det3(H);
  good[k] = accepted && i1 <= 0.0f && i2 >= 0.0f && i3 <= 0.0f;
  for (int a = 0; a < 3; ++a) {
    pos_out[3 * k + a] = pos[a];
    subvox[3 * k + a] = add_rn(static_cast<float>(pos[a]), off[a]);
  }
}

}  // namespace

// vol (X, Y, Z) float32; seeds (K, 3) int64; outputs pos (K, 3) int64,
// subvox (K, 3) float32 and good (K,) bool, written whole.
MAD_EXPORT int mad_localize(const float* vol, int X, int Y, int Z,
                            const long long* seeds, int K, int rx, int ry,
                            int rz, float max_offset, int n_iter, int goff,
                            int nx, long long* pos, float* subvox,
                            unsigned char* good, cudaStream_t stream) {
  if (K <= 0) return 0;
  localize<<<(K + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      vol, X, Y, Z, seeds, K, rx, ry, rz, max_offset, n_iter, goff, nx, pos,
      subvox, good);
  return static_cast<int>(cudaGetLastError());
}
