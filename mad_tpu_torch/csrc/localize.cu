// K5: Newton subvoxel localization of LoG peaks, with saddle rejection,
// from K4's flat indices to the anchors' validity.
//
// Replaces mad_tpu/ops/detect.py:190-212 (the part of detect_counts after
// the top-k: unravel_index of the flat indices, the clip of the seeds to
// [eb, real - eb - 1], the vmapped localize and valid_seed & good), with
// localize (:125-163), _hessian_grad (:54-70), _inv3 (:73-88) and
// _neg_semidefinite (:91-103). Each peak runs up to n_iter steps:
//   1. gather the 3x3x3 patch at pos;
//   2. finite-difference H and G;
//   3. H^-1 by adjugate over the cofactor determinant, ok = |det| > 1e-20;
//   4. off = -(((Hinv[:,0] G0) + (Hinv[:,1] G1)) + (Hinv[:,2] G2));
//   5. accepted now when every |off| < max_offset and ok;
//   6. otherwise walk one voxel per axis where |off| > max_offset, if
//      pos - 1 > 0 (down) or pos + 1 < real - 1 (up);
//   7. accepted or bad (not ok) freezes the peak.
// A frozen peak's state never changes again (kernels/localize.py's
// update keeps accepted and bad exclusive), so the walk stops there.
// After the loop the last H takes the saddle test (trace <= 0, principal
// 2x2 minors summed >= 0, det <= 0).
//
// Two seed sources, one kernel. Flat form (the single-device path): the
// peaks' flat indices into vol and their values, as K4 returns them; the
// seed is (f / (Y Z), (f / Z) % Y, f % Z) clamped to [eb, real - eb - 1]
// per axis, and the kernel writes valid = (value > thr) & good, thr
// compared as a float (PyTorch's float32 tensor against a Python float).
// Offset form (capacity mode, detect.py:236-275 detect_shard): the seeds
// (K, 3) themselves, made on the host before the mesh splits them by x;
// it writes good alone. vol is then a shard's x-slab extended by its
// neighbours' rows, whose row 0 is global row goff of a field of nx rows.
// The walk and its bounds stay global; the x start is placed with the
// field's extent nx, then moved into the block (minus goff, clamped to
// [0, X - 3]). The halo of 2 + n_iter rows covers the walk of every seed
// the shard owns. The flat form is goff = 0, nx = X.
//
// Every product, sum and quotient is one IEEE rounding in the order of
// the plain version's torch ops (no FMA contraction), and max_offset and
// 1e-20 are compared as float, so the kernel equals localize_plain bit for
// bit. The patch is placed as mad_tpu's lax.dynamic_slice places it: per
// axis the start s = pos - 1 becomes s + n when negative (n the volume's
// extent), then is clamped to [0, n - 3] (kernels/localize.patch_index);
// pos itself is not clamped.
//
// Bound: latency. ~450 peaks an octave, each a chain of up to 5 dependent
// steps of ~150 flops on a 3x3x3 patch; the bytes (~0.2 MB) are under a
// tenth of a microsecond of the card. A peak is one warp: its 32 lanes
// load the kEdge^3 window about the seed's patch into shared memory in
// one round trip (kWindow / 32 independent loads a lane, their indices
// from constant divisors), so a walk whose patch moves up to kReach voxels
// from the seed's reads no device memory again; the window is reloaded
// about the patch only when a walk leaves it. Every lane then runs the
// step on the window (broadcast reads, one instruction stream) but for
// the nine quotients adj / det, one a lane, whose products with G are
// summed by shuffles; lanes 0 and 1 write the peak's outputs (fixed
// indices: no local array). ~450 warps cover the card's SMs where one
// thread a peak filled 4 of them and gathered 27 scattered voxels a step.
// A step is then one warp's chain of dependent instructions, ~0.4 us (the
// slowest bench peak's five steps take 1.8-2.0 us); a larger window costs
// more in its loads than the reloads it saves on the bench's walks
// (scripts/torch_localize_flags_probe.py).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;            // peaks a block, one warp each
constexpr int kEdge = 5;             // window edge (voxels)
constexpr int kReach = (kEdge - 3) / 2;   // patch moves a window covers
constexpr int kWindow = kEdge * kEdge * kEdge;

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
__device__ __forceinline__ int patch_start(int pos, int n_full, int off,
                                           int n_blk) {
  int s = pos - 1;
  if (s < 0) s += n_full;
  s = (s < 0 ? 0 : (s > n_full - 3 ? n_full - 3 : s)) - off;
  return s < 0 ? 0 : (s > n_blk - 3 ? n_blk - 3 : s);
}

// The window's start on an axis of n samples: kReach samples before the
// patch start where the axis allows it (0 where n < kEdge: the window's
// samples past n - 1 repeat the last, and no patch reads them).
__device__ __forceinline__ int window_start(int s, int n) {
  const int t = s - kReach, last = n - kEdge;
  return t > last ? (last > 0 ? last : 0) : (t < 0 ? 0 : t);
}

__global__ void __launch_bounds__(kWarps * 32)
localize(const float* __restrict__ vol, int X, int Y, int Z,
         const long long* __restrict__ seeds,
         const long long* __restrict__ flat,
         const float* __restrict__ vals, int K, int rx, int ry, int rz,
         int eb, float thr, float max_offset, int n_iter, int goff, int nx,
         long long* __restrict__ pos_out, float* __restrict__ subvox,
         unsigned char* __restrict__ good) {
  __shared__ float windows[kWarps][kWindow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= K) return;                 // the whole warp: no barrier below
  float* win = windows[warp];
  const int real[3] = {rx, ry, rz};
  int pos[3];                         // the volume's extents are ints
  if (seeds != nullptr) {
    for (int a = 0; a < 3; ++a) pos[a] = static_cast<int>(seeds[3 * k + a]);
  } else {
    // K4's flat indices are >= 0 (and below 2^31 where its int32 indices
    // hold), so C's / and % are torch's floor ones.
    const long long f = flat[k];
    if (f < (1LL << 31)) {
      const unsigned u = static_cast<unsigned>(f);
      const unsigned r = u / static_cast<unsigned>(Z);
      pos[0] = static_cast<int>(r / static_cast<unsigned>(Y));
      pos[1] = static_cast<int>(r % static_cast<unsigned>(Y));
      pos[2] = static_cast<int>(u - r * static_cast<unsigned>(Z));
    } else {
      pos[0] = static_cast<int>(f / (static_cast<long long>(Y) * Z));
      pos[1] = static_cast<int>((f / Z) % Y);
      pos[2] = static_cast<int>(f % Z);
    }
    for (int a = 0; a < 3; ++a) {
      const int hi = real[a] - eb - 1;
      const int s = pos[a] < eb ? eb : pos[a];
      pos[a] = s < hi ? s : hi;
    }
  }
  // The lane's window voxels as offsets from the window's first voxel,
  // once: where every extent is kEdge or more the window lies inside the
  // volume (window_start), else its indices are clamped voxel by voxel.
  constexpr int kPer = (kWindow + 31) / 32;
  const bool inside = X >= kEdge && Y >= kEdge && Z >= kEdge
                      && static_cast<long long>(kEdge) * Y * Z < (1LL << 31);
  int rel[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = min(lane + 32 * j, kWindow - 1);
    rel[j] = inside ? (i / (kEdge * kEdge) * Y + i / kEdge % kEdge) * Z
                          + i % kEdge
                    : 0;
  }
  const int col = lane % 3;           // the column of lane's quotient
  int w0[3] = {-kEdge, -kEdge, -kEdge};   // no window loaded yet
  float off[3] = {0.0f, 0.0f, 0.0f};
  float H[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  bool accepted = false, bad = false;
  for (int it = 0; it < n_iter; ++it) {
    const int s[3] = {patch_start(pos[0], nx, goff, X),
                      patch_start(pos[1], Y, 0, Y),
                      patch_start(pos[2], Z, 0, Z)};
    if (s[0] < w0[0] || s[0] > w0[0] + kEdge - 3 || s[1] < w0[1]
        || s[1] > w0[1] + kEdge - 3 || s[2] < w0[2]
        || s[2] > w0[2] + kEdge - 3) {
      // Every lane holds the same state, so the warp takes this branch
      // together; the syncs order the reads of the old window before the
      // stores of the new and the stores before the reads.
      w0[0] = window_start(s[0], X);
      w0[1] = window_start(s[1], Y);
      w0[2] = window_start(s[2], Z);
      __syncwarp();
      float v[kPer];
      if (inside) {
        const float* first =
            vol + (static_cast<long long>(w0[0]) * Y + w0[1]) * Z + w0[2];
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[j] = __ldg(first + rel[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = min(lane + 32 * j, kWindow - 1);
          const int x = min(w0[0] + i / (kEdge * kEdge), X - 1);
          const int y = min(w0[1] + i / kEdge % kEdge, Y - 1);
          const int z = min(w0[2] + i % kEdge, Z - 1);
          v[j] = __ldg(vol + (static_cast<long long>(x) * Y + y) * Z + z);
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (lane + 32 * j < kWindow) win[lane + 32 * j] = v[j];
      __syncwarp();
    }
    const float* p = win + ((s[0] - w0[0]) * kEdge + s[1] - w0[1]) * kEdge
                     + s[2] - w0[2];
#define P(a, b, c) p[((a) * kEdge + (b)) * kEdge + (c)]
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
    // The nine quotients adj / den on lanes 0-8 (lane 3 r + c: row r, col
    // c), each times G[c]; the row sums by shuffles, in the plain
    // version's order ((t0 + t1) + t2), broadcast to every lane.
    float o[3];
    bool acc_now = ok;
    {
      float a = adj[0];
#pragma unroll
      for (int j = 1; j < 9; ++j) a = lane == j ? adj[j] : a;
      const float g = col == 0 ? G[0] : (col == 1 ? G[1] : G[2]);
      const float t = mul_rn(__fdiv_rn(a, den), g);
      const float t1 = __shfl_down_sync(0xffffffffu, t, 1);
      const float t2 = __shfl_down_sync(0xffffffffu, t, 2);
      const float sr = add_rn(add_rn(t, t1), t2);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        o[r] = -__shfl_sync(0xffffffffu, sr, 3 * r);
        acc_now = acc_now && fabsf(o[r]) < max_offset;
      }
    }
    // The peak is not frozen here (a frozen peak has left the loop).
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
  if (lane == 0) {
    for (int a = 0; a < 3; ++a) {
      pos_out[3 * k + a] = pos[a];
      subvox[3 * k + a] = add_rn(static_cast<float>(pos[a]), off[a]);
    }
  } else if (lane == 1) {
    // Saddle rejection on the last H (all zeros when n_iter is 0).
    const float i1 = add_rn(add_rn(H[0], H[4]), H[8]);
    float i2 = cross(H[0], H[4], H[1], H[3]);
    i2 = add_rn(i2, mul_rn(H[0], H[8]));
    i2 = sub_rn(i2, mul_rn(H[2], H[6]));
    i2 = add_rn(i2, mul_rn(H[4], H[8]));
    i2 = sub_rn(i2, mul_rn(H[5], H[7]));
    const float i3 = det3(H);
    bool g = accepted && i1 <= 0.0f && i2 >= 0.0f && i3 <= 0.0f;
    if (vals != nullptr) g = vals[k] > thr && g;
    good[k] = g;
  }
}

}  // namespace

// vol (X, Y, Z) float32. Seeds: seeds (K, 3) int64 (offset form; flat and
// vals null), or flat (K,) int64 and vals (K,) float32 (flat form; seeds
// null), K4's top-k. Outputs pos (K, 3) int64, subvox (K, 3) float32 and
// good (K,) bool, written whole: in the flat form good is valid (value
// above thr, localized, not a saddle).
MAD_EXPORT int mad_localize(const float* vol, int X, int Y, int Z,
                            const long long* seeds, const long long* flat,
                            const float* vals, int K, int rx, int ry, int rz,
                            int eb, float thr, float max_offset, int n_iter,
                            int goff, int nx, long long* pos, float* subvox,
                            unsigned char* good, cudaStream_t stream) {
  if (K <= 0) return 0;
  localize<<<(K + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      vol, X, Y, Z, seeds, flat, vals, K, rx, ry, rz, eb, thr, max_offset,
      n_iter, goff, nx, pos, subvox, good);
  return static_cast<int>(cudaGetLastError());
}
