// K15: rigid-body gradient-ascent refinement, every step of every candidate
// in one launch.
//
// Replaces mad_tpu/engine/refine.py:63-162 (_compiled_refine's while_loop
// body) with the trilinear gather of mad_tpu/ops/interp.py:37-82. The field
// is float32 or bfloat16 (RefineConfig.field_dtype, mad_tpu's packed rows
// of :86-92): a bfloat16 corner value is widened to float32 (exact) as it
// is loaded and everything after is the float32 path's arithmetic, as
// trilinear_packed does with its rows. Per candidate (start coords y0,
// centroid c), per step while not frozen:
//   1. x = (y0 - c) @ rot + c + trans, each product and sum rounded on its
//      own, in the order of the plain version (kernels/refine.py);
//   2. atoms outside the strict map interior origin < x < hi contribute 0;
//   3. g = trilinear gradient at (x - origin) / voxsp, corners clamped to
//      shape - 2 as ops/interp.trilinear does (NaN passes through);
//   4. even steps: trans += unit(sum g) * step; odd steps:
//      rot = rot @ axis_angle(unit(sum g x (x - c)), step / max_dist);
//   5. every batch_size steps the step halves when the max displacement
//      since the last checkpoint is below it;
//   6. the candidate freezes at step < min_step, or on a non-finite
//      coordinate or translation (then it is flagged failed).
// A frozen candidate never changes again, so its cluster exits at once;
// the plain version's collective exit every batch_size steps gives the
// same result. Sums over atoms are taken in another order than PyTorch's
// sum(dim=1) (256 logical threads each over its atoms t, t + 256, ... in
// turn, then a __shfl_down tree within each warp of 32, then the 8 warp
// sums in warp order), so a last-bit difference can flip a step halving;
// everything else rounds as the plain version does (IEEE division and
// square root, no contraction).
//
// Bound: the work is small (C candidates x N atoms x up to 500 steps x 8
// corner gathers of 12 B, 6 B in bfloat16, each corner's 3 values a 2-byte
// load then, mostly L1 and L2 hits since a candidate's atoms
// stay in a small box); what bounds it is each step's chain: gather ->
// reduction over the candidate -> pose update. Measured on the H100
// (scripts/torch_refine_describe_probe.py): with one CTA a candidate a
// step is bound by that SM's throughput over the candidate's atoms (this
// form at kCluster 1 takes the time of the form before it, 6.8 us a
// step); spread over 8 SMs the step takes ~4.3 us, of which the field
// loads ~40 % and the cluster barrier, with its wait for the CTA whose
// threads hold one atom more, ~20 %. Design, for that chain:
//   * a candidate runs on a thread-block cluster of kCluster CTAs
//     (cudaLaunchKernelEx with a cluster dimension); CTA r holds warps
//     r * 8 / kCluster ... of the 256-thread layout above, so the sum's
//     order does not depend on kCluster (the bench's 28 candidates, H100:
//     kCluster 1, 2, 4, 8 took 0.92, 0.74, 0.58, 0.54 ms);
//   * each thread loads its atoms' arms y0 - c once into a register tile
//     (kTile atoms, up to kAtomsPerThread; beyond 256 * kAtomsPerThread
//     atoms a looped form walks them in tiles of kLoopTile, arms
//     reloaded, in the same order) and, each step, issues the 24 field
//     loads of every atom of its tile before it uses any of them: one
//     gather round trip a step, not one an atom;
//   * one pass over the atoms a step: the coordinates moved by step s are
//     those step s + 1's gathers are taken at, so that pass also tests
//     their finiteness and, after a checkpoint step, their displacement
//     from the checkpoint pose (or y0); the force or torque sum, the flag
//     and the displacement max are reduced together, and a last pass
//     without gathers settles the last step;
//   * each warp's partials go into every CTA's shared memory (distributed
//     shared memory, cluster.map_shared_rank), double-buffered, so a step
//     needs one cluster.sync() and nothing else: every thread then adds
//     the 8 warp partials in warp order and runs the step's decisions and
//     pose update itself (the same arithmetic on the same values in every
//     thread: no single-thread section, no broadcast barrier);
//   * the pose, the checkpoint pose and the step size live in registers;
//     no device-memory state between steps and no host sync; the plain
//     version needs ~30 launches a step and a host sync every batch_size
//     steps.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

constexpr int kThreads = 256;           // logical threads of a candidate
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;             // CTAs a candidate: 1, 2, 4 or 8
constexpr int kCtaThreads = kThreads / kCluster;
constexpr int kAtomsPerThread = 6;      // register tile's largest size
constexpr int kLoopTile = 4;            // the looped form's tile
constexpr int kParts = 5;               // a warp's sum (3), flag, max

static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4 ||
                  kCluster == 8,
              "kCluster must divide the 8 warps of a candidate");

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

// A field value as float32: bfloat16 widens exactly.
__device__ __forceinline__ float load_field(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_field(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// NaN-propagating max (PyTorch's amax).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b != b || b > a) ? b : a;
}

// x_j = ((a . R[:, j]) + c_j) + t_j with R row-major.
__device__ __forceinline__ void pose_apply(const float a[3], const float* R,
                                           const float* c, const float* t,
                                           float x[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    x[j] = add_rn(add_rn(add_rn(add_rn(mul_rn(a[0], R[j]),
                                       mul_rn(a[1], R[3 + j])),
                                mul_rn(a[2], R[6 + j])),
                         c[j]),
                  t[j]);
}

// ops/interp.trilinear of a (X, Y, Z, 3) field at voxel coords p, split in
// two: the first corner's element index and the weights, then (corner_sum)
// the weighted sum of the 8 corners' 3 components loaded beforehand.
__device__ __forceinline__ long long corner_setup(const int dims[3],
                                                  const float p_in[3],
                                                  float w0[3], float w1[3]) {
  int p0[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float p = p_in[j];
    p = p < 0.0f ? 0.0f : p;                  // clamp(min=0), NaN passes
    const float hi = (float)(dims[j] - 1);
    p = p > hi ? hi : p;                      // minimum(., shape - 1)
    int i = __float2int_rd(p);                // floor; NaN -> 0
    i = i < 0 ? 0 : i;
    i = i > dims[j] - 2 ? dims[j] - 2 : i;
    p0[j] = i;
    const float f = sub_rn(p, (float)i);
    w0[j] = sub_rn(1.0f, f);
    w1[j] = f;
  }
  return (((long long)p0[0] * dims[1] + p0[1]) * dims[2] + p0[2]) * 3;
}

__device__ __forceinline__ void corner_sum(const float w0[3],
                                           const float w1[3],
                                           const float v[8][3],
                                           float out[3]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
    const float w = mul_rn(mul_rn(dx ? w1[0] : w0[0], dy ? w1[1] : w0[1]),
                           dz ? w1[2] : w0[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float term = mul_rn(w, v[c][k]);
      out[k] = c == 0 ? term : add_rn(out[k], term);
    }
  }
}

// core/geometry.unit: v / |v| where |v| > 1e-30, else v.
__device__ __forceinline__ void unit3(const float v[3], float u[3]) {
  const float n = sqrtf(add_rn(add_rn(mul_rn(v[0], v[0]), mul_rn(v[1], v[1])),
                               mul_rn(v[2], v[2])));
  const bool ok = n > 1e-30f;
#pragma unroll
  for (int j = 0; j < 3; ++j) u[j] = ok ? __fdiv_rn(v[j], n) : v[j];
}

// core/geometry.axis_angle_mat (Euler-Rodrigues, vector part -axis sin).
__device__ __forceinline__ void axis_angle(const float ax[3], float angle,
                                           float R[9]) {
  const float h = mul_rn(angle, 0.5f);
  const float a = cosf(h), s = sinf(h);
  const float b = mul_rn(-ax[0], s), c = mul_rn(-ax[1], s),
              d = mul_rn(-ax[2], s);
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

// One step's pass over a tile of up to kTile atoms (atom k of the tile is
// the thread's atom first + k; live below n): the moved coordinates, their
// finiteness and (ck) displacement from the checkpoint, and (gather) the
// force or torque, each atom's terms added in turn.
template <typename T, int kTile>
__device__ __forceinline__ void tile_pass(
    const T* __restrict__ field, const int dims[3], const int cofs[8],
    const float* __restrict__ y, int t, int first, int n,
    const float (&arm)[kTile][3], const float* rot, const float* trans,
    const float* ck_rot, const float* ck_trans, const float cen[3],
    const float bnd[7], bool check, bool ck, bool ck_is_y0, bool gather,
    bool rot_step, float acc[3], bool& bad, float& dmax) {
  float x[kTile][3], w0[kTile][3], w1[kTile][3];
  long long base[kTile];
  bool inb[kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    pose_apply(arm[k], rot, cen, trans, x[k]);
    float v[3];
    inb[k] = true;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      inb[k] = inb[k] && (x[k][j] > bnd[j]) && (x[k][j] < bnd[3 + j]);
      v[j] = __fdiv_rn(sub_rn(x[k][j], bnd[j]), bnd[6]);
    }
    base[k] = corner_setup(dims, v, w0[k], w1[k]);
  }
  // every load of the tile in flight before any is used
  float val[kTile][8][3];
  float p0[kTile][3];
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const bool live = k < n;
    const long long i = (long long)t + (long long)kThreads * (first + k);
    const T* b = field + base[k];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const T* v = b + cofs[c];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        val[k][c][j] = (live && gather) ? load_field(v + j) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      p0[k][j] = (live && ck && ck_is_y0) ? __ldg(y + 3 * i + j) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (k >= n) break;
    if (check) {
#pragma unroll
      for (int j = 0; j < 3; ++j) bad = bad || !isfinite(x[k][j]);
    }
    if (ck) {
      float p[3], d[3];
      if (ck_is_y0) {
#pragma unroll
        for (int j = 0; j < 3; ++j) p[j] = p0[k][j];
      } else {
        pose_apply(arm[k], ck_rot, cen, ck_trans, p);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) d[j] = sub_rn(p[j], x[k][j]);
      dmax = max_nan(dmax, sqrtf(add_rn(add_rn(mul_rn(d[0], d[0]),
                                               mul_rn(d[1], d[1])),
                                        mul_rn(d[2], d[2]))));
    }
    if (gather) {
      float g[3];
      corner_sum(w0[k], w1[k], val[k], g);
      const float m = inb[k] ? 1.0f : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) g[j] = mul_rn(g[j], m);
      if (!rot_step) {
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[j] = add_rn(acc[j], g[j]);
      } else {
        float r[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) r[j] = sub_rn(x[k][j], cen[j]);
        acc[0] = add_rn(acc[0],
                        sub_rn(mul_rn(g[1], r[2]), mul_rn(g[2], r[1])));
        acc[1] = add_rn(acc[1],
                        sub_rn(mul_rn(g[2], r[0]), mul_rn(g[0], r[2])));
        acc[2] = add_rn(acc[2],
                        sub_rn(mul_rn(g[0], r[1]), mul_rn(g[1], r[0])));
      }
    }
  }
}

// Arms y0 - c of the tile's live atoms (first + k, k < n); 0 past them.
template <int kTile>
__device__ __forceinline__ void load_arms(const float* __restrict__ y, int t,
                                          int first, int n,
                                          const float cen[3],
                                          float (&arm)[kTile][3]) {
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const long long i = (long long)t + (long long)kThreads * (first + k);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      arm[k][j] = k < n ? sub_rn(__ldg(y + 3 * i + j), cen[j]) : 0.0f;
  }
}

// kTile atoms a thread in registers; kLooped: more than that, walked in
// tiles of kTile with the arms reloaded.
template <typename T, int kTile, bool kLooped>
__global__ void __launch_bounds__(kCtaThreads) refine_kernel(
    const T* __restrict__ field, int X, int Y, int Z,
    const float* __restrict__ y0, int N, const float* __restrict__ center,
    const float* __restrict__ angle_den, const float* __restrict__ bounds,
    int n_steps, int batch_size, float max_step, float min_step,
    float* __restrict__ rot_out, float* __restrict__ trans_out,
    float* __restrict__ coords_out, unsigned char* __restrict__ frozen_out,
    int* __restrict__ steps_out, unsigned char* __restrict__ failed_out) {
  namespace cg = cooperative_groups;
  __shared__ float part[2][kWarps][kParts];
  int rank = 0;
  if constexpr (kCluster > 1) rank = (int)cg::this_cluster().block_rank();
  const int cand = blockIdx.x / kCluster;
  const int t = rank * kCtaThreads + threadIdx.x;   // logical thread
  const int lane = threadIdx.x & 31, warp = t >> 5;
  const int dims[3] = {X, Y, Z};
  int cofs[8];                      // the corners' offsets from the first
#pragma unroll
  for (int c = 0; c < 8; ++c)
    cofs[c] = (((c >> 2) * Y + ((c >> 1) & 1)) * Z + (c & 1)) * 3;
  const float* y = y0 + (long long)cand * N * 3;
  float cen[3], bnd[7];
#pragma unroll
  for (int j = 0; j < 3; ++j) cen[j] = __ldg(center + cand * 3 + j);
#pragma unroll
  for (int j = 0; j < 7; ++j) bnd[j] = __ldg(bounds + j);
  const float den = __ldg(angle_den + cand);
  const int nper = t < N ? (N - 1 - t) / kThreads + 1 : 0;   // own atoms

  float arm[kTile][3];
  if (!kLooped) load_arms<kTile>(y, t, 0, nper, cen, arm);
  float rot[9], trans[3], ck_rot[9], ck_trans[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = ck_rot[k] = (k % 4 == 0) ? 1.0f : 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) trans[j] = ck_trans[j] = 0.0f;
  float step_size = max_step;
  bool ck_is_y0 = true, failed = false, frozen = false;
  int count = 0, buf = 0;

  // Pass s gathers for step s (s < n_steps) at the coordinates step s - 1
  // moved to, and settles step s - 1 (s > 0) with the same coordinates.
  for (int s = 0;; ++s) {
    const bool check = s > 0;
    const bool ck = check && s % batch_size == 0;   // step s - 1 was one
    const bool gather = s < n_steps;
    const bool rot_step = s & 1;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    float dmax = 0.0f;
    bool bad = false;
    if (!kLooped) {
      tile_pass<T, kTile>(field, dims, cofs, y, t, 0, nper, arm, rot, trans,
                          ck_rot, ck_trans, cen, bnd, check, ck, ck_is_y0,
                          gather, rot_step, acc, bad, dmax);
    } else {
      for (int first = 0; first < nper; first += kTile) {
        load_arms<kTile>(y, t, first, nper - first, cen, arm);
        tile_pass<T, kTile>(field, dims, cofs, y, t, first, nper - first,
                            arm, rot, trans, ck_rot, ck_trans, cen, bnd,
                            check, ck, ck_is_y0, gather, rot_step, acc, bad,
                            dmax);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      for (int off = 16; off > 0; off >>= 1)
        acc[j] = add_rn(acc[j], __shfl_down_sync(0xffffffffu, acc[j], off));
    for (int off = 16; off > 0; off >>= 1)
      dmax = max_nan(dmax, __shfl_down_sync(0xffffffffu, dmax, off));
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {                // the warp's partials, to every CTA
      const float mine[kParts] = {acc[0], acc[1], acc[2], bad ? 1.0f : 0.0f,
                                  dmax};
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        float* dst = &part[buf][warp][0];
        if constexpr (kCluster > 1)
          dst = cg::this_cluster().map_shared_rank(dst, r);
#pragma unroll
        for (int q = 0; q < kParts; ++q) dst[q] = mine[q];
      }
    }
    if constexpr (kCluster > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
    // every thread: the candidate's sums in warp order, then the step
    float tot[3];
    bool any_bad = false;
    float dm = part[buf][0][4];
#pragma unroll
    for (int j = 0; j < 3; ++j) tot[j] = part[buf][0][j];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w > 0) {
#pragma unroll
        for (int j = 0; j < 3; ++j) tot[j] = add_rn(tot[j], part[buf][w][j]);
        dm = max_nan(dm, part[buf][w][4]);
      }
      any_bad = any_bad || part[buf][w][3] != 0.0f;
    }
    buf ^= 1;
    if (check) {                    // step s - 1: the parent's order
      if (ck) {
        if (dm < step_size) step_size = mul_rn(step_size, 0.5f);
#pragma unroll
        for (int k = 0; k < 9; ++k) ck_rot[k] = rot[k];
#pragma unroll
        for (int j = 0; j < 3; ++j) ck_trans[j] = trans[j];
        ck_is_y0 = false;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) any_bad = any_bad || !isfinite(trans[j]);
      if (any_bad) failed = true;
      count += 1;
      if (step_size < min_step || failed) {
        frozen = true;
        break;
      }
    }
    if (!gather) break;
    float u[3];
    unit3(tot, u);
    if (!rot_step) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        trans[j] = add_rn(trans[j], mul_rn(u[j], step_size));
    } else {
      float R[9], out[9];
      axis_angle(u, __fdiv_rn(step_size, den), R);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          out[3 * i + j] = add_rn(add_rn(mul_rn(rot[3 * i], R[j]),
                                         mul_rn(rot[3 * i + 1], R[3 + j])),
                                  mul_rn(rot[3 * i + 2], R[6 + j]));
#pragma unroll
      for (int k = 0; k < 9; ++k) rot[k] = out[k];
    }
  }

  // after the last cluster.sync() no CTA touches another's shared memory
  float* xo = coords_out + (long long)cand * N * 3;
  for (int first = 0; first < nper; first += kTile) {
    if (kLooped) load_arms<kTile>(y, t, first, nper - first, cen, arm);
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (first + k >= nper) break;
      const long long i = (long long)t + (long long)kThreads * (first + k);
      float x[3];
      pose_apply(arm[k], rot, cen, trans, x);
#pragma unroll
      for (int j = 0; j < 3; ++j) xo[3 * i + j] = x[j];
    }
  }
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) rot_out[cand * 9 + k] = rot[k];
#pragma unroll
    for (int j = 0; j < 3; ++j) trans_out[cand * 3 + j] = trans[j];
    frozen_out[cand] = (unsigned char)frozen;
    failed_out[cand] = (unsigned char)failed;
    steps_out[cand] = count;
  }
}

template <typename T>
using Kernel = void (*)(const T*, int, int, int, const float*, int,
                        const float*, const float*, const float*, int, int,
                        float, float, float*, float*, float*, unsigned char*,
                        int*, unsigned char*);

template <typename T>
int launch(const T* field, int X, int Y, int Z, const float* y0, int C,
           int N, const float* center, const float* angle_den,
           const float* bounds, int n_steps, int batch_size, float max_step,
           float min_step, float* rot, float* trans, float* coords,
           unsigned char* frozen, int* steps, unsigned char* failed,
           cudaStream_t stream) {
  // refine_kernel<T, tile, false> at index tile - 1; the looped form last
  constexpr Kernel<T> kKernels[] = {
      refine_kernel<T, 1, false>, refine_kernel<T, 2, false>,
      refine_kernel<T, 3, false>, refine_kernel<T, 4, false>,
      refine_kernel<T, 5, false>, refine_kernel<T, 6, false>,
      refine_kernel<T, kLoopTile, true>};
  static_assert(sizeof(kKernels) / sizeof(Kernel<T>) == kAtomsPerThread + 1,
                "one kernel a tile size, and the looped form");
  const int per = (N + kThreads - 1) / kThreads;
  const Kernel<T> kernel =
      kKernels[per > kAtomsPerThread ? kAtomsPerThread
                                     : (per < 1 ? 0 : per - 1)];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C) * kCluster);
  cfg.blockDim = dim3(kCtaThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, field, X, Y, Z, y0, N, center, angle_den, bounds,
      n_steps, batch_size, max_step, min_step, rot, trans, coords, frozen,
      steps, failed);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// field_dtype: 0 = float32, 1 = bfloat16 (the (X, Y, Z, 3) field);
// bounds: float32 [origin (3), origin + (shape - 1) * voxsp (3), voxsp].
MAD_EXPORT int mad_refine(const void* field, int field_dtype, int X, int Y,
                          int Z, const float* y0, int C, int N,
                          const float* center, const float* angle_den,
                          const float* bounds, int n_steps, int batch_size,
                          float max_step, float min_step, float* rot,
                          float* trans, float* coords, unsigned char* frozen,
                          int* steps, unsigned char* failed,
                          cudaStream_t stream) {
  if (C == 0) return 0;
  if (batch_size < 1 || X < 2 || Y < 2 || Z < 2 || N < 0 ||
      (field_dtype != 0 && field_dtype != 1) ||
      ((long long)Y * Z + Z + 1) * 3 > 0x7fffffffLL)      // corner offsets
    return static_cast<int>(cudaErrorInvalidValue);
  if (field_dtype == 0)
    return launch(static_cast<const float*>(field), X, Y, Z, y0, C, N, center,
                  angle_den, bounds, n_steps, batch_size, max_step, min_step,
                  rot, trans, coords, frozen, steps, failed, stream);
  return launch(static_cast<const __nv_bfloat16*>(field), X, Y, Z, y0, C, N,
                center, angle_den, bounds, n_steps, batch_size, max_step,
                min_step, rot, trans, coords, frozen, steps, failed, stream);
}
