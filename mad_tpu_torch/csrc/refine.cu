// K15: rigid-body gradient-ascent refinement, every step of every candidate
// in one launch.
//
// Replaces mad_tpu/engine/refine.py:63-162 (_compiled_refine's while_loop
// body) with the trilinear gather of mad_tpu/ops/interp.py:37-82. Per
// candidate (start coords y0, centroid c), per step while not frozen:
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
// A frozen candidate never changes again, so its block exits at once; the
// plain version's collective exit every batch_size steps gives the same
// result. Sums over atoms are taken in another order than PyTorch's
// sum(dim=1) (per thread, then a warp tree, then the warps in order), so a
// last-bit difference can flip a step halving; everything else rounds as
// the plain version does (IEEE division and square root, no contraction).
//
// Bound: the work is small (C candidates x N atoms x up to 500 steps x 8
// corner gathers of 12 B, mostly L2 hits since a candidate's atoms stay in
// a small box); what bounds it is latency: each step is a dependent chain
// of gather -> block reduction -> one-thread pose update. Design: one
// block of 256 threads per candidate for all its steps, the pose and the
// checkpoint pose in shared memory, no device-memory state between steps
// and no host sync; the plain version needs ~30 launches per step and a
// host sync every batch_size steps. The checkpoint coordinates are rebuilt
// from the checkpoint pose (the same arithmetic gives the same bits) so no
// (C, N, 3) scratch is kept.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
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

// ops/interp.trilinear of a (X, Y, Z, 3) field at voxel coords p.
__device__ __forceinline__ void trilinear3(const float* __restrict__ field,
                                           int X, int Y, int Z,
                                           const float p_in[3], float out[3]) {
  const int dims[3] = {X, Y, Z};
  int p0[3];
  float w0[3], w1[3];
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
  const long long base = ((long long)p0[0] * Y + p0[1]) * Z + p0[2];
  bool first = true;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float w = mul_rn(mul_rn(dx ? w1[0] : w0[0], dy ? w1[1] : w0[1]),
                               dz ? w1[2] : w0[2]);
        const float* v =
            field + (base + ((long long)dx * Y + dy) * Z + dz) * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float term = mul_rn(w, __ldg(v + k));
          out[k] = first ? term : add_rn(out[k], term);
        }
        first = false;
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

// Sum of v over the block; the total is valid in thread 0 only.
__device__ __forceinline__ void block_sum3(float v[3], float (*red)[3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    for (int off = 16; off > 0; off >>= 1)
      v[j] = add_rn(v[j], __shfl_down_sync(0xffffffffu, v[j], off));
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < 3; ++j) red[warp][j] = v[j];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = red[0][j];
      for (int w = 1; w < kWarps; ++w) s = add_rn(s, red[w][j]);
      v[j] = s;
    }
}

// NaN-propagating max over the block; valid in thread 0 only.
__device__ __forceinline__ float block_max(float v, float (*red)[3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = max_nan(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp][0] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) v = max_nan(v, red[w][0]);
  return v;
}

__global__ void __launch_bounds__(kThreads) refine_kernel(
    const float* __restrict__ field, int X, int Y, int Z,
    const float* __restrict__ y0, int N, const float* __restrict__ center,
    const float* __restrict__ angle_den, const float* __restrict__ bounds,
    int n_steps, int batch_size, float max_step, float min_step,
    float* __restrict__ rot_out, float* __restrict__ trans_out,
    float* __restrict__ coords_out, unsigned char* __restrict__ frozen_out,
    int* __restrict__ steps_out, unsigned char* __restrict__ failed_out) {
  __shared__ float rot[9], trans[3], ck_rot[9], ck_trans[3], cen[3], bnd[7];
  __shared__ float red[kWarps][3];
  __shared__ float step_size, den;
  __shared__ int frozen, failed, count, ck_is_y0;
  const int cand = blockIdx.x, tid = threadIdx.x;
  const float* y = y0 + (long long)cand * N * 3;

  if (tid < 9) {
    rot[tid] = (tid % 4 == 0) ? 1.0f : 0.0f;
    ck_rot[tid] = rot[tid];
  }
  if (tid < 3) {
    trans[tid] = 0.0f;
    ck_trans[tid] = 0.0f;
    cen[tid] = center[cand * 3 + tid];
  }
  if (tid < 7) bnd[tid] = bounds[tid];
  if (tid == 0) {
    step_size = max_step;
    den = angle_den[cand];
    frozen = 0;
    failed = 0;
    count = 0;
    ck_is_y0 = 1;
  }
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    if (frozen) break;                       // uniform: read after a sync
    const bool rot_step = step & 1;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int i = tid; i < N; i += kThreads) {
      float a[3], x[3], v[3], g[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) a[j] = sub_rn(y[3 * i + j], cen[j]);
      pose_apply(a, rot, cen, trans, x);
      bool inb = true;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        inb = inb && (x[j] > bnd[j]) && (x[j] < bnd[3 + j]);
        v[j] = __fdiv_rn(sub_rn(x[j], bnd[j]), bnd[6]);
      }
      trilinear3(field, X, Y, Z, v, g);
      const float m = inb ? 1.0f : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) g[j] = mul_rn(g[j], m);
      if (!rot_step) {
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[j] = add_rn(acc[j], g[j]);
      } else {
        float r[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) r[j] = sub_rn(x[j], cen[j]);
        acc[0] = add_rn(acc[0], sub_rn(mul_rn(g[1], r[2]), mul_rn(g[2], r[1])));
        acc[1] = add_rn(acc[1], sub_rn(mul_rn(g[2], r[0]), mul_rn(g[0], r[2])));
        acc[2] = add_rn(acc[2], sub_rn(mul_rn(g[0], r[1]), mul_rn(g[1], r[0])));
      }
    }
    block_sum3(acc, red);
    if (tid == 0) {
      float u[3];
      unit3(acc, u);
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
    __syncthreads();

    // The moved coordinates: finiteness every step, and at a checkpoint
    // the max displacement since the previous one.
    const bool ck = (step + 1) % batch_size == 0;
    float dmax = 0.0f;
    bool bad = false;
    for (int i = tid; i < N; i += kThreads) {
      float a[3], x[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) a[j] = sub_rn(y[3 * i + j], cen[j]);
      pose_apply(a, rot, cen, trans, x);
#pragma unroll
      for (int j = 0; j < 3; ++j) bad = bad || !isfinite(x[j]);
      if (ck) {
        float p[3], d[3];
        if (ck_is_y0) {
#pragma unroll
          for (int j = 0; j < 3; ++j) p[j] = y[3 * i + j];
        } else {
          pose_apply(a, ck_rot, cen, ck_trans, p);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) d[j] = sub_rn(p[j], x[j]);
        dmax = max_nan(dmax, sqrtf(add_rn(add_rn(mul_rn(d[0], d[0]),
                                                 mul_rn(d[1], d[1])),
                                          mul_rn(d[2], d[2]))));
      }
    }
    bad = __syncthreads_or(bad);
    if (ck) dmax = block_max(dmax, red);
    if (tid == 0) {
      if (ck) {
        if (dmax < step_size) step_size = mul_rn(step_size, 0.5f);
#pragma unroll
        for (int k = 0; k < 9; ++k) ck_rot[k] = rot[k];
#pragma unroll
        for (int j = 0; j < 3; ++j) ck_trans[j] = trans[j];
        ck_is_y0 = 0;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) bad = bad || !isfinite(trans[j]);
      if (bad) failed = 1;
      count += 1;
      if (step_size < min_step || failed) frozen = 1;
    }
    __syncthreads();
  }

  float* xo = coords_out + (long long)cand * N * 3;
  for (int i = tid; i < N; i += kThreads) {
    float a[3], x[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) a[j] = sub_rn(y[3 * i + j], cen[j]);
    pose_apply(a, rot, cen, trans, x);
#pragma unroll
    for (int j = 0; j < 3; ++j) xo[3 * i + j] = x[j];
  }
  if (tid < 9) rot_out[cand * 9 + tid] = rot[tid];
  if (tid < 3) trans_out[cand * 3 + tid] = trans[tid];
  if (tid == 0) {
    frozen_out[cand] = (unsigned char)frozen;
    failed_out[cand] = (unsigned char)failed;
    steps_out[cand] = count;
  }
}

}  // namespace

// bounds: float32 [origin (3), origin + (shape - 1) * voxsp (3), voxsp].
MAD_EXPORT int mad_refine(const float* field, int X, int Y, int Z,
                          const float* y0, int C, int N, const float* center,
                          const float* angle_den, const float* bounds,
                          int n_steps, int batch_size, float max_step,
                          float min_step, float* rot, float* trans,
                          float* coords, unsigned char* frozen, int* steps,
                          unsigned char* failed, cudaStream_t stream) {
  if (C == 0) return 0;
  if (batch_size < 1 || X < 2 || Y < 2 || Z < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  refine_kernel<<<C, kThreads, 0, stream>>>(
      field, X, Y, Z, y0, N, center, angle_den, bounds, n_steps, batch_size,
      max_step, min_step, rot, trans, coords, frozen, steps, failed);
  return static_cast<int>(cudaGetLastError());
}
