// K16: the post-refine merge and the rescue eligibility of a docking round.
//
// Replaces mad_tpu/engine/dock_fused.py:344-453 (the _compiled_dock_post
// body) on the port's split path, whose host version (mad_tpu's
// engine/docking._merge_refined, numpy and cKDTree) computes in float64;
// so does this file, on the same inputs (kernels/post.py says what each
// output is). Six kernels, in five launchers (the stages), on one stream:
//   1. post_lanes, a block per lane of a range: the composed pose
//      (A = rot^T, b = lo - hi A, center = mean(x0 A + b) by a block sum),
//      then a warp per subunit anchor moves it, s_a = ((h A + b) - center)
//      R + center + t, and takes its least squared distance to the map
//      anchors (lanes over the cloud, a shuffle min); hit = d2 <
//      hit_thresh^2;
//   2. post_rmsd, a block per lane: its CA-RMSD to each earlier solution
//      and to each lane of the round, a warp per pair, lanes over atoms;
//   3. post_scan, one warp: the greedy dedup in candidate order, the
//      argmin over the accepted solutions by a shuffle (first index on
//      ties), merge below dedup_rmsd, else a new solution (2 and 3 are
//      one launcher, mad_post_dedup);
//   4. post_elig_points, a block per map-anchor cloud point of a range:
//      its least squared distance to the atoms of every accepted solution
//      (the earlier rounds' and this round's accepted lanes);
//   5. post_elig_rows, a thread per table row of a range: finds its map
//      anchor in the cloud (equal coordinates) and takes that point's
//      answer; a row whose anchor is not in the cloud is measured against
//      the atoms itself; eligible = !(d2 < anchor_dist^2), as cKDTree's
//      upper bound decides;
//   6. post_compact, one block: the first n_top eligible rows in table
//      order (ballot prefix sums over chunks of 1,024 rows).
// Stages 1, 4 and 5 take a (start, count) range of lanes, points or rows
// and write count outputs: on a mesh (mad_tpu's lane_map_fn and
// pair_scan_fn, engine/dock_fused.py:455-524) each shard runs them on its
// block on its own device, and 2-3 and 6 run once on the gathered results
// (the replicated dedup scan and compaction there); a lane's, point's or
// row's result does not depend on the range it is computed in.
// Products, sums and differences are __dmul_rn / __dadd_rn / __dsub_rn in
// the plain version's order, so the poses and distances round as there
// (the center's sum and the RMSD sums run in another order: within 1e-12).
//
// Bound: float64 operations, ~9 per anchor-to-point distance, atom pair of
// an RMSD and point-to-atom distance of the eligibility (bench: 28 lanes x
// 32 anchors x 414 points, 28 x 44 RMSDs of 260 CA atoms, 414 points x
// 16,640 atoms), a few microseconds of the card; the six dependent launches
// and the one-warp scan set the time.
#include <math.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCompact = 1024;

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double dsub(double a, double b) {
  return __dsub_rn(a, b);
}

// (v @ M)[e] for row-major M[d][e] = M[3 d + e], left to right.
__device__ __forceinline__ double vecmat(const double* v, const double* M,
                                         int e) {
  return dadd(dadd(dmul(v[0], M[e]), dmul(v[1], M[3 + e])),
              dmul(v[2], M[6 + e]));
}

// (dx^2 + dy^2) + dz^2 of p - q.
__device__ __forceinline__ double dist2(const double* p, double qx, double qy,
                                        double qz) {
  const double dx = dsub(p[0], qx), dy = dsub(p[1], qy), dz = dsub(p[2], qz);
  return dadd(dadd(dmul(dx, dx), dmul(dy, dy)), dmul(dz, dz));
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = dadd(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum of v over the block in a fixed order, valid in thread 0.
__device__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = red[0];
    for (int w = 1; w < kWarps; ++w) v = dadd(v, red[w]);
  }
  return v;
}

__global__ void post_lanes(const float* __restrict__ rot_m,
                           const float* __restrict__ trans_m,
                           const unsigned char* __restrict__ failed,
                           const double* __restrict__ cand_rot,
                           const double* __restrict__ cand_hi,
                           const double* __restrict__ cand_lo,
                           const double* __restrict__ x0, int N,
                           const double* __restrict__ hi_cloud, int A,
                           const double* __restrict__ lo_cloud, int B,
                           double thr2, int start,
                           double* __restrict__ out_sa,
                           double* __restrict__ out_hits,
                           double* __restrict__ out_counts) {
  __shared__ double sA[9], sR[9], sb[3], sc[3], st[3], red[kWarps];
  __shared__ int s_count;
  const int c = start + blockIdx.x;       // the lane; outputs at blockIdx.x
  const int o = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (failed[c]) {
    for (int q = threadIdx.x; q < 3 * A; q += blockDim.x)
      out_sa[3LL * o * A + q] = 0.0;
    for (int a = threadIdx.x; a < A; a += blockDim.x)
      out_hits[static_cast<long long>(o) * A + a] = 0.0;
    if (threadIdx.x == 0) out_counts[o] = 0.0;
    return;
  }
  if (threadIdx.x < 9) {            // A[d][e] = rot[e][d]
    const int d = threadIdx.x / 3, e = threadIdx.x % 3;
    sA[threadIdx.x] = cand_rot[9 * c + 3 * e + d];
    sR[threadIdx.x] = static_cast<double>(rot_m[9 * c + threadIdx.x]);
  }
  if (threadIdx.x < 3)
    st[threadIdx.x] = static_cast<double>(trans_m[3 * c + threadIdx.x]);
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  if (threadIdx.x < 3)
    sb[threadIdx.x] = dsub(cand_lo[3 * c + threadIdx.x],
                           vecmat(cand_hi + 3 * c, sA, threadIdx.x));
  __syncthreads();
  double acc[3] = {0.0, 0.0, 0.0};
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    for (int e = 0; e < 3; ++e)
      acc[e] = dadd(acc[e], dadd(vecmat(x0 + 3 * n, sA, e), sb[e]));
  for (int e = 0; e < 3; ++e) {
    const double s = block_sum(acc[e], red);
    if (threadIdx.x == 0) sc[e] = s / N;
  }
  __syncthreads();
  for (int a = warp; a < A; a += kWarps) {
    double u[3], s[3];
    for (int e = 0; e < 3; ++e)
      u[e] = dsub(dadd(vecmat(hi_cloud + 3 * a, sA, e), sb[e]), sc[e]);
    for (int e = 0; e < 3; ++e)
      s[e] = dadd(dadd(vecmat(u, sR, e), sc[e]), st[e]);
    double best = INFINITY;
    for (int j = lane; j < B; j += 32)
      best = fmin(best, dist2(s, lo_cloud[3 * j], lo_cloud[3 * j + 1],
                              lo_cloud[3 * j + 2]));
    best = warp_min(best);
    if (lane == 0) {
      const long long ca = static_cast<long long>(o) * A + a;
      for (int e = 0; e < 3; ++e) out_sa[3 * ca + e] = s[e];
      const bool hit = best < thr2;
      out_hits[ca] = hit ? 1.0 : 0.0;
      if (hit) atomicAdd(&s_count, 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out_counts[o] = static_cast<double>(s_count);
}

// Atom `k` of target j: an earlier solution (j < S, float64) or lane
// j - S of the round (float32).
__device__ __forceinline__ void target_atom(const double* prev,
                                            const float* coords, int S,
                                            int N, int j, long long k,
                                            double* p) {
  if (j < S) {
    const double* q = prev + (static_cast<long long>(j) * N + k) * 3;
    p[0] = q[0];
    p[1] = q[1];
    p[2] = q[2];
  } else {
    const float* q = coords + (static_cast<long long>(j - S) * N + k) * 3;
    p[0] = static_cast<double>(q[0]);
    p[1] = static_cast<double>(q[1]);
    p[2] = static_cast<double>(q[2]);
  }
}

__global__ void post_rmsd(const float* __restrict__ coords,
                          const double* __restrict__ prev, int S, int C,
                          int N, const long long* __restrict__ idx, int n,
                          double* __restrict__ rmat) {
  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < S + C; j += kWarps) {
    double sum = 0.0;
    for (int a = lane; a < n; a += 32) {
      double p[3], q[3];
      target_atom(prev, coords, S, N, S + i, idx[a], p);
      target_atom(prev, coords, S, N, j, idx[a], q);
      sum = dadd(sum, dist2(p, q[0], q[1], q[2]));
    }
    sum = warp_sum(sum);
    if (lane == 0)
      rmat[static_cast<long long>(i) * (S + C) + j] = sqrt(sum / n);
  }
}

// One warp. Lane i is valid when not failed and it hits; the accepted
// solutions are the S earlier ones (column k of rmat) and this round's
// accepted lanes in order (column S + lane_of[k - S]).
__global__ void post_scan(const unsigned char* __restrict__ failed, int S,
                          int C, const double* __restrict__ rmat,
                          double dedup, int* __restrict__ lane_of,
                          const double* __restrict__ counts,
                          double* __restrict__ out_acc,
                          double* __restrict__ out_slot) {
  const int lane = threadIdx.x;
  int n_acc = 0;
  for (int i = 0; i < C; ++i) {
    if (failed[i] || counts[i] <= 0.0) {
      if (lane == 0) {
        out_acc[i] = 0.0;
        out_slot[i] = -1.0;
      }
      continue;
    }
    const int K = S + n_acc;
    const double* row = rmat + static_cast<long long>(i) * (S + C);
    double best = INFINITY;
    int bk = INT_MAX;
    for (int k = lane; k < K; k += 32) {
      const double v = row[k < S ? k : S + lane_of[k - S]];
      if (v < best) {                 // k ascends: the first on ties
        best = v;
        bk = k;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
      if (ov < best || (ov == best && ok < bk)) {
        best = ov;
        bk = ok;
      }
    }
    const bool merged = bk != INT_MAX && best < dedup;
    if (lane == 0) {
      out_acc[i] = merged ? 0.0 : 1.0;
      out_slot[i] = static_cast<double>(merged ? bk : K);
      if (!merged) lane_of[n_acc] = i;
    }
    if (!merged) ++n_acc;
    __syncwarp();
  }
}

// Least squared distance of p to the atoms of the earlier solutions and of
// the accepted lanes, over t = first, first + step, ...
__device__ double atoms_min(const double* p, const double* prev, int S,
                            const float* coords, const double* acc, int C,
                            int N, long long first, int step) {
  const long long n_prev = static_cast<long long>(S) * N;
  const long long total = n_prev + static_cast<long long>(C) * N;
  double best = INFINITY;
  for (long long t = first; t < total; t += step) {
    if (t < n_prev) {
      best = fmin(best, dist2(p, prev[3 * t], prev[3 * t + 1],
                              prev[3 * t + 2]));
    } else {
      const long long k = t - n_prev;
      if (acc[k / N] == 0.0) continue;
      best = fmin(best, dist2(p, static_cast<double>(coords[3 * k]),
                              static_cast<double>(coords[3 * k + 1]),
                              static_cast<double>(coords[3 * k + 2])));
    }
  }
  return best;
}

__global__ void post_elig_points(const double* __restrict__ lo_cloud,
                                 int start,
                                 const double* __restrict__ prev, int S,
                                 const float* __restrict__ coords,
                                 const double* __restrict__ acc, int C,
                                 int N, double ad2,
                                 unsigned char* __restrict__ elig_pt) {
  __shared__ double red[kWarps];
  const int j = start + blockIdx.x;       // the point; output at blockIdx.x
  double best = atoms_min(lo_cloud + 3 * j, prev, S, coords, acc, C, N,
                          threadIdx.x, blockDim.x);
  best = warp_min(best);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) best = fmin(best, red[w]);
    best = fmin(best, red[0]);
    elig_pt[blockIdx.x] = best < ad2 ? 0 : 1;
  }
}

__global__ void post_elig_rows(const double* __restrict__ lo_rows,
                               int start, int count,
                               const double* __restrict__ lo_cloud, int B,
                               const unsigned char* __restrict__ elig_pt,
                               const double* __restrict__ prev, int S,
                               const float* __restrict__ coords,
                               const double* __restrict__ acc, int C, int N,
                               double ad2,
                               unsigned char* __restrict__ row_flag) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= count) return;
  const double* p = lo_rows + 3LL * (start + o);
  for (int j = 0; j < B; ++j) {
    const double* q = lo_cloud + 3 * j;
    if (q[0] == p[0] && q[1] == p[1] && q[2] == p[2]) {
      row_flag[o] = elig_pt[j];
      return;
    }
  }
  row_flag[o] = atoms_min(p, prev, S, coords, acc, C, N, 0, 1) < ad2 ? 0 : 1;
}

__global__ void post_compact(const unsigned char* __restrict__ row_flag,
                             int P, int n_top, double* __restrict__ out_n,
                             double* __restrict__ out_rows) {
  __shared__ int warp_base[kCompact / 32];
  __shared__ int s_base, s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_base = 0;
  __syncthreads();
  for (int r0 = 0; r0 < P && s_base < n_top; r0 += kCompact) {
    const int r = r0 + threadIdx.x;
    const bool f = r < P && row_flag[r] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_base[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int acc = 0;
      for (int w = 0; w < kCompact / 32; ++w) {
        const int t = warp_base[w];
        warp_base[w] = acc;
        acc += t;
      }
      s_total = acc;
    }
    __syncthreads();
    const int pos = s_base + warp_base[warp] +
                    __popc(ballot & ((1u << lane) - 1u));
    if (f && pos < n_top) out_rows[pos] = static_cast<double>(r);
    __syncthreads();
    if (threadIdx.x == 0) s_base += s_total;
    __syncthreads();
  }
  const int taken = min(s_base, n_top);
  for (int k = taken + threadIdx.x; k < n_top; k += blockDim.x)
    out_rows[k] = -1.0;
  if (threadIdx.x == 0) *out_n = static_cast<double>(taken);
}

}  // namespace

// The launchers, one a stage; inputs as kernels/post.py's stage wrappers
// say. Each returns cudaGetLastError() after its launches.

// Stage 1, lanes start .. start + count - 1 of the C-lane inputs; out_sa
// (count A 3), out_hits (count A), out_counts (count) f64.
MAD_EXPORT int mad_post_lanes(const float* rot_m, const float* trans_m,
                              const unsigned char* failed,
                              const double* cand_rot, const double* cand_hi,
                              const double* cand_lo, int start, int count,
                              const double* x0, int N,
                              const double* hi_cloud, int A,
                              const double* lo_cloud, int B,
                              double hit_thresh, double* out_sa,
                              double* out_hits, double* out_counts,
                              cudaStream_t stream) {
  post_lanes<<<count, kThreads, 0, stream>>>(
      rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo, x0, N, hi_cloud,
      A, lo_cloud, B, hit_thresh * hit_thresh, start, out_sa, out_hits,
      out_counts);
  return static_cast<int>(cudaGetLastError());
}

// Stages 2-3 on all C lanes: counts (C) f64 from stage 1; scratch rmat
// (C (S + C)) f64 and lane_of (C) int32; out_acc, out_slot (C) f64.
MAD_EXPORT int mad_post_dedup(const float* coords,
                              const unsigned char* failed,
                              const double* counts, int C, int N,
                              const double* prev, int S,
                              const long long* idx, int n, double dedup,
                              double* rmat, int* lane_of, double* out_acc,
                              double* out_slot, cudaStream_t stream) {
  post_rmsd<<<C, kThreads, 0, stream>>>(coords, prev, S, C, N, idx, n,
                                        rmat);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  post_scan<<<1, 32, 0, stream>>>(failed, S, C, rmat, dedup, lane_of,
                                  counts, out_acc, out_slot);
  return static_cast<int>(cudaGetLastError());
}

// Stage 4, cloud points start .. start + count - 1; acc (C) f64 from
// stage 3; elig_pt (count) uint8.
MAD_EXPORT int mad_post_points(const double* lo_cloud, int start, int count,
                               const double* prev, int S,
                               const float* coords, const double* acc,
                               int C, int N, double anchor_dist,
                               unsigned char* elig_pt, cudaStream_t stream) {
  post_elig_points<<<count, kThreads, 0, stream>>>(
      lo_cloud, start, prev, S, coords, acc, C, N, anchor_dist * anchor_dist,
      elig_pt);
  return static_cast<int>(cudaGetLastError());
}

// Stage 5, table rows start .. start + count - 1; elig_pt (B) of every
// cloud point from stage 4; row_flag (count) uint8.
MAD_EXPORT int mad_post_rows(const double* lo_rows, int start, int count,
                             const double* lo_cloud, int B,
                             const unsigned char* elig_pt,
                             const double* prev, int S, const float* coords,
                             const double* acc, int C, int N,
                             double anchor_dist, unsigned char* row_flag,
                             cudaStream_t stream) {
  post_elig_rows<<<(count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      lo_rows, start, count, lo_cloud, B, elig_pt, prev, S, coords, acc, C,
      N, anchor_dist * anchor_dist, row_flag);
  return static_cast<int>(cudaGetLastError());
}

// Stage 6 on all P rows' flags (P may be 0): out (1 + n_top) f64, the
// number of rows taken, then the rows (-1 past them).
MAD_EXPORT int mad_post_compact(const unsigned char* row_flag, int P,
                                int n_top, double* out, cudaStream_t stream) {
  post_compact<<<1, kCompact, 0, stream>>>(row_flag, P, n_top, out, out + 1);
  return static_cast<int>(cudaGetLastError());
}
