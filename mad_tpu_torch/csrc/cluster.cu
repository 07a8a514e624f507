// K14: greedy pose clustering and candidate selection, in one block.
//
// Replaces mad_tpu/engine/dock_fused.py:50-129 (_cluster_select_body: the
// scan, weights, gates and candidate order) on the port's split path
// (engine/cluster.filter_pairs on the host before). Row i of the
// repeat-ordered table has the pose A = R_i^T, b = l_i - h_i @ A (float64);
// its squared cloud RMSD to cluster c (founder pose CA, Cb) is
//   trace(D^T M D) + 2 mu . (D d) + |d|^2,  D = CA - A, d = Cb - b,
// with mu, M the subunit cloud's moments, every sum left to right as in
// kernels/cluster._cloud_r2, without FMA. The row joins the cluster of
// smallest RMSD (the first on ties) unless there is none or
// sqrt(max(r2, 0)) > rmsd_cloud; then it founds a new one. Afterwards a
// cluster passes when weight >= wthresh and !(repeat < thr) (float32),
// scores repeat * weight (float32), and the passing clusters are ranked by
// (score desc, slot asc).
//
// Bound: operations, ~100 float64 flops per (row, founded cluster) pair
// of the scan, on one SM (the scan is sequential: each row's decision
// needs the clusters the rows before it founded). Design: all threads take
// the row's RMSD to the clusters founded so far (strided), a warp-shuffle
// and shared-memory argmin with the first index on ties, then one thread
// founds or joins; three barriers a row. The cluster table (12 doubles a
// cluster) is in shared memory while it fits (96 B x n: 57.6 KB for the
// bench's 600 rows) and in device memory beyond. The ranking counts, for
// each passing cluster, the clusters ahead of it (n_clusters^2 compares).
#include <math.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double dot3(const double* x, const double* y) {
  return dadd(dadd(dmul(x[0], y[0]), dmul(x[1], y[1])), dmul(x[2], y[2]));
}

// Squared cloud RMSD of the pose (A, b) to cluster c of the table
// (structure of arrays: field f of cluster c at tab[f * cap + c]).
__device__ double cloud_r2(const double* tab, int cap, int c,
                           const double* A, const double* b,
                           const double* mu, const double* M) {
  double D[9], d[3];
#pragma unroll
  for (int q = 0; q < 9; ++q) D[q] = __dsub_rn(tab[q * cap + c], A[q]);
#pragma unroll
  for (int e = 0; e < 3; ++e) d[e] = __dsub_rn(tab[(9 + e) * cap + c], b[e]);
  double t1 = 0.0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double term = dmul(M[3 * i + k], dot3(D + 3 * i, D + 3 * k));
      t1 = (i == 0 && k == 0) ? term : dadd(t1, term);
    }
  const double u0 = dot3(D, d), u1 = dot3(D + 3, d), u2 = dot3(D + 6, d);
  const double t2 = dadd(dadd(dmul(mu[0], u0), dmul(mu[1], u1)),
                         dmul(mu[2], u2));
  return dadd(dadd(t1, dmul(2.0, t2)), dot3(d, d));
}

__device__ __forceinline__ bool better(double v, int j, double w, int k) {
  return v < w || (v == w && j < k);
}

__global__ void cluster_select(const float* __restrict__ rot,
                               const double* __restrict__ hi,
                               const double* __restrict__ lo,
                               const float* __restrict__ repeat,
                               const double* __restrict__ mu_g,
                               const double* __restrict__ M_g, int n,
                               double rmsd, int wthresh, double thr,
                               double* gtab, float* __restrict__ score,
                               int* __restrict__ out) {
  extern __shared__ double stab[];
  __shared__ double A[9], b[3], mu[3], M[9];
  __shared__ double red_v[kThreads / 32];
  __shared__ int red_j[kThreads / 32];
  __shared__ int s_ncl, s_cands;
  double* tab = gtab != nullptr ? gtab : stab;
  int* assign = out;
  int* found = out + n;
  int* weights = out + 2 * n;
  int* cand = out + 3 * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    found[i] = -1;
    weights[i] = 0;
    cand[i] = -1;
  }
  if (threadIdx.x < 3) mu[threadIdx.x] = mu_g[threadIdx.x];
  if (threadIdx.x < 9) M[threadIdx.x] = M_g[threadIdx.x];
  if (threadIdx.x == 0) {
    s_ncl = 0;
    s_cands = 0;
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    if (threadIdx.x < 9) {            // A[d][e] = R[e][d]
      const int d = threadIdx.x / 3, e = threadIdx.x % 3;
      A[threadIdx.x] = static_cast<double>(rot[9 * i + 3 * e + d]);
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      const int e = threadIdx.x;
      b[e] = __dsub_rn(lo[3 * i + e],
                       dadd(dadd(dmul(hi[3 * i], A[e]),
                                 dmul(hi[3 * i + 1], A[3 + e])),
                            dmul(hi[3 * i + 2], A[6 + e])));
    }
    __syncthreads();
    const int ncl = s_ncl;
    double best = INFINITY;
    int bj = INT_MAX;
    for (int c = threadIdx.x; c < ncl; c += blockDim.x) {
      const double r2 = cloud_r2(tab, n, c, A, b, mu, M);
      if (better(r2, c, best, bj)) {
        best = r2;
        bj = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oj = __shfl_down_sync(0xffffffffu, bj, off);
      if (better(ov, oj, best, bj)) {
        best = ov;
        bj = oj;
      }
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_j[warp] = bj;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / 32; ++w)
        if (better(red_v[w], red_j[w], best, bj)) {
          best = red_v[w];
          bj = red_j[w];
        }
      int slot = bj;
      if (ncl == 0 || sqrt(fmax(best, 0.0)) > rmsd) {
        slot = ncl;
#pragma unroll
        for (int q = 0; q < 9; ++q) tab[q * n + slot] = A[q];
#pragma unroll
        for (int e = 0; e < 3; ++e) tab[(9 + e) * n + slot] = b[e];
        found[slot] = i;
        weights[slot] = 1;
        s_ncl = ncl + 1;
      } else {
        weights[slot] += 1;
      }
      assign[i] = slot;
    }
    __syncthreads();
  }

  // Gates and scores; -1 marks a cluster that does not pass (a passing
  // score is a repeat percentage times a weight, >= 0).
  const int ncl = s_ncl;
  int passing = 0;
  for (int c = threadIdx.x; c < ncl; c += blockDim.x) {
    const int w = weights[c];
    const float rep = repeat[found[c]];
    const bool gate = w >= wthresh && !(static_cast<double>(rep) < thr);
    score[c] = gate ? __fmul_rn(rep, static_cast<float>(w)) : -1.0f;
    passing += gate ? 1 : 0;
  }
  if (passing) atomicAdd(&s_cands, passing);
  __syncthreads();
  for (int c = threadIdx.x; c < ncl; c += blockDim.x) {
    const float s = score[c];
    if (s < 0.0f) continue;
    int rank = 0;
    for (int c2 = 0; c2 < ncl; ++c2) {
      const float s2 = score[c2];
      rank += (s2 > s || (s2 == s && c2 < c)) ? 1 : 0;
    }
    cand[rank] = c;
  }
  if (threadIdx.x == 0) {
    out[4 * n] = ncl;
    out[4 * n + 1] = s_cands;
  }
}

}  // namespace

// rot (n, 3, 3) f32, hi / lo (n, 3) f64, repeat (n) f32, mu (3), M (3, 3)
// f64; the cluster table in shared memory when table_in_smem, else in
// gtab (12 n f64); score (n) f32 scratch; out (4 n + 2) int32.
MAD_EXPORT int mad_cluster_select(const float* rot, const double* hi,
                                  const double* lo, const float* repeat,
                                  const double* mu, const double* M, int n,
                                  double rmsd, int wthresh, double thr,
                                  int table_in_smem, double* gtab,
                                  float* score, int* out,
                                  cudaStream_t stream) {
  if (n == 0) return 0;
  const size_t bytes = table_in_smem ? static_cast<size_t>(n) * 12 * 8 : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_select, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cluster_select<<<1, kThreads, bytes, stream>>>(
      rot, hi, lo, repeat, mu, M, n, rmsd, wthresh, thr,
      table_in_smem ? nullptr : gtab, score, out);
  return static_cast<int>(cudaGetLastError());
}
