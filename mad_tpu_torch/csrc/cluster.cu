// K14: greedy pose clustering and candidate selection.
//
// Replaces mad_tpu/engine/dock_fused.py:50-129 (_cluster_select_body: the
// scan, weights, gates and candidate order) on the port's split path
// (engine/cluster.filter_pairs on the host before). Row i of the
// repeat-ordered table has the pose A = R_i^T, b = l_i - h_i @ A (float64);
// its squared cloud RMSD to the cluster founded by row j (pose A_j, b_j) is
//   r2(i, j) = trace(D^T M D) + 2 mu . (D d) + |d|^2,  D = A_j - A, d = b_j - b,
// with mu, M the subunit cloud's moments, every sum left to right as in
// kernels/cluster._cloud_r2, without FMA. The greedy scan: row i joins the
// cluster of smallest RMSD (the first on ties) unless there is none or
// sqrt(max(r2, 0)) > rmsd_cloud; then it founds a new one. Afterwards a
// cluster passes when weight >= wthresh and !(repeat < thr) (float32),
// scores repeat * weight (float32), and the passing clusters are ranked by
// (score desc, slot asc).
//
// The scan's only sequential part is which rows found a cluster: row i
// founds iff no earlier founder j is near it, near(i, j) = !isnan(r2) &&
// !(sqrt(fmax(r2, 0)) > rmsd_cloud). (The smallest r2 passes the test iff
// some r2 does: sqrt and fmax are monotone and a NaN never wins the
// argmin, so a row whose r2 are all NaN founds, as in the scan.) r2(i, j)
// itself depends on rows i and j only. So, in three launches on one
// stream:
//   1. cluster_near, a block per (32-row tile of i, 32-row tile of j <= i):
//      both tiles' poses into shared memory, then a warp per row i, a lane
//      per column j, r2 and the near test; a ballot gives the word
//      near[i][tile of j] (bits j < i only). The diagonal blocks write
//      their rows' poses to a table. The blocks also clear the outputs.
//   2. cluster_scan, one warp, over the tiles in order: lane l takes row
//      32 t + l; it is blocked if its near words AND the earlier tiles'
//      founder words are not 0 (16-byte loads of the quads of words of
//      the tiles so far, the words of a row padded to a multiple of 4; from
//      shared memory, where the block first copies them, up to kScanSmem
//      bytes: 1,302 rows); inside the tile the lowest unblocked row
//      founds, the rows near it drop out (one ballot), and so on: one step
//      a founder. Writes the founding rows in order (a founder's slot is
//      its rank) and, per row, its slot or -1 - (founders before it).
//   3. cluster_assign, a warp per row: a row that did not found takes the
//      argmin over the founders before it of (r2, slot), the first on
//      ties (r2 from the pose table, bit for bit the scan's, since a
//      founder's table entry is its row's pose), and adds one to its
//      cluster's weight (an integer atomic, so the order is free); the last
//      block (a ticket after a __threadfence) gates, scores and ranks the
//      clusters, counting for each passing cluster the clusters ahead of it
//      (n_clusters^2 compares).
// Bound: operations, ~100 float64 flops per (row, earlier founder) pair of
// the function; the grid computes every (row, earlier row) pair instead,
// about n^2 / 2 r2 spread over the SMs, so that the sequential part is one
// warp's bit operations, with no block barrier and no float64.
#include <math.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;           // rows a tile: one word of near bits
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPose = 12;           // a pose: A (3 x 3) and b (3), float64
constexpr int kScanThreads = 1024;  // the scan block, when it stages
constexpr int kScanSmem = 224 * 1024;   // bytes the scan may stage

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double dot3(const double* x, const double* y) {
  return dadd(dadd(dmul(x[0], y[0]), dmul(x[1], y[1])), dmul(x[2], y[2]));
}

// The pose of row i: A[d][e] = R[e][d], b = l - h @ A.
__device__ __forceinline__ void row_pose(const float* rot, const double* hi,
                                         const double* lo, int i, double* A,
                                         double* b) {
#pragma unroll
  for (int q = 0; q < 9; ++q)
    A[q] = static_cast<double>(rot[9 * i + 3 * (q % 3) + q / 3]);
#pragma unroll
  for (int e = 0; e < 3; ++e)
    b[e] = __dsub_rn(lo[3 * i + e],
                     dadd(dadd(dmul(hi[3 * i], A[e]),
                               dmul(hi[3 * i + 1], A[3 + e])),
                          dmul(hi[3 * i + 2], A[6 + e])));
}

// Squared cloud RMSD of the pose (A, b) to the founder pose C (field q of
// it at C[q * stride]).
__device__ double cloud_r2(const double* C, int stride, const double* A,
                           const double* b, const double* mu,
                           const double* M) {
  double D[9], d[3];
#pragma unroll
  for (int q = 0; q < 9; ++q) D[q] = __dsub_rn(C[q * stride], A[q]);
#pragma unroll
  for (int e = 0; e < 3; ++e) d[e] = __dsub_rn(C[(9 + e) * stride], b[e]);
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

__global__ void cluster_near(const float* __restrict__ rot,
                             const double* __restrict__ hi,
                             const double* __restrict__ lo,
                             const double* __restrict__ mu_g,
                             const double* __restrict__ M_g, int n, int W,
                             double rmsd, double* __restrict__ tab,
                             unsigned* __restrict__ near,
                             int* __restrict__ out) {
  __shared__ double si[kPose * kTile], sj[kPose * kTile], mu[3], M[9];
  // the block's tiles (ti, tj), tj <= ti, from its index in the triangle
  const long long blk = blockIdx.x;
  int ti = static_cast<int>((sqrt(8.0 * blk + 1.0) - 1.0) / 2.0);
  while (static_cast<long long>(ti + 1) * (ti + 2) / 2 <= blk) ++ti;
  while (static_cast<long long>(ti) * (ti + 1) / 2 > blk) --ti;
  const int tj = static_cast<int>(blk - static_cast<long long>(ti) * (ti + 1) / 2);
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    out[n + k] = -1;                  // found
    out[2 * n + k] = 0;               // weights
    out[3 * n + k] = -1;              // cand
  }
  if (threadIdx.x < 3) mu[threadIdx.x] = mu_g[threadIdx.x];
  if (threadIdx.x < 9) M[threadIdx.x] = M_g[threadIdx.x];
  if (threadIdx.x < 2 * kTile) {
    const int half = threadIdx.x / kTile, r = threadIdx.x % kTile;
    const int row = (half ? tj : ti) * kTile + r;
    if (row < n) {
      double A[9], b[3];
      row_pose(rot, hi, lo, row, A, b);
      double* s = half ? sj : si;
#pragma unroll
      for (int q = 0; q < 9; ++q) s[q * kTile + r] = A[q];
#pragma unroll
      for (int e = 0; e < 3; ++e) s[(9 + e) * kTile + r] = b[e];
      if (half == 0 && ti == tj) {
#pragma unroll
        for (int q = 0; q < 9; ++q) tab[q * n + row] = A[q];
#pragma unroll
        for (int e = 0; e < 3; ++e) tab[(9 + e) * n + row] = b[e];
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = tj * kTile + lane;
  for (int r = warp; r < kTile; r += kWarps) {
    const int i = ti * kTile + r;
    if (i >= n) break;
    double A[9], b[3];
#pragma unroll
    for (int q = 0; q < 9; ++q) A[q] = si[q * kTile + r];
#pragma unroll
    for (int e = 0; e < 3; ++e) b[e] = si[(9 + e) * kTile + r];
    bool is_near = false;
    if (j < i) {
      const double r2 = cloud_r2(sj + lane, kTile, A, b, mu, M);
      is_near = !isnan(r2) && !(sqrt(fmax(r2, 0.0)) > rmsd);
    }
    const unsigned word = __ballot_sync(0xffffffffu, is_near);
    if (lane == 0) near[static_cast<long long>(i) * W + tj] = word;
  }
}

// The founder scan by one warp over the tiles in order (note above). fw
// holds the founder words of the tiles done (0 from the current tile on):
// a row's test reads the quads of its near words that hold the tiles so
// far, from `rows` (row i's at rows + i W / 4: shared memory when
// kStaged), a word of another tile ANDed with 0.
template <bool kStaged>
__device__ void founder_scan(const uint4* rows, int n, int W, unsigned* fw,
                             int* out, unsigned* ticket) {
  const int lane = threadIdx.x;
  for (int k = lane; k < W; k += 32) fw[k] = 0u;
  __syncwarp();
  const int tiles = (n + kTile - 1) / kTile;
  int base = 0;
  for (int t = 0; t < tiles; ++t) {
    const int i = t * kTile + lane;
    const bool row = i < n;
    unsigned blocked = 0u, own = 0u;
    if (row) {
      const uint4* r = rows + static_cast<long long>(i) * (W / 4);
#pragma unroll 8
      for (int k = 0; k < (t + 3) / 4; ++k) {
        const uint4 v = kStaged ? r[k] : __ldg(r + k);
        blocked |= (v.x & fw[4 * k]) | (v.y & fw[4 * k + 1]) |
                   (v.z & fw[4 * k + 2]) | (v.w & fw[4 * k + 3]);
      }
      const unsigned* w = reinterpret_cast<const unsigned*>(r);
      own = kStaged ? w[t] : __ldg(w + t);
    }
    unsigned cand = __ballot_sync(0xffffffffu, row && blocked == 0u);
    unsigned founders = 0u;
    while (cand) {
      const int k = __ffs(cand) - 1;   // no founder below it is near it
      founders |= 1u << k;
      cand &= ~(1u << k);
      cand &= ~__ballot_sync(0xffffffffu, (own >> k) & 1u);
    }
    const bool founder = (founders >> lane) & 1u;
    const int before = base + __popc(founders & ((1u << lane) - 1u));
    if (row) {
      out[i] = founder ? before : -1 - before;
      if (founder) out[n + before] = i;
    }
    if (lane == 0) fw[t] = founders;
    __syncwarp();
    base += __popc(founders);
  }
  if (lane == 0) {
    out[4 * n] = base;
    *ticket = 0u;
  }
}

// Dynamic shared memory: the near words when ``staged`` (n W words), then
// fw (W words). A staged block (kScanThreads) copies the near words first;
// then its first warp scans.
__global__ void cluster_scan(const unsigned* __restrict__ near, int n, int W,
                             bool staged, int* __restrict__ out,
                             unsigned* __restrict__ ticket) {
  extern __shared__ uint4 dyn[];
  const long long quads = staged ? static_cast<long long>(n) * W / 4 : 0;
  unsigned* fw = reinterpret_cast<unsigned*>(dyn + quads);
  const uint4* g = reinterpret_cast<const uint4*>(near);
  if (staged) {
    for (long long k = threadIdx.x; k < quads; k += blockDim.x)
      dyn[k] = __ldg(g + k);
    __syncthreads();
  }
  if (threadIdx.x >= 32) return;
  if (staged)
    founder_scan<true>(dyn, n, W, fw, out, ticket);
  else
    founder_scan<false>(g, n, W, fw, out, ticket);
}

__global__ void cluster_assign(const float* __restrict__ rot,
                               const double* __restrict__ hi,
                               const double* __restrict__ lo,
                               const float* __restrict__ repeat,
                               const double* __restrict__ mu_g,
                               const double* __restrict__ M_g, int n,
                               int wthresh, double thr,
                               const double* __restrict__ tab,
                               unsigned* __restrict__ ticket,
                               float* __restrict__ score,
                               int* __restrict__ out) {
  __shared__ double mu[3], M[9];
  __shared__ int s_cands;
  __shared__ bool last;
  int* assign = out;
  const int* found = out + n;
  int* weights = out + 2 * n;
  int* cand = out + 3 * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 3) mu[threadIdx.x] = mu_g[threadIdx.x];
  if (threadIdx.x < 9) M[threadIdx.x] = M_g[threadIdx.x];
  if (threadIdx.x == 0) s_cands = 0;
  __syncthreads();
  const int i = blockIdx.x * kWarps + warp;
  if (i < n) {
    int slot = assign[i];
    if (slot < 0) {
      const int nb = -1 - slot;      // the founders before row i, >= 1
      double A[9], b[3];
      row_pose(rot, hi, lo, i, A, b);
      double best = INFINITY;
      int bj = INT_MAX;
      for (int c = lane; c < nb; c += 32) {
        const double r2 = cloud_r2(tab + found[c], n, A, b, mu, M);
        if (better(r2, c, best, bj)) {
          best = r2;
          bj = c;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const double ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
        if (better(ov, oj, best, bj)) {
          best = ov;
          bj = oj;
        }
      }
      slot = bj;
      if (lane == 0) assign[i] = slot;
    }
    if (lane == 0) atomicAdd(weights + slot, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // Gates and scores; -1 marks a cluster that does not pass (a passing
  // score is a repeat percentage times a weight, >= 0).
  const int ncl = out[4 * n];
  int passing = 0;
  for (int c = threadIdx.x; c < ncl; c += blockDim.x) {
    const int w = __ldcg(weights + c);
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
  if (threadIdx.x == 0) out[4 * n + 1] = s_cands;
}

}  // namespace

// rot (n, 3, 3) f32, hi / lo (n, 3) f64, repeat (n) f32, mu (3), M (3, 3)
// f64; scratch: tab (12 n) f64, the rows' poses; near (n W + 1) uint32,
// row i's near words at near[i W ..], W a multiple of 4 with 32 W >= n,
// the last word the assignment blocks' ticket; score (n) f32. out
// (4 n + 2) int32.
MAD_EXPORT int mad_cluster_select(const float* rot, const double* hi,
                                  const double* lo, const float* repeat,
                                  const double* mu, const double* M, int n,
                                  double rmsd, int wthresh, double thr,
                                  int W, double* tab, unsigned* near,
                                  float* score, int* out,
                                  cudaStream_t stream) {
  if (n == 0) return 0;
  if (W % 4 != 0 || static_cast<long long>(W) * kTile < n)
    return static_cast<int>(cudaErrorInvalidValue);
  // the scan's shared memory: the founder words, and the near words when
  // they fit
  size_t scan_bytes = static_cast<size_t>(W) * sizeof(unsigned);
  const size_t near_bytes = static_cast<size_t>(n) * W * sizeof(unsigned);
  const bool staged = scan_bytes + near_bytes <= kScanSmem;
  if (staged) scan_bytes += near_bytes;
  if (scan_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(scan_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = (n + kTile - 1) / kTile;
  unsigned* ticket = near + static_cast<long long>(n) * W;
  cluster_near<<<static_cast<unsigned>(tiles * (tiles + 1) / 2), kThreads, 0,
                 stream>>>(rot, hi, lo, mu, M, n, W, rmsd, tab, near, out);
  cluster_scan<<<1, staged ? kScanThreads : 32, scan_bytes, stream>>>(
      near, n, W, staged, out, ticket);
  cluster_assign<<<(n + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      rot, hi, lo, repeat, mu, M, n, wthresh, thr, tab, ticket, score, out);
  return static_cast<int>(cudaGetLastError());
}
