// K16: the post-refine merge and the rescue eligibility of a docking round.
//
// Replaces mad_tpu/engine/dock_fused.py:344-453 (the _compiled_dock_post
// body) on the port's split path, whose host version (mad_tpu's
// engine/docking._merge_refined, numpy and cKDTree) computes in float64;
// so does this file, on the same inputs (kernels/post.py says what each
// output is). Five launchers (the stages), on one stream, and on one
// device a sixth that runs stages 1 and 2 in one grid (mad_post_lanes_dedup,
// one ticket: the dedup scan needs the lanes' counts only in its last
// block):
//   1. post_lanes, ceil(A / 8) blocks a lane of a range (lane_group; a
//      block a lane before): each block the composed pose
//      (A = rot^T, b = lo - hi A, center = mean(x0 A + b) by a block sum in
//      one fixed order), then a warp per subunit anchor of its group moves
//      it, s_a = ((h A + b) - center) R + center + t, and takes its least
//      squared distance to the map anchors (staged in shared memory, lanes
//      over them with two running minima, a shuffle min); hit = d2 <
//      hit_thresh^2, counted by barrier counts and summed over the
//      lane's blocks, which are a cluster (or, in the fold, by a ticket);
//   2. post_dedup_k (mad_post_dedup), a block per (lane i, 8 targets): its
//      CA-RMSD to each earlier solution and to each lane of the round, lane
//      i's RMSD atoms staged in shared memory, a warp per pair, lanes over
//      atoms; the last block (a ticket) stages the RMSDs in shared memory
//      and runs the greedy dedup with one warp, in candidate order, 32
//      lanes a tile by ballots (dedup_scan): merge into the accepted
//      solution of least CA-RMSD (first index on ties) below dedup_rmsd,
//      else a new solution;
//   3. post_elig_points, a block per (tile of map-anchor cloud points of a
//      range, run of atoms): each point's least squared distance to the
//      run's atoms of every accepted solution (the earlier rounds' and
//      this round's accepted lanes), staged in shared memory, a point in a
//      register of every warp; the last block takes the least over the
//      runs;
//   4. post_elig_rows, a thread per table row of a range: finds its map
//      anchor in the cloud by a binary search (below) and takes that
//      point's answer; a row whose anchor is not found is measured against
//      the atoms itself; eligible = !(d2 < anchor_dist^2), as cKDTree's
//      upper bound decides;
//   5. post_compact, one block: the first n_top eligible rows in table
//      order, 16 flags a thread (one 16-byte load, a bit mask counted by
//      __popc), a block scan per 16 K rows, stopping once n_top are taken.
// Stages 1, 3 and 4 take a (start, count) range of lanes, points or rows
// and write count outputs: on a mesh (mad_tpu's lane_map_fn and
// pair_scan_fn, engine/dock_fused.py:455-524) each shard runs them on its
// block on its own device, and 2 and 5 run once on the gathered results
// (the replicated dedup scan and compaction there); a lane's, point's or
// row's result does not depend on the range it is computed in.
// Products, sums and differences are __dmul_rn / __dadd_rn / __dsub_rn in
// the plain version's order, so the poses and distances round as there
// (the center's sum and the RMSD sums run in another order: within 1e-12).
//
// The row search. The cloud is np.unique(..., axis=0) of the pairs' map
// anchors (engine/match.py), so it is sorted ascending by (x, y, z),
// compared as floats (-0.0 == 0.0, which np.unique keeps once). The
// search takes the first cloud point not below the row in that order and
// accepts it only when its three coordinates equal the row's. A row that
// is not found (off the cloud, a NaN, or a cloud out of order) takes the
// atoms_min branch, which gives the answer the point stage gives an equal
// point: the squared distances of equal coordinates are equal (a signed
// zero's difference squares to +0.0), and min_nan over them does not
// depend on their order. So a cloud out of order costs time, never a
// result.
//
// The lane stage had a block a lane, 28 of the card's 132 SMs at the
// bench, each a chain of three block sums and four anchors a warp one
// after another, and its own launch and wrapper a round (0.0985 ms of
// events for 0.0099 ms of kernel). Now 112 blocks at the bench, one pass
// of barriers for the center, one anchor a warp; on one device the fold
// takes its launch away.
//
// Bound: float64 operations, ~9 per anchor-to-point distance, atom pair of
// an RMSD and point-to-atom distance of the eligibility (bench: 28 lanes x
// 32 anchors x 414 points, 28 x 28 RMSDs of 260 CA atoms, 414 points x
// 16,640 atoms), a few microseconds of the card. Without FMA (the plain
// version's roundings) a distance is 9 float64 instructions, and the
// point stage's 6.9 M of them set its floor; the stages' launches and
// the dedup's one-warp scan set the rest.
#include <math.h>
#include <limits.h>

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 1024;        // dedup: RMSD atoms staged at a time
                                    // (lanes: map anchors)
constexpr int kLaneBlocks = 8;      // lanes: blocks (a cluster) a lane
constexpr int kAtomsAhead = 4;      // lanes: x0 atoms a thread reads first
constexpr int kPointTile = 32;      // points: cloud points a block
constexpr int kAtomChunk = 1024;    // points: atoms a block (at most)
constexpr int kCompact = 1024;      // compaction: threads, 16 rows each

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

// The least of a and b, NaN when either is, as torch.amin takes it (fmin
// would pass over a NaN); otherwise the least, whatever the order.
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = dadd(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Blocks a lane of the lane stage: one a group of kWarps anchors, at most
// kLaneBlocks (one when there are none).
__host__ __device__ __forceinline__ int lane_blocks(int A) {
  return A > kWarps ? min((A + kWarps - 1) / kWarps, kLaneBlocks) : 1;
}

// True when the last of the launch's blocks arrives: every thread's writes
// made before it are then visible to the block that gets true (a ticket
// after a __threadfence). Call from every thread of the block.
__device__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// G = lane_blocks(A) blocks a lane o of a range (at most kLaneBlocks), a
// warp an anchor: warp w of block g takes anchors g kWarps + w + k kWarps G.
// Every block of a lane recomputes the lane's pose and center in the order
// of the earlier form (one block a lane): kThreads strided partial sums,
// each warp's xor tree, then warps 0 .. kWarps - 1 in order, the three
// coordinates in one pass; so each holds the same bits. The map anchors
// are staged kStage at a time in cloud (x | y | z, kStage doubles each:
// lanes read neighbouring words); the first chunk, the pose, the warp's
// first anchor and each thread's first kAtomsAhead atoms are read before
// the first barrier. A warp's lanes run over the staged map anchors with
// two running minima. The block's hits are counted by barrier counts, and
// the lane's count is the sum of its G blocks': kCluster, the G blocks are
// a cluster and the first sums them through distributed shared memory
// after a cluster barrier (no scratch to clear); else a 64-bit ticket
// (blocks arrived << 32 | hits; zeroed by the launcher) whose last arrival
// writes it. A failed lane's blocks write zeros.
template <bool kCluster>
__device__ void lane_group(int blk, const float* __restrict__ rot_m,
                           const float* __restrict__ trans_m,
                           const unsigned char* __restrict__ failed,
                           const double* __restrict__ cand_rot,
                           const double* __restrict__ cand_hi,
                           const double* __restrict__ cand_lo,
                           const double* __restrict__ x0, int N,
                           const double* __restrict__ hi_cloud, int A,
                           const double* __restrict__ lo_cloud, int B,
                           double thr2, int start, double* cloud,
                           unsigned long long* lane_tk,
                           double* __restrict__ out_sa,
                           double* __restrict__ out_hits,
                           double* __restrict__ out_counts) {
  __shared__ double sA[9], sR[9], sb[3], sc[3], st[3], red[3][kWarps];
  const int G = lane_blocks(A);
  const int o = blk / G, g = blk % G, c = start + o;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int step = kWarps * G, first = g * kWarps + warp;
  // Every global read that needs nothing of the block is issued first:
  // the lane's flag, its pose, the warp's first anchor and the first chunk
  // of the map anchors; one barrier then shows the pose and the chunk.
  double pA = 0.0, pR = 0.0, pt = 0.0, pb = 0.0, ha[3] = {0.0, 0.0, 0.0};
  if (threadIdx.x < 9) {            // A[d][e] = rot[e][d]
    const int d = threadIdx.x / 3, e = threadIdx.x % 3;
    pA = cand_rot[9 * c + 3 * e + d];
    pR = static_cast<double>(rot_m[9 * c + threadIdx.x]);
  }
  if (threadIdx.x < 3) {            // b = lo - hi A, as vecmat(hi, A, e)
    const int e = threadIdx.x;
    const double* h = cand_hi + 3 * c;
    const double* r = cand_rot + 9 * c + 3 * e;
    pt = static_cast<double>(trans_m[3 * c + e]);
    pb = dsub(cand_lo[3 * c + e],
              dadd(dadd(dmul(h[0], r[0]), dmul(h[1], r[1])),
                   dmul(h[2], r[2])));
  }
  if (first < A)
    for (int e = 0; e < 3; ++e) ha[e] = hi_cloud[3 * first + e];
  double xp[kAtomsAhead][3];        // the thread's first atoms of x0
#pragma unroll
  for (int k = 0; k < kAtomsAhead; ++k) {
    const int n = threadIdx.x + k * kThreads;
    for (int e = 0; e < 3; ++e) xp[k][e] = n < N ? x0[3 * n + e] : 0.0;
  }
  if (failed[c]) {
    for (int a = first; a < A; a += step) {
      const long long ca = static_cast<long long>(o) * A + a;
      if (lane < 3) out_sa[3 * ca + lane] = 0.0;
      if (lane == 0) out_hits[ca] = 0.0;
    }
    if (g == 0 && threadIdx.x == 0) out_counts[o] = 0.0;
    return;
  }
  const bool once = B <= kStage;    // the map anchors staged once
  auto stage = [&](int j0, int m) {
    for (int q = threadIdx.x; q < m; q += blockDim.x) {
      cloud[q] = lo_cloud[3 * (j0 + q)];
      cloud[kStage + q] = lo_cloud[3 * (j0 + q) + 1];
      cloud[2 * kStage + q] = lo_cloud[3 * (j0 + q) + 2];
    }
  };
  if (once) stage(0, B);
  if (threadIdx.x < 9) {
    sA[threadIdx.x] = pA;
    sR[threadIdx.x] = pR;
  }
  if (threadIdx.x < 3) {
    st[threadIdx.x] = pt;
    sb[threadIdx.x] = pb;
  }
  __syncthreads();
  double acc[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 0; k < kAtomsAhead; ++k)
    if (threadIdx.x + k * kThreads < N)
      for (int e = 0; e < 3; ++e)
        acc[e] = dadd(acc[e], dadd(vecmat(xp[k], sA, e), sb[e]));
#pragma unroll 4
  for (int n = threadIdx.x + kAtomsAhead * kThreads; n < N; n += kThreads)
    for (int e = 0; e < 3; ++e)
      acc[e] = dadd(acc[e], dadd(vecmat(x0 + 3 * n, sA, e), sb[e]));
  for (int e = 0; e < 3; ++e) {
    acc[e] = warp_sum(acc[e]);
    if (lane == 0) red[e][warp] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int e = threadIdx.x;
    double v = red[e][0];
    for (int w = 1; w < kWarps; ++w) v = dadd(v, red[e][w]);
    sc[e] = v / N;
  }
  __syncthreads();
  int hits = 0;
  for (int a0 = g * kWarps; a0 < A; a0 += step) {      // block-uniform
    const int a = a0 + warp;
    double s[3] = {0.0, 0.0, 0.0};
    if (a < A) {
      if (a != first)
        for (int e = 0; e < 3; ++e) ha[e] = hi_cloud[3 * a + e];
      double u[3];
      for (int e = 0; e < 3; ++e)
        u[e] = dsub(dadd(vecmat(ha, sA, e), sb[e]), sc[e]);
      for (int e = 0; e < 3; ++e)
        s[e] = dadd(dadd(vecmat(u, sR, e), sc[e]), st[e]);
    }
    double best0 = INFINITY, best1 = INFINITY;
    for (int j0 = 0; j0 < B; j0 += kStage) {
      const int m = min(kStage, B - j0);
      if (!once) {
        __syncthreads();
        stage(j0, m);
        __syncthreads();
      }
      if (a < A) {
        int j = lane;
        for (; j + 32 < m; j += 64) {
          best0 = min_nan(best0, dist2(s, cloud[j], cloud[kStage + j],
                                       cloud[2 * kStage + j]));
          best1 = min_nan(best1, dist2(s, cloud[j + 32],
                                       cloud[kStage + j + 32],
                                       cloud[2 * kStage + j + 32]));
        }
        if (j < m)
          best0 = min_nan(best0, dist2(s, cloud[j], cloud[kStage + j],
                                       cloud[2 * kStage + j]));
      }
    }
    const bool hit = a < A && warp_min(min_nan(best0, best1)) < thr2;
    if (a < A && lane == 0) {
      const long long ca = static_cast<long long>(o) * A + a;
      for (int e = 0; e < 3; ++e) out_sa[3 * ca + e] = s[e];
      out_hits[ca] = hit ? 1.0 : 0.0;
    }
    hits += __syncthreads_count(lane == 0 && hit);
  }
  if constexpr (kCluster) {
    __shared__ int part[kLaneBlocks];
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) cluster.map_shared_rank(part, 0)[g] = hits;
    cluster.sync();
    if (g == 0 && threadIdx.x == 0) {
      int total = 0;
      for (int k = 0; k < G; ++k) total += part[k];
      out_counts[o] = static_cast<double>(total);
    }
  } else if (threadIdx.x == 0) {
    if (G == 1) {
      out_counts[o] = static_cast<double>(hits);
    } else {
      const unsigned long long old = atomicAdd(
          lane_tk + o, (1ULL << 32) | static_cast<unsigned>(hits));
      if (static_cast<int>(old >> 32) == G - 1)
        out_counts[o] = static_cast<double>((old & 0xffffffffULL) + hits);
    }
  }
}

// Stage 1 alone (the mesh's shards): lane_group over the range's blocks,
// launched in clusters of lane_blocks(A).
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
  __shared__ double cloud[3 * kStage];
  lane_group<true>(blockIdx.x, rot_m, trans_m, failed, cand_rot, cand_hi,
                   cand_lo, x0, N, hi_cloud, A, lo_cloud, B, thr2, start,
                   cloud, nullptr, out_sa, out_hits, out_counts);
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

// The greedy dedup by one warp, in candidate order, 32 lanes a tile. Lane
// i is valid unless failed or hitless; the accepted solutions before it
// are the S earlier ones (column k of its row of R) and this round's
// accepted lanes before it (column S + acc_lanes[k - S]). A valid lane
// merges iff one of them lies below dedup: then so does the least, which
// the argmin finds (a NaN never wins it), and otherwise it is accepted. So,
// as in csrc/cluster.cu's founder scan: a lane is blocked by an earlier
// solution or an earlier tile's accepted lane below dedup; inside the
// tile the lowest unblocked valid lane is accepted and one ballot drops
// the lanes below dedup of it; then each merged lane takes its argmin over
// the accepted before it (the first on ties). Staged: R, acc_lanes and the
// valid flags in shared memory; else R is rmat and counts are read through
// L2 (the launch's other blocks wrote them), and acc_lanes is lane_of.
template <bool kStaged>
__device__ void dedup_scan(const double* R, int* acc_lanes, const int* ok,
                           const unsigned char* failed,
                           const double* counts, int S, int C, double dedup,
                           double* out_acc, double* out_slot) {
  auto at = [](const double* p) {
    if constexpr (kStaged) return *p;
    else return __ldcg(p);
  };
  const int lane = threadIdx.x;
  int n_acc = 0;
  for (int t0 = 0; t0 < C; t0 += 32) {
    const int i = t0 + lane;
    const bool row = i < C;
    const double* r = R + static_cast<long long>(i) * (S + C);
    bool valid = false, blocked = false;
    if (row) {
      valid = kStaged ? ok[i] != 0
                      : !(failed[i] || __ldcg(counts + i) <= 0.0);
      for (int k = 0; valid && !blocked && k < S; ++k)
        blocked = at(r + k) < dedup;
      for (int a = 0; valid && !blocked && a < n_acc; ++a)
        blocked = at(r + S + acc_lanes[a]) < dedup;
    }
    unsigned cand = __ballot_sync(0xffffffffu, valid && !blocked);
    unsigned accepted = 0u;
    while (cand) {
      const int k = __ffs(cand) - 1;   // no accepted lane below it is near
      accepted |= 1u << k;
      cand &= ~(1u << k);
      cand &= ~__ballot_sync(0xffffffffu,
                             valid && at(r + S + t0 + k) < dedup);
    }
    const int below = __popc(accepted & ((1u << lane) - 1u));
    const bool acc = (accepted >> lane) & 1u;
    if (acc) acc_lanes[n_acc + below] = i;
    __syncwarp();
    if (row) {
      int slot = -1;
      if (acc) {
        slot = S + n_acc + below;
      } else if (valid) {
        double best = INFINITY;
        for (int k = 0; k < S + n_acc + below; ++k) {
          const double v = at(r + (k < S ? k : S + acc_lanes[k - S]));
          if (v < best) {             // k ascends: the first on ties
            best = v;
            slot = k;
          }
        }
      }
      out_acc[i] = acc ? 1.0 : 0.0;
      out_slot[i] = static_cast<double>(slot);
    }
    n_acc += __popc(accepted);
  }
}

// Block blk of the RMSDs, a block per (lane i, kWarps targets): lane i's
// RMSD atoms (idx and coordinates) staged in shared memory kStage at a
// time, then a warp per target j, lanes over the atoms a = lane, lane +
// 32, ..., each lane's sum in ascending a and the warp's sum by warp_sum
// (the order of a warp per pair).
__device__ void dedup_rmsd(int blk, const float* __restrict__ coords,
                           const double* __restrict__ prev, int S, int C,
                           int N, const long long* __restrict__ idx, int n,
                           int groups, double* __restrict__ rmat, double* sp,
                           int* sidx) {
  const int i = blk / groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = (blk % groups) * kWarps + warp;
  double sum = 0.0;
  for (int a0 = 0; a0 < n; a0 += kStage) {
    const int m = min(kStage, n - a0);
    __syncthreads();
    for (int a = threadIdx.x; a < m; a += blockDim.x) {
      const long long k = idx[a0 + a];
      sidx[a] = static_cast<int>(k);
      target_atom(prev, coords, S, N, S + i, k, sp + 3 * a);
    }
    __syncthreads();
    if (j < S + C) {
#pragma unroll 4
      for (int a = lane; a < m; a += 32) {
        double q[3];
        target_atom(prev, coords, S, N, j, sidx[a], q);
        sum = dadd(sum, dist2(sp + 3 * a, q[0], q[1], q[2]));
      }
    }
  }
  if (j < S + C) {
    sum = warp_sum(sum);
    if (lane == 0)
      rmat[static_cast<long long>(i) * (S + C) + j] = sqrt(sum / n);
  }
}

// The launch's last block: rmat and the lanes' flags staged in shared
// memory where they fit, and the dedup scan by its first warp. rmat and
// counts are read through L2: other blocks of the launch wrote them.
__device__ void dedup_last(const double* rmat,
                           const unsigned char* __restrict__ failed,
                           const double* counts, int S, int C, double dedup,
                           int* lane_of, double* __restrict__ out_acc,
                           double* __restrict__ out_slot, double* sp,
                           int* sidx) {
  const int warp = threadIdx.x >> 5;
  const long long cells = static_cast<long long>(C) * (S + C);
  if (cells <= 3 * kStage && 2 * C <= kStage) {
    for (int k = threadIdx.x; k < cells; k += blockDim.x)
      sp[k] = __ldcg(rmat + k);
    for (int k = threadIdx.x; k < C; k += blockDim.x)
      sidx[C + k] = !(failed[k] || __ldcg(counts + k) <= 0.0);
    __syncthreads();
    if (warp == 0)
      dedup_scan<true>(sp, sidx, sidx + C, failed, counts, S, C, dedup,
                       out_acc, out_slot);
  } else if (warp == 0) {
    dedup_scan<false>(rmat, lane_of, nullptr, failed, counts, S, C, dedup,
                      out_acc, out_slot);
  }
}

// Stage 2 alone: the RMSD blocks, then the last block's scan (a ticket).
__global__ void post_dedup_k(const float* __restrict__ coords,
                             const double* __restrict__ prev, int S, int C,
                             int N, const long long* __restrict__ idx, int n,
                             int groups, double* __restrict__ rmat,
                             const unsigned char* __restrict__ failed,
                             const double* __restrict__ counts,
                             double dedup, int* __restrict__ lane_of,
                             double* __restrict__ out_acc,
                             double* __restrict__ out_slot) {
  __shared__ double sp[3 * kStage];
  __shared__ int sidx[kStage];
  dedup_rmsd(blockIdx.x, coords, prev, S, C, N, idx, n, groups, rmat, sp,
             sidx);
  if (!last_block(reinterpret_cast<unsigned*>(lane_of + C))) return;
  dedup_last(rmat, failed, counts, S, C, dedup, lane_of, out_acc, out_slot,
             sp, sidx);
}

// Stages 1 and 2 in one grid (one device): blocks 0 .. lane_grid - 1 are
// lane_group's over all C lanes, the rest dedup_rmsd's; one ticket (after
// the C lane tickets in tk) elects the last block, which reads the lanes'
// counts through L2 and runs the scan.
__global__ void post_lanes_dedup(const float* __restrict__ rot_m,
                                 const float* __restrict__ trans_m,
                                 const float* __restrict__ coords,
                                 const unsigned char* __restrict__ failed,
                                 const double* __restrict__ cand_rot,
                                 const double* __restrict__ cand_hi,
                                 const double* __restrict__ cand_lo, int C,
                                 const double* __restrict__ x0, int N,
                                 const double* __restrict__ hi_cloud, int A,
                                 const double* __restrict__ lo_cloud, int B,
                                 double thr2, int lane_grid,
                                 const double* __restrict__ prev, int S,
                                 const long long* __restrict__ idx, int n,
                                 int groups, double dedup,
                                 double* __restrict__ rmat, int* lane_of,
                                 unsigned long long* tk,
                                 double* __restrict__ out_sa,
                                 double* __restrict__ out_hits,
                                 double* out_counts,
                                 double* __restrict__ out_acc,
                                 double* __restrict__ out_slot) {
  __shared__ double sp[3 * kStage];
  __shared__ int sidx[kStage];
  if (static_cast<int>(blockIdx.x) < lane_grid)
    lane_group<false>(blockIdx.x, rot_m, trans_m, failed, cand_rot,
                      cand_hi, cand_lo, x0, N, hi_cloud, A, lo_cloud, B,
                      thr2, 0, sp, tk, out_sa, out_hits, out_counts);
  else
    dedup_rmsd(blockIdx.x - lane_grid, coords, prev, S, C, N, idx, n,
               groups, rmat, sp, sidx);
  if (!last_block(reinterpret_cast<unsigned*>(tk + C))) return;
  dedup_last(rmat, failed, out_counts, S, C, dedup, lane_of, out_acc,
             out_slot, sp, sidx);
}

// Least squared distance of p to the atoms of the earlier solutions and of
// the accepted lanes.
__device__ double atoms_min(const double* p, const double* prev, int S,
                            const float* coords, const double* acc, int C,
                            int N) {
  const long long n_prev = static_cast<long long>(S) * N;
  const long long total = n_prev + static_cast<long long>(C) * N;
  double best = INFINITY;
  for (long long t = 0; t < total; ++t) {
    if (t < n_prev) {
      best = min_nan(best, dist2(p, prev[3 * t], prev[3 * t + 1],
                                 prev[3 * t + 2]));
    } else {
      const long long k = t - n_prev;
      if (acc[k / N] == 0.0) continue;
      best = min_nan(best, dist2(p, static_cast<double>(coords[3 * k]),
                                 static_cast<double>(coords[3 * k + 1]),
                                 static_cast<double>(coords[3 * k + 2])));
    }
  }
  return best;
}

// A block per (tile of kPointTile points, run of `per` atoms of the
// (S + C) N): a lane holds kPointTile / 32 points in registers; the run's
// atoms of the earlier solutions and of the accepted lanes are staged in
// shared memory, kAtomChunk at a time (a rejected lane's skipped a
// solution at a time), and warp w takes the staged atoms w, w + kWarps,
// ... (the warp's lanes read one atom: a broadcast); each point's least
// over the run goes to part[run][point], and the last block (a ticket)
// takes each point's least over the runs. min_nan over the same squared
// distances does not depend on their order (none is -0.0; a NaN among
// them gives NaN, as in the plain version), so the flags are those of any
// order.
__global__ void post_elig_points(const double* __restrict__ lo_cloud,
                                 int start, int count,
                                 const double* __restrict__ prev, int S,
                                 const float* __restrict__ coords,
                                 const double* __restrict__ acc, int C,
                                 int N, long long per, double ad2,
                                 double* __restrict__ part,
                                 unsigned char* __restrict__ elig_pt) {
  constexpr int kPer = kPointTile / 32;
  __shared__ double sa[3 * kAtomChunk];
  __shared__ double red[kWarps][kPointTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int runs = gridDim.y;
  double p[kPer][3], best[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int o = min(static_cast<int>(blockIdx.x) * kPointTile + u * 32 +
                      lane, count - 1);
    const double* q = lo_cloud + 3LL * (start + o);
    p[u][0] = q[0];
    p[u][1] = q[1];
    p[u][2] = q[2];
    best[u] = INFINITY;
  }
  const long long total = static_cast<long long>(S + C) * N;
  const long long n_prev = static_cast<long long>(S) * N;
  const long long run_end = min((blockIdx.y + 1) * per, total);
  for (long long t0 = blockIdx.y * per; t0 < run_end; t0 += kAtomChunk) {
    const long long t1 = min(t0 + kAtomChunk, run_end);
    int m = 0;                          // atoms staged
    __syncthreads();
    for (long long t = t0; t < t1;) {
      const int sol = static_cast<int>(t / N);
      const long long end = min(t1, static_cast<long long>(sol + 1) * N);
      if (sol < S) {
        for (long long u = t + threadIdx.x; u < end; u += blockDim.x) {
          double* d = sa + 3 * (m + (u - t));
          d[0] = prev[3 * u];
          d[1] = prev[3 * u + 1];
          d[2] = prev[3 * u + 2];
        }
        m += static_cast<int>(end - t);
      } else if (acc[sol - S] != 0.0) {
        for (long long u = t + threadIdx.x; u < end; u += blockDim.x) {
          const float* a = coords + 3 * (u - n_prev);
          double* d = sa + 3 * (m + (u - t));
          d[0] = static_cast<double>(a[0]);
          d[1] = static_cast<double>(a[1]);
          d[2] = static_cast<double>(a[2]);
        }
        m += static_cast<int>(end - t);
      }
      t = end;
    }
    __syncthreads();
#pragma unroll 4
    for (int a = warp; a < m; a += kWarps) {
      const double ax = sa[3 * a], ay = sa[3 * a + 1], az = sa[3 * a + 2];
#pragma unroll
      for (int v = 0; v < kPer; ++v)
        best[v] = min_nan(best[v], dist2(p[v], ax, ay, az));
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) red[warp][u * 32 + lane] = best[u];
  __syncthreads();
  for (int q = threadIdx.x; q < kPointTile; q += blockDim.x) {
    const int o = blockIdx.x * kPointTile + q;
    if (o < count) {
      double b = red[0][q];
      for (int w = 1; w < kWarps; ++w) b = min_nan(b, red[w][q]);
      part[static_cast<long long>(blockIdx.y) * count + o] = b;
    }
  }
  if (!last_block(reinterpret_cast<unsigned*>(
          part + static_cast<long long>(runs) * count)))
    return;
  for (int o = threadIdx.x; o < count; o += blockDim.x) {
    double b = INFINITY;
    for (int c = 0; c < runs; ++c)
      b = min_nan(b, __ldcg(part + static_cast<long long>(c) * count + o));
    elig_pt[o] = b < ad2 ? 0 : 1;
  }
}

// q < p in (x, y, z) order, as floats.
__device__ __forceinline__ bool row_less(const double* q, double x, double y,
                                         double z) {
  return q[0] < x || (q[0] == x && (q[1] < y || (q[1] == y && q[2] < z)));
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
  const double x = p[0], y = p[1], z = p[2];
  int lo = 0, hi = B;               // the first cloud point not below p
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row_less(lo_cloud + 3 * mid, x, y, z))
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo < B) {
    const double* q = lo_cloud + 3 * lo;
    if (q[0] == x && q[1] == y && q[2] == z) {
      row_flag[o] = elig_pt[lo];
      return;
    }
  }
  row_flag[o] = atoms_min(p, prev, S, coords, acc, C, N) < ad2 ? 0 : 1;
}

// Bit b of the result: byte b of w is not 0.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned m = __vcmpne4(w, 0u);         // 0xff a nonzero byte
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
         ((m >> 28) & 8u);
}

// Thread t takes rows r0 + 16 t .. + 15 of a chunk of 16 kCompact rows
// (row_flag is 16-byte aligned); an inclusive warp scan of the counts,
// the warps' totals scanned by warp 0 (two buffers, so two barriers a
// chunk); each thread writes its rows at their positions below n_top.
__global__ void post_compact(const unsigned char* __restrict__ row_flag,
                             int P, int n_top, double* __restrict__ out_n,
                             double* __restrict__ out_rows) {
  __shared__ int warp_base[2][kCompact / 32 + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0, buf = 0;
  for (long long r0 = 0; r0 < P && base < n_top; r0 += 16LL * kCompact) {
    const long long r = r0 + 16LL * threadIdx.x;
    unsigned m = 0u;
    if (r + 16 <= P) {
      const uint4 v = *reinterpret_cast<const uint4*>(row_flag + r);
      m = nonzero_bytes(v.x) | (nonzero_bytes(v.y) << 4) |
          (nonzero_bytes(v.z) << 8) | (nonzero_bytes(v.w) << 12);
    } else {
      for (int b = 0; r + b < P; ++b)
        m |= (row_flag[r + b] != 0 ? 1u : 0u) << b;
    }
    const int cnt = __popc(m);
    int inc = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += y;
    }
    int* wb = warp_base[buf];
    if (lane == 31) wb[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const int t = wb[lane];
      int s = t;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += y;
      }
      wb[lane] = s - t;
      if (lane == 31) wb[kCompact / 32] = s;
    }
    __syncthreads();
    int pos = base + wb[warp] + inc - cnt;
    while (m != 0u && pos < n_top) {
      out_rows[pos++] = static_cast<double>(r + __ffs(m) - 1);
      m &= m - 1u;
    }
    base += wb[kCompact / 32];
    buf ^= 1;
  }
  const int taken = min(base, n_top);
  for (int k = taken + threadIdx.x; k < n_top; k += blockDim.x)
    out_rows[k] = -1.0;
  if (threadIdx.x == 0) *out_n = static_cast<double>(taken);
}

}  // namespace

// The launchers, one a stage; inputs as kernels/post.py's stage wrappers
// say. Each returns cudaGetLastError() after its launches.

// Stage 1, lanes start .. start + count - 1 of the C-lane inputs, in
// clusters of lane_blocks(A) blocks; out_sa (count A 3), out_hits (count A),
// out_counts (count) f64.
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
  const int G = lane_blocks(A);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(count * G);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, post_lanes, rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo,
      x0, N, hi_cloud, A, lo_cloud, B, hit_thresh * hit_thresh, start,
      out_sa, out_hits, out_counts);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 on all C lanes: counts (C) f64 from stage 1; scratch rmat
// (C (S + C)) f64 and lane_of (C + 1) int32, the last the blocks' ticket;
// out_acc, out_slot (C) f64.
MAD_EXPORT int mad_post_dedup(const float* coords,
                              const unsigned char* failed,
                              const double* counts, int C, int N,
                              const double* prev, int S,
                              const long long* idx, int n, double dedup,
                              double* rmat, int* lane_of, double* out_acc,
                              double* out_slot, cudaStream_t stream) {
  const cudaError_t err =
      cudaMemsetAsync(lane_of + C, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (S + C + kWarps - 1) / kWarps;
  post_dedup_k<<<C * groups, kThreads, 0, stream>>>(
      coords, prev, S, C, N, idx, n, groups, rmat, failed, counts, dedup,
      lane_of, out_acc, out_slot);
  return static_cast<int>(cudaGetLastError());
}

// Stages 1 and 2 on all C lanes in one launch (one device): inputs as the
// two above; scratch rmat (C (S + C)) f64, lane_of (C) int32 and tk (C + 1)
// 64-bit tickets (the lanes', then the launch's); outputs as the two.
MAD_EXPORT int mad_post_lanes_dedup(
    const float* rot_m, const float* trans_m, const float* coords,
    const unsigned char* failed, const double* cand_rot,
    const double* cand_hi, const double* cand_lo, int C, const double* x0,
    int N, const double* hi_cloud, int A, const double* lo_cloud, int B,
    double hit_thresh, const double* prev, int S, const long long* idx,
    int n, double dedup, double* rmat, int* lane_of, unsigned long long* tk,
    double* out_sa, double* out_hits, double* out_counts, double* out_acc,
    double* out_slot, cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(
      tk, 0, sizeof(unsigned long long) * (C + 1), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lane_grid = C * lane_blocks(A);
  const int groups = (S + C + kWarps - 1) / kWarps;
  post_lanes_dedup<<<lane_grid + C * groups, kThreads, 0, stream>>>(
      rot_m, trans_m, coords, failed, cand_rot, cand_hi, cand_lo, C, x0, N,
      hi_cloud, A, lo_cloud, B, hit_thresh * hit_thresh, lane_grid, prev, S,
      idx, n, groups, dedup, rmat, lane_of, tk, out_sa, out_hits, out_counts,
      out_acc, out_slot);
  return static_cast<int>(cudaGetLastError());
}

// Stage 3, cloud points start .. start + count - 1; acc (C) f64 from
// stage 2; scratch part (chunks count + 1) f64, the last the blocks'
// ticket, the (S + C) N atoms cut into `chunks` runs; elig_pt (count)
// uint8.
MAD_EXPORT int mad_post_points(const double* lo_cloud, int start, int count,
                               const double* prev, int S,
                               const float* coords, const double* acc,
                               int C, int N, double anchor_dist, int chunks,
                               double* part, unsigned char* elig_pt,
                               cudaStream_t stream) {
  if (chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemsetAsync(
      part + static_cast<long long>(chunks) * count, 0, sizeof(double),
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(S + C) * N;
  const long long per = (total + chunks - 1) / chunks;
  const dim3 grid((count + kPointTile - 1) / kPointTile, chunks);
  post_elig_points<<<grid, kThreads, 0, stream>>>(
      lo_cloud, start, count, prev, S, coords, acc, C, N, per,
      anchor_dist * anchor_dist, part, elig_pt);
  return static_cast<int>(cudaGetLastError());
}

// Stage 4, table rows start .. start + count - 1; elig_pt (B) of every
// cloud point from stage 3; row_flag (count) uint8.
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

// Stage 5 on all P rows' flags (P may be 0; row_flag 16-byte aligned):
// out (1 + n_top) f64, the number of rows taken, then the rows (-1 past
// them).
MAD_EXPORT int mad_post_compact(const unsigned char* row_flag, int P,
                                int n_top, double* out, cudaStream_t stream) {
  post_compact<<<1, kCompact, 0, stream>>>(row_flag, P, n_top, out, out + 1);
  return static_cast<int>(cudaGetLastError());
}
