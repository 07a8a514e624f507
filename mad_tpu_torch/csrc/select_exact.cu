// K21: the exact re-score's selection: the top n_use pairs by approximate
// repeatability, in order, and the gathers of their K13 inputs.
//
// Replaces mad_tpu/engine/match.py:224-248 (_compiled_select_exact;
// its padding rows and identity fill are bucket padding, left behind):
// top = argsort(-rep, stable)[:n_use] and rot[top], hi[top], lo[top].
// Every row i of the P gets a unique key
//   key = ordered(rep[i]) << ib | (P - 1 - i),   ib = bits of P - 1,
// where ordered() is the float-to-ordered-uint map with every NaN mapped
// to 0 (below -inf's key, as both argsorts put NaN last) and -0.0 taken
// as +0.0 (both argsorts tie them and keep the index order). Descending
// keys are the stable descending order, so any exact selection of the
// n_use largest keys gives the same rows in the same order.
//
// 1. select_keys, one cluster of kCluster CTAs, each over its chunk of
//    the rows: a radix select from the keys' top digit, 8 bits a pass.
//    The first pass reads the repeatabilities and keeps the chunk's order
//    bits in shared memory (up to kStageCap rows a CTA; the bench's 5,856
//    all), where the later passes read them. A pass counts the keys that
//    share the boundary's prefix into the CTA's shared bins (a thread's
//    run of keys in one bin by one atomic: the keys at the boundary share
//    a value, and so their digits, until the index's digits); after one
//    cluster barrier every CTA sums the cluster's bins through
//    distributed shared memory (double-buffered, so one barrier a pass)
//    and one warp finds the bin of the n_use-th key, the same in every
//    CTA. It ends at a bin taken whole (at the latest at the last digit,
//    the keys being unique). A last read puts the keys at or above the
//    boundary into the scratch `sel` (n_use keys, in no order; a warp's
//    slots by one global atomic).
// 2. rank_gather, kRankKeys selected keys a block: a key's rank is the
//    number of selected keys above it (kRankParts threads a key, the
//    selected keys staged in shared tiles); it writes top[rank] and the
//    row's rotation and coordinates at rank. At n_use = P this is P^2
//    compares (2.2e9 at the bench's 46,848 pairs); the bench asks for
//    1,024.
//
// With its select on one block K21 takes 0.098 ms, on the cluster 0.034
// (H100 80GB HBM3, 700 W; scripts/torch_match_probe.py --variants
// select): six passes and a compaction over 46,848 keys are issue-bound
// on one SM.
//
// Bound: bytes, rep read once and the n_use rows gathered and written
// (the bench: 0.19 MB read, 0.07 MB written, ~0.1 us at 3.35 TB/s). At
// such sizes both launches are latency-bound: a chain of dependent passes
// and cluster barriers, then one short launch.
#include <stdint.h>

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kCluster = 8;          // CTAs of the select's cluster
constexpr int kSelectThreads = 1024;
constexpr int kBatch = 4;            // rows a thread loads at once
constexpr int kStageCap = 48 * 1024; // rows a CTA keeps in shared memory
constexpr int kRankThreads = 256;
constexpr int kRankKeys = 64;        // selected keys a rank block places
constexpr int kRankParts = kRankThreads / kRankKeys;
constexpr int kRankTile = 2048;      // selected keys a rank block stages

// The repeatability's order bits: unsigned order as the floats' with
// -0.0 as +0.0 and every NaN 0, below -inf's.
__device__ __forceinline__ unsigned order_bits(float v) {
  unsigned u = __float_as_uint(v);
  if (v == 0.0f) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return isnan(v) ? 0u : u;
}

// The bits of key above bit s (0 where s >= 64).
__device__ __forceinline__ u64 above(u64 key, int s) {
  return s >= 64 ? 0ull : key >> s;
}

// The CTA's rows j = r0 + e * kSelectThreads + threadIdx.x (e < kBatch)
// of its n rows from row0: their keys, 0 past n. The first `staged`
// rows' order bits come from the stage unless `fresh`, else from rep
// (and are kept in the stage when fresh).
__device__ __forceinline__ void load_batch(
    const float* __restrict__ rep, unsigned* stage, int P, int ib, int row0,
    int n, int staged, bool fresh, int r0, u64 (&key)[kBatch]) {
  unsigned u[kBatch];
#pragma unroll
  for (int e = 0; e < kBatch; ++e) {
    const int j = r0 + e * kSelectThreads + threadIdx.x;
    u[e] = j >= n ? 0u
           : (!fresh && j < staged) ? stage[j]
                                    : order_bits(__ldg(rep + row0 + j));
  }
#pragma unroll
  for (int e = 0; e < kBatch; ++e) {
    const int j = r0 + e * kSelectThreads + threadIdx.x;
    if (fresh && j < staged) stage[j] = u[e];
    key[e] = j >= n ? 0ull
             : (static_cast<u64>(u[e]) << ib)
               | static_cast<u64>(P - 1 - row0 - j);
  }
}

__global__ void __launch_bounds__(kSelectThreads)
select_keys(const float* __restrict__ rep, int P, int ib, int n_use,
            int chunk, int staged, u64* __restrict__ sel,
            unsigned* __restrict__ slot) {
  extern __shared__ unsigned stage[];        // the first `staged` rows
  __shared__ unsigned hist[2][256];          // this CTA's counts
  __shared__ unsigned tot[256];              // the cluster's counts
  __shared__ u64 prefix;       // the boundary's bits above the digit
  __shared__ int need;         // keys still to take below the prefix
  __shared__ int cut;          // the shift at which the select ended
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = static_cast<int>(cluster.block_rank()) * chunk;
  const int n = max(0, min(chunk, P - row0));
  if (tid == 0) {
    prefix = 0ull;
    need = n_use;
    cut = -1;
    if (row0 == 0) *slot = 0u;
  }
  const int bits = 32 + ib;
  const int s0 = ((bits + 7) / 8) * 8 - 8;
  for (int s = s0, p = 0; s >= 0; s -= 8, ++p) {
    // hist[p & 1] was last read by the cluster two passes ago, before
    // this CTA passed the previous pass's cluster barrier
    unsigned* h = hist[p & 1];
    if (tid < 256) h[tid] = 0u;
    __syncthreads();
    if (cut >= 0) break;
    const u64 pre = prefix;
    // a thread's run of keys in one bin is added at once: the keys that
    // share the boundary's prefix mostly share their next digit too
    unsigned run_bin = 0u, run = 0u;
    for (int r0 = 0; r0 < n; r0 += kSelectThreads * kBatch) {
      u64 key[kBatch];
      load_batch(rep, stage, P, ib, row0, n, staged, s == s0, r0, key);
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int j = r0 + e * kSelectThreads + tid;
        if (j >= n || above(key[e], s + 8) != pre) continue;
        const unsigned bin = static_cast<unsigned>(key[e] >> s) & 255u;
        if (bin != run_bin && run) {
          atomicAdd(&h[run_bin], run);
          run = 0u;
        }
        run_bin = bin;
        ++run;
      }
    }
    if (run) atomicAdd(&h[run_bin], run);
    cluster.sync();
    if (tid < 256) {
      unsigned t = 0u;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) t += cluster.map_shared_rank(h, r)[tid];
      tot[tid] = t;
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 255 - 8l down to 248 - 8l: counts from the top
      unsigned c[8], sum = 0u;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = tot[255 - 8 * lane - e];
        sum += c[e];
      }
      unsigned incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      const unsigned k = static_cast<unsigned>(need);
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= k);
      const int owner = __ffs(hit) - 1;
      if (lane == owner) {
        unsigned before = incl - sum;
        int e = 0;
        while (before + c[e] < k) before += c[e++];
        const unsigned bin = 255u - 8u * lane - e;
        prefix = (pre << 8) | bin;
        need = static_cast<int>(k - before);
        if (c[e] == k - before) cut = s;
      }
    }
  }
  // no CTA reads another's counts after this barrier, and the boundary is
  // known in every CTA
  cluster.sync();
  const int s_cut = cut;
  const u64 bound = prefix;
  for (int r0 = 0; r0 < n; r0 += kSelectThreads * kBatch) {
    u64 key[kBatch];
    load_batch(rep, stage, P, ib, row0, n, staged, false, r0, key);
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int j = r0 + e * kSelectThreads + tid;
      const bool take = j < n && (key[e] >> s_cut) >= bound;
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (mask == 0u) continue;
      const int leader = __ffs(mask) - 1;
      unsigned base = 0u;
      if (lane == leader)
        base = atomicAdd(slot, static_cast<unsigned>(__popc(mask)));
      base = __shfl_sync(0xffffffffu, base, leader)
             + __popc(mask & ((1u << lane) - 1u));
      if (take && base < static_cast<unsigned>(n_use)) sel[base] = key[e];
    }
  }
}

// A block places kRankKeys selected keys, each counted against the
// selected keys by kRankParts threads (every kRankParts-th key of each
// staged tile).
__global__ void __launch_bounds__(kRankThreads)
rank_gather(const u64* __restrict__ sel, int n_use, int P, int ib,
            const float* __restrict__ rot, const float* __restrict__ hi,
            const float* __restrict__ lo, long long* __restrict__ top,
            float* __restrict__ rot_out, float* __restrict__ hi_out,
            float* __restrict__ lo_out) {
  __shared__ u64 tile[kRankTile];
  __shared__ int part[kRankParts][kRankKeys];
  const int k = threadIdx.x % kRankKeys, q = threadIdx.x / kRankKeys;
  const int j = blockIdx.x * kRankKeys + k;
  const u64 mine = j < n_use ? sel[j] : 0ull;
  int rank = 0;
  for (int t0 = 0; t0 < n_use; t0 += kRankTile) {
    const int n = n_use - t0 < kRankTile ? n_use - t0 : kRankTile;
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kRankThreads) tile[t] = sel[t0 + t];
    __syncthreads();
    for (int t = q; t < n; t += kRankParts) rank += tile[t] > mine;
  }
  part[q][k] = rank;
  __syncthreads();
  if (q != 0 || j >= n_use) return;
#pragma unroll
  for (int r = 1; r < kRankParts; ++r) rank += part[r][k];
  const u64 mask = ib >= 64 ? ~0ull : (1ull << ib) - 1ull;
  const int i = P - 1 - static_cast<int>(mine & mask);
  top[rank] = i;
#pragma unroll
  for (int e = 0; e < 9; ++e) rot_out[rank * 9 + e] = rot[i * 9LL + e];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    hi_out[rank * 3 + e] = hi[i * 3LL + e];
    lo_out[rank * 3 + e] = lo[i * 3LL + e];
  }
}

}  // namespace

// rep (P,) float32; rot (P, 3, 3), hi and lo (P, 3) float32; sel: scratch
// of n_use + 1 64-bit words; outputs top (n_use,) int64, rot_out (n_use,
// 3, 3), hi_out and lo_out (n_use, 3), written whole.
// 0 < n_use <= P < 2^31.
MAD_EXPORT int mad_select_exact(const float* rep, int P, int n_use,
                                const float* rot, const float* hi,
                                const float* lo, unsigned long long* sel,
                                long long* top, float* rot_out,
                                float* hi_out, float* lo_out,
                                cudaStream_t stream) {
  if (n_use <= 0 || n_use > P) return cudaErrorInvalidValue;
  int ib = 0;
  while (ib < 31 && (1ll << ib) < P) ++ib;      // bits of P - 1
  const int chunk = (P + kCluster - 1) / kCluster;
  const int staged = chunk < kStageCap ? chunk : kStageCap;
  const size_t smem = static_cast<size_t>(staged) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      select_keys, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kSelectThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, select_keys, rep, P, ib, n_use, chunk,
                           staged, sel,
                           reinterpret_cast<unsigned*>(sel + n_use));
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_gather<<<(n_use + kRankKeys - 1) / kRankKeys, kRankThreads, 0,
                stream>>>(sel, n_use, P, ib, rot, hi, lo, top, rot_out,
                          hi_out, lo_out);
  return static_cast<int>(cudaGetLastError());
}
