// K21: the exact re-score's selection: the top n_use pairs by approximate
// repeatability, in order, and the gathers of their K13 inputs.
//
// Replaces mad_tpu/engine/match.py:224-248 (_compiled_select_exact;
// its padding rows and identity fill are bucket padding, left behind):
// top = argsort(-rep, stable)[:n_use] and rot[top], hi[top], lo[top].
// Every row i of the P gets a unique key
//   key = ~ordered(rep[i]) << ib | i,   ib = bits of P - 1,
// where ordered() is the float-to-ordered-uint map with every NaN mapped
// to 0 (below -inf's, as both argsorts put NaN last) and -0.0 taken as
// +0.0 (both argsorts tie them and keep the index order). Ascending keys
// are the stable descending order, so any exact selection of the n_use
// smallest keys gives the same rows in the same order.
//
// One launch (select_head), where n_use <= kOneHead and P <= kCluster *
// kChunk (the bench: 46,848 rows, n_use 1,024): one cluster of kCluster
// CTAs, CTA c over rows [c chunk, (c + 1) chunk), chunk = ceil(P /
// kCluster).
// 1. Each CTA writes its chunk's keys into shared memory and selects
//    their n_use smallest by a radix select (block_select: each pass's
//    11-bit digit right below the highest bit where the keys still in play
//    differ, so that tied repeatabilities cost no pass; a rank finish at
//    kFinish keys; four barriers a pass), then compacts them (a warp's
//    slots by one shared atomic) straight into the first CTA's shared
//    memory through distributed shared memory, after the heads of the
//    CTAs before it. Barriers of the CTA only.
// 2. After one cluster barrier the first CTA holds the heads (at most
//    kCluster n_use keys). It selects their n_use smallest the same way
//    and sorts them (each warp's 32 keys by a bitonic network of
//    shuffles, then runs merged in pairs by binary searches, one barrier
//    a round).
// 3. After a second cluster barrier every CTA reads its eighth of the
//    sorted rows from the first CTA and writes top and the rows'
//    rotations and coordinates, a thread an element.
// Otherwise three launches (two at n_use = P, where there is nothing to
// select), each over any P < 2^31:
// 1. select_keys, one cluster of kCluster CTAs, each over its chunk: a
//    radix select from the keys' top digit, 8 bits a pass, each pass's
//    counts summed over the cluster through distributed shared memory
//    (one cluster barrier a pass; six at 2^16 rows). The first pass keeps
//    the chunk's order bits in shared memory (up to kStageCap rows a
//    CTA), where the later passes read them. A last read puts the n_use
//    selected keys into the scratch `sel`, in no order.
// 2. tile_sort, a CTA a tile of kSortTile keys of sel (at n_use = P the
//    keys of the tile's rows): a bitonic sort in shared memory, written
//    back to sel.
// 3. rank_gather, a thread a key: its rank is its place in its tile plus
//    the keys below it in every other tile (binary searches), n_use (n_use
//    / kSortTile) log2(kSortTile) reads in all (n_use = 46,848: 6.2e6, in
//    place of the n_use^2 = 2.2e9 compares of a rank over all keys); it
//    writes top and the row's rotation and coordinates at its rank.
//
// Bound: bytes, rep read once and the n_use rows gathered and written
// (the bench: 0.19 MB read, 0.07 MB written, ~0.1 us at 3.35 TB/s). At
// such sizes the one launch is latency-bound, a chain of barriers: on the
// bench it takes 0.0277 ms (the radix select on one cluster with a rank
// launch before it: 0.0337), by %globaltimer in the first CTA (us) load
// 1.6, select 6.2, compact into the first CTA 2.5, cluster barrier 0.8,
// the heads' AND and OR 0.5, second select 5.3, compact 1.9, sort 4.0,
// barrier and gather 2.4; the three launches take 0.0707 there and 0.0720
// at n_use = P (0.4700 before: a rank by n_use^2 compares)
// (scripts/torch_match_probe.py --variants select; H100 80GB HBM3, 700 W).
#include <stdint.h>

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kCluster = 8;          // CTAs of a cluster (both paths)
constexpr int kThreads = 1024;       // threads of a CTA but rank_gather's
constexpr int kOneHead = 2048;       // n_use the one launch takes, at most
constexpr int kChunk = 8192;         // rows a CTA of the one launch takes
                                     // (a chunk, kCluster heads of kOneHead
                                     // and a head: 208 KB of shared memory)
constexpr int kDigitBits = 11;       // block_select's digits, at most
constexpr int kBins = 2048;
constexpr int kFinish = 64;          // a bin this small is ranked, not split
constexpr int kBatch = 4;            // rows a select_keys thread loads at once
constexpr int kStageCap = 48 * 1024; // rows a select_keys CTA keeps
constexpr int kSortTile = 4096;      // keys a tile_sort CTA sorts
constexpr int kRankThreads = 256;
constexpr u64 kNone = ~0ull;
static_assert(kBins == 1 << kDigitBits && kBins % kThreads == 0,
              "kBins is 2^kDigitBits, a whole number of bins a thread");
static_assert(kOneHead <= 4 * kThreads, "the sort holds four keys a thread");

// The repeatability's order bits: unsigned order as the floats' with
// -0.0 as +0.0 and every NaN 0, below -inf's.
__device__ __forceinline__ unsigned order_bits(float v) {
  unsigned u = __float_as_uint(v);
  if (v == 0.0f) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return isnan(v) ? 0u : u;
}

// Row i's key from its order bits u: the largest repeatability first.
__device__ __forceinline__ u64 make_key(unsigned u, int i, int ib) {
  return (static_cast<u64>(~u) << ib) | static_cast<u64>(i);
}

__device__ __forceinline__ int key_row(u64 key, int ib) {
  return static_cast<int>(key & ((1ull << ib) - 1ull));
}

// The bits of key above bit s (0 where s >= 64).
__device__ __forceinline__ u64 above(u64 key, int s) {
  return s >= 64 ? 0ull : key >> s;
}

// -- the one launch ------------------------------------------------------

// The AND and OR of the CTA's per-thread a and o: each warp's by shuffles
// into part, one barrier, then every warp reduces the warps' itself.
__device__ __forceinline__ void cta_and_or(u64& a, u64& o, u64 (*part)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a &= __shfl_xor_sync(0xffffffffu, a, off);
    o |= __shfl_xor_sync(0xffffffffu, o, off);
  }
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = o;
  }
  __syncthreads();
  a = lane < kThreads / 32 ? part[0][lane] : kNone;
  o = lane < kThreads / 32 ? part[1][lane] : 0ull;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a &= __shfl_xor_sync(0xffffffffu, a, off);
    o |= __shfl_xor_sync(0xffffffffu, o, off);
  }
}

// A select's shared state.
struct SelectState {
  int bins[kBins];            // zero between passes
  u64 part[2][32];            // the warps' AND and OR
  u64 fin[kFinish];           // the keys of the finishing bin
  u64 t;
  int red[32];
  int nfin, bin, need, cnt;
};

// Radix select by the CTA over the n unique keys of keys[0, n), more than
// need: on return the need smallest are those with (key & mask) <=
// prefix. a and o are the thread's AND and OR over its share of the keys
// (the first pass's, taken as they were written). A pass takes the live
// keys' AND and OR (live: (key & mask) == prefix), so its digit, kDigitBits
// wide (every pass scans all kBins bins, so a narrower one saves nothing),
// sits right below the highest bit where they differ and splits them.
// Four barriers a pass: the AND and OR, the counts, the scan's warp sums,
// the boundary bin; each thread zeroes the bins it scanned. st.bins must
// be zero on entry, and is on return.
__device__ void block_select(const u64* keys, int n, int need, u64 a, u64 o,
                             SelectState& st, u64& mask_out,
                             u64& prefix_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int per = kBins / kThreads;
  u64 mask = 0, prefix = 0;
  for (bool first = true;; first = false) {
    if (!first) {
      a = kNone;
      o = 0;
      for (int i = tid; i < n; i += kThreads) {
        const u64 x = keys[i];
        if ((x & mask) == prefix) {
          a &= x;
          o |= x;
        }
      }
    }
    cta_and_or(a, o, st.part);
    // more live keys than need: at least two, unique, so they differ
    const int top = 63 - __clzll(a ^ o);
    const int width = min(kDigitBits, top + 1);
    const int shift = top + 1 - width;
    const u64 digit = (1ull << width) - 1;
    mask = top == 63 ? 0 : (kNone << (top + 1));
    prefix = a & mask;
    for (int i = tid; i < n; i += kThreads) {
      const u64 x = keys[i];
      if ((x & mask) == prefix) atomicAdd(&st.bins[(x >> shift) & digit], 1);
    }
    __syncthreads();
    // thread t reads (and zeroes) bins [per t, per t + per); a CTA scan
    // finds the bin of the need-th key
    int hv[per], sum = 0;
#pragma unroll
    for (int q = 0; q < per; ++q) {
      hv[q] = st.bins[per * tid + q];
      st.bins[per * tid + q] = 0;
      sum += hv[q];
    }
    int cum = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, cum, off);
      if (lane >= off) cum += t;
    }
    if (lane == 31) st.red[warp] = cum;
    __syncthreads();
    int before = lane < warp ? st.red[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      before += __shfl_xor_sync(0xffffffffu, before, off);
    cum += before - sum;
    if (cum < need && need <= cum + sum) {
#pragma unroll
      for (int q = 0; q < per; ++q) {
        if (cum < need && need <= cum + hv[q]) {
          st.bin = per * tid + q;
          st.need = need - cum;
          st.cnt = hv[q];
        }
        cum += hv[q];
      }
    }
    __syncthreads();
    prefix |= static_cast<u64>(st.bin) << shift;
    mask |= digit << shift;
    need = st.need;
    const int cnt = st.cnt;
    if (cnt == need || shift == 0) break;
    if (cnt <= kFinish) {                  // rank the bin's keys
      if (tid == 0) st.nfin = 0;
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) {
        const u64 x = keys[i];
        if ((x & mask) == prefix) st.fin[atomicAdd(&st.nfin, 1)] = x;
      }
      __syncthreads();
      if (tid < cnt) {
        const u64 x = st.fin[tid];
        int rank = 0;
        for (int j = 0; j < cnt; ++j) rank += st.fin[j] < x;
        if (rank == need - 1) st.t = x;
      }
      __syncthreads();
      prefix = st.t;                       // taken: the keys <= the need-th
      mask = kNone;
      break;
    }
  }
  mask_out = mask;
  prefix_out = prefix;
}

// The keys of keys[0, n) with (key & mask) <= prefix appended at
// dst[*count]: a warp counts its keys, takes its slots by one shared
// atomic, then writes them in its order; ends with a barrier.
__device__ void compact(const u64* keys, int n, u64 mask, u64 prefix,
                        u64* dst, int* count) {
  const int lane = threadIdx.x & 31;
  int mine = 0;
  for (int i = threadIdx.x - lane; i < n; i += kThreads) {
    const int j = i + lane;
    mine += __popc(__ballot_sync(
        0xffffffffu, j < n && (keys[j] & mask) <= prefix));
  }
  int base = 0;
  if (lane == 0 && mine) base = atomicAdd(count, mine);
  base = __shfl_sync(0xffffffffu, base, 0);
  for (int i = threadIdx.x - lane; i < n; i += kThreads) {
    const int j = i + lane;
    const u64 x = j < n ? keys[j] : kNone;
    const bool take = j < n && (x & mask) <= prefix;
    const unsigned b = __ballot_sync(0xffffffffu, take);
    if (take) dst[base + __popc(b & ((1u << lane) - 1u))] = x;
    base += __popc(b);
  }
  __syncthreads();
}

// The n_use keys of head sorted ascending, their rows in order into rows
// (which may be head's room: every key is read before the first barrier).
// T = kThreads E places, those past n_use holding distinct keys above
// every real one (~0 less the place). Each warp sorts its 32 places by a
// bitonic network of shuffles; then runs of s = 32, 64, ..., T / 2 places
// merge in pairs, a key's new place its place in its run plus the keys
// below it in the other run (a binary search), through buf's two halves
// in turn: one barrier a round.
template <int E>
__device__ void sort_rows(const u64* head, int n_use, int ib, u64* buf,
                          int* rows) {
  constexpr int T = kThreads * E;
  const int tid = threadIdx.x, lane = tid & 31;
  u64 x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = tid + e * kThreads;
    x[e] = p < n_use ? head[p] : kNone - p;
  }
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const u64 y = __shfl_xor_sync(0xffffffffu, x[e], j);
        const bool low = ((lane & j) == 0) == ((lane & k) == 0);
        x[e] = low ? min(x[e], y) : max(x[e], y);
      }
    }
  }
  u64* src = buf;
#pragma unroll
  for (int e = 0; e < E; ++e) src[tid + e * kThreads] = x[e];
  __syncthreads();
  for (int s = 32; s < T; s <<= 1) {
    u64* dst = src == buf ? buf + T : buf;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = tid + e * kThreads, run = p / s;
      // the other run's keys below x[e]: a search of uniform steps
      const u64* other = src + (run ^ 1) * s;
      int below = 0;
      for (int step = s; step > 0; step >>= 1)
        if (below + step <= s && other[below + step - 1] < x[e]) below += step;
      dst[(run & ~1) * s + (p & (s - 1)) + below] = x[e];
    }
    __syncthreads();
    src = dst;
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = src[tid + e * kThreads];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = tid + e * kThreads;
    if (p < n_use) rows[p] = key_row(x[e], ib);
  }
}

// Barrier of the cluster in halves: arrive (releasing this thread's
// writes), then wait (acquiring the others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Shared memory of the one launch: `cap` keys (the chunk, then the
// sort's two buffers), `gcap` keys (in the first CTA, the heads), n_use
// keys (the first CTA's head, then the rows in order).
__global__ void __launch_bounds__(kThreads)
select_head(const float* __restrict__ rep, int P, int ib, int n_use,
            int chunk, int cap, int gcap, const float* __restrict__ rot,
            const float* __restrict__ hi, const float* __restrict__ lo,
            long long* __restrict__ top, float* __restrict__ rot_out,
            float* __restrict__ hi_out, float* __restrict__ lo_out) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ SelectState st;
  __shared__ int s_n;
  u64* keys = smem;
  u64* heads = smem + cap;
  u64* head = heads + gcap;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = rank * chunk;
  const int n = max(0, min(chunk, P - row0));
  if (tid == 0) s_n = 0;
  for (int i = tid; i < kBins; i += kThreads) st.bins[i] = 0;
  u64 a = kNone, o = 0;                    // the first pass's AND and OR
  for (int j = tid; j < n; j += kThreads) {
    const u64 x = make_key(order_bits(__ldg(rep + row0 + j)), row0 + j, ib);
    keys[j] = x;
    a &= x;
    o |= x;
  }
  __syncthreads();
  u64 mask = 0, prefix = kNone;            // every key
  if (n > n_use) block_select(keys, n, n_use, a, o, st, mask, prefix);
  // the head goes straight into the first CTA's heads, after the heads of
  // the CTAs before this one
  int at = 0, m = 0;
  for (int c = 0; c < kCluster; ++c) {
    const int h = min(n_use, max(0, min(chunk, P - c * chunk)));
    at += c < rank ? h : 0;
    m += h;
  }
  compact(keys, n, mask, prefix, cluster.map_shared_rank(heads, 0) + at,
          &s_n);
  if (tid == 0) s_n = 0;
  // every head is in the first CTA, which selects and sorts theirs while
  // the others wait
  cluster.sync();
  int* rows = reinterpret_cast<int*>(head);
  if (rank == 0) {
    a = kNone;
    o = 0;
    for (int i = tid; i < m; i += kThreads) {
      a &= heads[i];
      o |= heads[i];
    }
    mask = 0;
    prefix = kNone;
    if (m > n_use) block_select(heads, m, n_use, a, o, st, mask, prefix);
    compact(heads, m, mask, prefix, head, &s_n);
    // sort: the rows in order into the head's room
    if (n_use <= kThreads) sort_rows<1>(head, n_use, ib, keys, rows);
    else if (n_use <= 2 * kThreads) sort_rows<2>(head, n_use, ib, keys, rows);
    else sort_rows<4>(head, n_use, ib, keys, rows);
  }
  // every CTA gathers its share of the rows, read from the first CTA's
  // rows (which stay until every CTA has arrived at the last barrier)
  cluster.sync();
  const int q = (n_use + kCluster - 1) / kCluster;
  const int r0 = min(n_use, rank * q), nr = min(n_use, r0 + q) - r0;
  int* mine = reinterpret_cast<int*>(keys);
  const int* first = cluster.map_shared_rank(rows, 0);
  for (int r = tid; r < nr; r += kThreads) mine[r] = first[r0 + r];
  __syncthreads();
  cluster_arrive();
  for (int r = tid; r < nr; r += kThreads) top[r0 + r] = mine[r];
  for (int f = tid; f < 9 * nr; f += kThreads)
    rot_out[r0 * 9LL + f] = __ldg(rot + mine[f / 9] * 9LL + f % 9);
  for (int f = tid; f < 3 * nr; f += kThreads) {
    const long long src = mine[f / 3] * 3LL + f % 3;
    hi_out[r0 * 3LL + f] = __ldg(hi + src);
    lo_out[r0 * 3LL + f] = __ldg(lo + src);
  }
  cluster_wait();
}

// -- three launches ------------------------------------------------------

// The CTA's rows j = r0 + e * kThreads + threadIdx.x (e < kBatch) of its n
// rows from row0: their keys, ~0 past n. The first `staged` rows' order
// bits come from the stage unless `fresh`, else from rep (and are kept in
// the stage when fresh).
__device__ __forceinline__ void load_batch(
    const float* __restrict__ rep, unsigned* stage, int ib, int row0, int n,
    int staged, bool fresh, int r0, u64 (&key)[kBatch]) {
  unsigned u[kBatch];
#pragma unroll
  for (int e = 0; e < kBatch; ++e) {
    const int j = r0 + e * kThreads + threadIdx.x;
    u[e] = j >= n ? 0u
           : (!fresh && j < staged) ? stage[j]
                                    : order_bits(__ldg(rep + row0 + j));
  }
#pragma unroll
  for (int e = 0; e < kBatch; ++e) {
    const int j = r0 + e * kThreads + threadIdx.x;
    if (fresh && j < staged) stage[j] = u[e];
    key[e] = j >= n ? kNone : make_key(u[e], row0 + j, ib);
  }
}

__global__ void __launch_bounds__(kThreads)
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
    for (int r0 = 0; r0 < n; r0 += kThreads * kBatch) {
      u64 key[kBatch];
      load_batch(rep, stage, ib, row0, n, staged, s == s0, r0, key);
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int j = r0 + e * kThreads + tid;
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
      for (int r = 0; r < kCluster; ++r)
        t += cluster.map_shared_rank(h, r)[tid];
      tot[tid] = t;
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 8l to 8l + 7: counts from the bottom
      unsigned c[8], sum = 0u;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = tot[8 * lane + e];
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
        prefix = (pre << 8) | static_cast<unsigned>(8 * lane + e);
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
  for (int r0 = 0; r0 < n; r0 += kThreads * kBatch) {
    u64 key[kBatch];
    load_batch(rep, stage, ib, row0, n, staged, false, r0, key);
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int j = r0 + e * kThreads + tid;
      const bool take = j < n && (key[e] >> s_cut) <= bound;
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

// Tile blockIdx.x of the n keys of sel (from_rep: of rows [0, n)) sorted
// ascending in shared memory and written back to sel.
__global__ void __launch_bounds__(kThreads)
tile_sort(const float* __restrict__ rep, int ib, int n, int from_rep,
          u64* __restrict__ sel) {
  __shared__ u64 keys[kSortTile];
  const int base = blockIdx.x * kSortTile;
  const int m = min(kSortTile, n - base);
  for (int t = threadIdx.x; t < kSortTile; t += kThreads) {
    u64 x = kNone;
    if (t < m)
      x = from_rep ? make_key(order_bits(__ldg(rep + base + t)), base + t, ib)
                   : sel[base + t];
    keys[t] = x;
  }
  __syncthreads();
  mad_bitonic_sort(keys, kSortTile);
  for (int t = threadIdx.x; t < m; t += kThreads) sel[base + t] = keys[t];
}

// A thread a key of the n sorted keys of sel (tiles of kSortTile): its
// rank, then top and the row's rotation and coordinates at the rank.
__global__ void __launch_bounds__(kRankThreads)
rank_gather(const u64* __restrict__ sel, int n, int ib,
            const float* __restrict__ rot, const float* __restrict__ hi,
            const float* __restrict__ lo, long long* __restrict__ top,
            float* __restrict__ rot_out, float* __restrict__ hi_out,
            float* __restrict__ lo_out) {
  const int j = blockIdx.x * kRankThreads + threadIdx.x;
  if (j >= n) return;
  const u64 x = sel[j];
  const int own = j / kSortTile;
  int rank = j - own * kSortTile;
  for (int t = 0; t * kSortTile < n; ++t) {
    if (t == own) continue;
    // the keys of tile t below x: a lower bound by halving
    const u64* s = sel + static_cast<long long>(t) * kSortTile;
    int at = 0, len = min(kSortTile, n - t * kSortTile);
    while (len > 0) {
      const int half = len >> 1;
      if (s[at + half] < x) {
        at += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    rank += at;
  }
  const int i = key_row(x, ib);
  top[rank] = i;
#pragma unroll
  for (int e = 0; e < 9; ++e) rot_out[rank * 9LL + e] = rot[i * 9LL + e];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    hi_out[rank * 3LL + e] = hi[i * 3LL + e];
    lo_out[rank * 3LL + e] = lo[i * 3LL + e];
  }
}

// Set on every launch: a value set for another call persists.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// rep (P,) float32; rot (P, 3, 3), hi and lo (P, 3) float32; outputs top
// (n_use,) int64, rot_out (n_use, 3, 3), hi_out and lo_out (n_use, 3),
// written whole. sel null: the one launch (n_use <= kOneHead, P <=
// kCluster * kChunk); else the three launches, sel scratch of n_use + 1
// 64-bit words. 0 < n_use <= P < 2^31.
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
  cudaError_t err;
  if (sel == nullptr) {
    if (n_use > kOneHead || chunk > kChunk) return cudaErrorInvalidValue;
    // the chunk or the sort's two buffers of kThreads E places, the
    // heads, the head
    int places = kThreads;
    while (places < n_use) places <<= 1;
    const int cap = max(chunk, 2 * places);
    const int gcap = min(P, kCluster * n_use);
    const size_t smem =
        static_cast<size_t>(cap + gcap + n_use) * sizeof(u64);
    err = launch_cluster(select_head, smem, stream, rep, P, ib, n_use, chunk,
                         cap, gcap, rot, hi, lo, top, rot_out, hi_out,
                         lo_out);
    return static_cast<int>(err);
  }
  const bool all = n_use == P;
  if (!all) {
    const int staged = chunk < kStageCap ? chunk : kStageCap;
    err = launch_cluster(select_keys,
                         static_cast<size_t>(staged) * sizeof(unsigned),
                         stream, rep, P, ib, n_use, chunk, staged, sel,
                         reinterpret_cast<unsigned*>(sel + n_use));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_sort<<<(n_use + kSortTile - 1) / kSortTile, kThreads, 0, stream>>>(
      rep, ib, n_use, all ? 1 : 0, sel);
  rank_gather<<<(n_use + kRankThreads - 1) / kRankThreads, kRankThreads, 0,
                stream>>>(sel, n_use, ib, rot, hi, lo, top, rot_out, hi_out,
                          lo_out);
  return static_cast<int>(cudaGetLastError());
}
