// K10's head: the thresholded per-row and global top of the descriptor
// cosines.
//
// Replaces the selection of mad_tpu/engine/match.py:74-91
// (_compiled_similarity: lax.top_k per row, then over the flat row heads,
// then `> threshold`); the (dh, dl) product before it stays torch.matmul.
// Every cosine v > threshold at (row, col) gets the key
//   (~orderable(bits(v))) << 32 | (row * dl + col),
// where orderable() is the standard float-to-ordered-uint map (sign bit
// set: all bits flipped; else the sign bit set), so ascending keys are
// (value descending, row ascending, col ascending): the order of the two
// top_k calls, and keys are unique. Output: the smallest L keys, ascending,
// L = min(max_pairs, dh * min(row_cap, dl)), padded with ~0.
//
// On a mesh (mad_tpu's match_pairs with the subunit rows sharded), each
// shard runs mad_pair_head on its block of rows with the block's first
// global row (row0), so its keys carry the global row, and a head of
// min(max_pairs, rows * k) keys; mad_pair_merge keeps the smallest L of the
// shards' heads concatenated: the single-device head, since a key among
// the L smallest overall is among the L smallest of its own shard.
//
// 1. row_heads, one block a row. Its cosines are read with 16-byte loads,
//    kBatch in flight a thread: once to count each thread's survivors (and
//    their keys' AND and OR), then, their slots found by one block scan,
//    again (from L1 / L2) to put the keys in shared memory. Where there
//    are more than k = min(row_cap, dl), a radix select over the 64-bit
//    keys finds the k-th: its first digit is the kFirstBits bits below the
//    highest bit where the survivors differ, later digits 8 bits; a pass
//    counts into shared bins, a block scan finds the bin of the k-th, and
//    a bin taken whole ends the select, as does one of at most kFinish
//    keys, whose keys are ranked among themselves. Equal cosines are
//    ordered by their column through the key's low half, as top_k takes
//    them. The <= k keys taken (slots again by a block scan) are sorted
//    into a run of kp = pow2(k) slots, ~0 after them: each by its rank
//    among them up to kRankMax keys, else bitonically in shared memory
//    (in device memory above kSelCap). A row with more survivors than
//    kRowCap reads its cosines again for each pass. Each row adds its
//    run's least and greatest key and its count to the plan's words by
//    atomics.
// 2. select_runs, a block a bucket of about equal count: every block
//    counts the same sample of the runs' slots in kFine bins of equal
//    width over the keys' range and takes the bins between its share's
//    quantiles of the sample. Each run's keys in the bucket are a
//    contiguous range (two binary searches a run), their count below it
//    is the bucket's place in the output, and they are gathered, sorted
//    in shared memory (by rank, or bitonically above kRankMax keys) and
//    written. A bucket with more than kBucketCap keys is taken in pieces
//    (its range halved until a piece fits). The mesh's merge sorts the
//    shards' heads in tiles of kTile (tile_sort, which adds to the plan as
//    the row stage does), then runs the same stage over the tiles.
//
// The rank finish and the sorts by rank are the faster of two exact
// forms (scripts/torch_match_probe.py --variants paths, H100 80GB HBM3
// at 700 W): without the finish, one more 8-bit pass, the bench's head
// takes 0.010 ms more; with bitonic sorts only, its merge 0.0013 ms and
// the (24, 16411) tied cosines 0.005 ms more.
//
// Bound: bytes, the (dh, dl) cosines read once (6.7 MB at the bench:
// 366 x 4,588) and L keys written: 2.1 us. At the bench's shapes neither
// stage moves or computes much: both are chains of dependent steps,
// each a round to L2 or a barrier of a few hundred ns (the row stage's
// two reads, radix pass and sort; the global stage's sample, its scan,
// the runs' binary searches and the bucket's sort), and each launch and
// the plan's memset take about 2 us (scripts/torch_match_probe.py splits
// them).
#include <stdint.h>

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kBatch = 4;           // 16-byte loads a thread issues at once
constexpr int kRowCap = 8192;       // survivors a row keeps in shared memory
constexpr int kSelCap = 4096;       // keys a row sorts in shared memory
constexpr int kFirstBits = 11;      // the row select's first digit, at most
constexpr int kBins = 2048;
constexpr int kFinish = 64;         // a bin this small is ranked, not split
constexpr int kRankMax = 256;       // keys sorted by rank; bitonic above
constexpr int kSelThreads = 512;
constexpr int kBucketCap = 4096;    // keys a bucket sorts in shared memory
constexpr int kBucketKeys = 128;    // slots a bucket, at most, on average
constexpr int kMaxBuckets = 4096;
constexpr int kFineBits = 10;
constexpr int kFine = 1024;         // bins of the buckets' sample
constexpr int kSamples = 1024;      // its sample of the slots, about
constexpr int kTile = 4096;         // tile_sort's runs (the mesh merge)
constexpr int kTileThreads = 1024;
// plan: ~least key, greatest key and keys of the runs (atomics of the
// runs' writers)
constexpr int kPlan = 3;
constexpr u64 kNone = ~0ull;
static_assert(kBins == 1 << kFirstBits, "kBins is 2^kFirstBits");
static_assert(kFine == 1 << kFineBits, "kFine is 2^kFineBits");
static_assert(kBins % kRowThreads == 0 && kFinish <= kRowThreads &&
              kRankMax <= kRowThreads, "a row's threads cover its bins");

__device__ __forceinline__ unsigned value_key(float v) {
  const unsigned b = __float_as_uint(v);
  return ~((b & 0x80000000u) ? ~b : (b | 0x80000000u));
}

__device__ __forceinline__ u64 pair_key(unsigned vk, unsigned idx) {
  return (static_cast<u64>(vk) << 32) | idx;
}

__host__ __device__ __forceinline__ long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
__device__ __forceinline__ T warp_reduce(T x, int op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T y = __shfl_xor_sync(0xffffffffu, x, off);
    x = op == 0 ? (x & y) : op == 1 ? (x | y) : x + y;
  }
  return x;
}

// Exclusive scan of x over the block (blockDim a multiple of 32); *total
// gets the sum. red holds 32 values; two barriers, the first frees red.
template <typename T>
__device__ __forceinline__ T block_scan(T x, T* red, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  T before = 0, all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    before += w < warp ? red[w] : 0;
    all += red[w];
  }
  *total = all;
  return before + incl - x;
}

// f(key) on the row's survivors, in rounds that every thread of the block
// takes alike: first the columns before the row's first 16-byte boundary
// and after its last (at most six, one a thread), then four columns a
// thread from each 16-byte load, kBatch loads at once. A thread sees the
// same columns in the same order on every call.
template <typename F>
__device__ __forceinline__ void visit_row(const float* __restrict__ v,
                                          int dl, float thr, unsigned base,
                                          F f) {
  const int head = min(dl, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(v) & 15)) & 15) >> 2));
  const int body = (dl - head) >> 2;
  const int tail = head + 4 * body;
  {
    const int j = threadIdx.x;
    const int c = j < head ? j : tail + j - head;
    if (j < head + dl - tail && v[c] > thr)
      f(pair_key(value_key(v[c]), base + c));
  }
  const float4* v4 = reinterpret_cast<const float4*>(v + head);
  const float nan = __int_as_float(0x7fc00000);   // > thr never holds
  for (int i0 = 0; i0 < body; i0 += kBatch * blockDim.x) {
    float4 q[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x + threadIdx.x;
      q[b] = i < body ? v4[i] : make_float4(nan, nan, nan, nan);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const unsigned c = base + head
                         + 4 * (i0 + b * blockDim.x + threadIdx.x);
      if (q[b].x > thr) f(pair_key(value_key(q[b].x), c));
      if (q[b].y > thr) f(pair_key(value_key(q[b].y), c + 1));
      if (q[b].z > thr) f(pair_key(value_key(q[b].z), c + 2));
      if (q[b].w > thr) f(pair_key(value_key(q[b].w), c + 3));
    }
  }
}

// Each of the first s threads (s <= blockDim.x) takes key i of keys[0, s)
// and writes it to dst[rank] when rank < limit, rank its place in
// ascending order (equal keys by index): a sort with no barrier.
__device__ __forceinline__ void rank_scatter(const u64* keys, int s,
                                             u64* dst, long long limit) {
  const int i = threadIdx.x;
  if (i >= s) return;
  const u64 x = keys[i];
  int r = 0;
#pragma unroll 8
  for (int j = 0; j < s; ++j) {
    const u64 y = keys[j];
    r += y < x || (y == x && j < i);
  }
  if (r < limit) dst[r] = x;
}

// A sorted run's part in the plan (s keys): its least and greatest key
// and its count.
__device__ __forceinline__ void add_run(u64* plan, const u64* run,
                                        long long s) {
  if (s == 0) return;
  atomicMax(&plan[0], ~run[0]);
  atomicMax(&plan[1], run[s - 1]);
  atomicAdd(&plan[2], static_cast<u64>(s));
}

// Block b's bucket [*cur, *end) of B over [least, hi], hi the greatest
// key. Every block counts the same sample, every step-th slot of
// keys[0, N) (the ~0 padding falls outside), in kFine bins of width 2^sh,
// and takes the bins from the one holding sample b S / B of the S to the
// one holding sample (b + 1) S / B, so the buckets hold about equal
// counts. fine holds kFine ints.
__device__ __forceinline__ void bucket_of(const u64* keys, long long N,
                                          const u64* plan, int* fine,
                                          long long* red, u64* cur,
                                          u64* end) {
  const int lane = threadIdx.x & 31, b = blockIdx.x, B = gridDim.x;
  const u64 lo = ~plan[0], hi = plan[1];
  const u64 span = hi - lo;
  const int sh = max(0, 64 - __clzll(span) - kFineBits);   // < kFine bins
  for (int i = threadIdx.x; i < kFine; i += blockDim.x) fine[i] = 0;
  __syncthreads();
  const long long step = N > kSamples ? N / kSamples : 1;
  const long long ns = (N + step - 1) / step;
  for (long long i0 = 0; i0 < ns; i0 += 4 * blockDim.x) {
    u64 x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long i = i0 + q * blockDim.x + threadIdx.x;
      x[q] = i < ns ? keys[i * step] : kNone;
    }
    // a warp's samples mostly come from one run, in order: each run of
    // lanes in one bin adds its length once
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = x[q] >= lo && x[q] <= hi;
      const int bin = ok ? static_cast<int>((x[q] - lo) >> sh) : -1;
      const int up = __shfl_up_sync(0xffffffffu, bin, 1);
      const bool first = !ok || lane == 0 || up != bin;
      const unsigned after = __ballot_sync(0xffffffffu, first)
                             & ~((2u << lane) - 1u);
      if (ok && first)
        atomicAdd(&fine[bin], (after ? __ffs(after) - 1 : 32) - lane);
    }
  }
  __syncthreads();
  // inclusive scan of the bins in place, per consecutive bins a thread
  const int per = kFine / blockDim.x;
  long long sum = 0;
  for (int q = 0; q < per; ++q) sum += fine[per * threadIdx.x + q];
  long long total;
  long long run = block_scan(sum, red, &total);
  for (int q = 0; q < per; ++q) {
    run += fine[per * threadIdx.x + q];
    fine[per * threadIdx.x + q] = static_cast<int>(run);
  }
  __syncthreads();
  auto bin_at = [&](int c) {               // bins whose count <= c S / B
    if (c == 0) return 0;
    if (c == B) return kFine;
    const long long t = total * c / B;
    int l = 0, h = kFine;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (fine[mid] <= t) l = mid + 1;
      else h = mid;
    }
    return l;
  };
  const int last = static_cast<int>(span >> sh);   // the last bin in use
  const int f0 = bin_at(b), f1 = bin_at(b + 1);
  *cur = f0 > last ? hi + 1 : lo + (static_cast<u64>(f0) << sh);
  *end = f1 > last ? hi + 1 : lo + (static_cast<u64>(f1) << sh);
  __syncthreads();                         // fine is free
}

// Dynamic shared memory: cap survivor slots, then the sort buffer of
// pow2(min(k, kSelCap)) keys.
__global__ void __launch_bounds__(kRowThreads)
row_heads(const float* __restrict__ sim, int dl, int k, int kp, float thr,
          int row0, int cap, u64* __restrict__ heads,
          int* __restrict__ counts, u64* __restrict__ plan) {
  extern __shared__ u64 smem[];
  u64* keys = smem;
  u64* sel = smem + cap;
  __shared__ int bins[kBins];
  __shared__ u64 ured[2][kRowWarps], fin[kFinish], s_t;
  __shared__ int red[32], s_bin, s_need, s_cnt, s_m;
  const int row = blockIdx.x, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  const float* v = sim + static_cast<long long>(row) * dl;
  u64* head = heads + static_cast<long long>(row) * kp;
  const unsigned base = static_cast<unsigned>(row0 + row)
                        * static_cast<unsigned>(dl);

  // 1. the survivors: counted (with their keys' AND and OR) in one read,
  // their slots by a block scan, their keys into shared memory in another
  int mine = 0;
  u64 all_and = kNone, all_or = 0;
  visit_row(v, dl, thr, base, [&](u64 key) {
    ++mine;
    all_and &= key;
    all_or |= key;
  });
  all_and = warp_reduce(all_and, 0);
  all_or = warp_reduce(all_or, 1);
  if (lane == 0) {
    ured[0][warp] = all_and;
    ured[1][warp] = all_or;
  }
  int n;
  int pos = block_scan(mine, red, &n);     // its barriers show ured
  all_and = kNone;
  all_or = 0;
  for (int w = 0; w < kRowWarps; ++w) {
    all_and &= ured[0][w];
    all_or |= ured[1][w];
  }
  const bool fits = n <= cap;
  if (fits) {
    visit_row(v, dl, thr, base, [&](u64 key) { keys[pos++] = key; });
    __syncthreads();
  }
  // f(key) on every survivor, from shared memory or the row
  auto each = [&](auto f) {
    if (fits) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) f(keys[i]);
    } else {
      visit_row(v, dl, thr, base, f);
    }
  };

  // 2. radix select of the k-th smallest key: taken = (key & mask) <=
  // prefix, every survivor when they fit in k
  u64 mask = 0, prefix = 0;
  if (n > k) {
    const u64 diff = all_and ^ all_or;         // nonzero: keys are unique
    const int top = 63 - __clzll(diff);
    int shift = max(top - (kFirstBits - 1), 0), width = top - shift + 1;
    mask = top == 63 ? 0 : (kNone << (top + 1));
    prefix = all_and & mask;
    int need = k;
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) bins[i] = 0;
    __syncthreads();
    for (;;) {
      const u64 digit = (1ull << width) - 1;
      each([&](u64 key) {
        if ((key & mask) == prefix)
          atomicAdd(&bins[(key >> shift) & digit], 1);
      });
      __syncthreads();
      // thread t reads (and clears) bins [8 t, 8 t + 8); a block scan
      // finds the bin of the need-th key
      constexpr int per = kBins / kRowThreads;
      int h[per], sum = 0;
#pragma unroll
      for (int q = 0; q < per; ++q) {
        h[q] = bins[per * threadIdx.x + q];
        bins[per * threadIdx.x + q] = 0;
        sum += h[q];
      }
      int total;
      int cum = block_scan(sum, red, &total);
      if (cum < need && need <= cum + sum) {
#pragma unroll
        for (int q = 0; q < per; ++q) {
          if (cum < need && need <= cum + h[q]) {
            s_bin = per * threadIdx.x + q;
            s_need = need - cum;
            s_cnt = h[q];
          }
          cum += h[q];
        }
      }
      __syncthreads();
      prefix |= static_cast<u64>(s_bin) << shift;
      mask |= digit << shift;
      need = s_need;
      const int cnt = s_cnt;
      if (cnt == need || shift == 0) break;
      if (cnt <= kFinish) {                // rank the bin's keys
        if (threadIdx.x == 0) s_m = 0;
        __syncthreads();
        each([&](u64 key) {
          if ((key & mask) == prefix) fin[atomicAdd(&s_m, 1)] = key;
        });
        __syncthreads();
        if (static_cast<int>(threadIdx.x) < cnt) {
          const u64 x = fin[threadIdx.x];
          int r = 0;
          for (int j = 0; j < cnt; ++j) r += fin[j] < x;
          if (r == need - 1) s_t = x;
        }
        __syncthreads();
        prefix = s_t;                      // taken: the keys <= the k-th
        mask = kNone;
        break;
      }
      width = min(8, shift);
      shift -= width;
    }
  }

  // 3. the taken keys (slots by a block scan), sorted ascending, into the
  // row's run of kp slots
  const int s = n < k ? n : k;
  const bool in_smem = s <= kSelCap;
  u64* dst = in_smem ? sel : head;
  int taken = 0;
  each([&](u64 key) { taken += (key & mask) <= prefix; });
  int tot;
  int at = block_scan(taken, red, &tot);
  each([&](u64 key) {
    if ((key & mask) <= prefix) dst[at++] = key;
  });
  for (int i = s + threadIdx.x; i < kp; i += blockDim.x) head[i] = kNone;
  if (s <= kRankMax) {
    __syncthreads();
    rank_scatter(sel, s, head, s);
  } else if (in_smem) {
    const int S = static_cast<int>(pow2_at_least(s));
    for (int i = s + threadIdx.x; i < S; i += blockDim.x) sel[i] = kNone;
    __syncthreads();
    mad_bitonic_sort(sel, S);
    __syncthreads();
    for (int i = threadIdx.x; i < s; i += blockDim.x) head[i] = sel[i];
  } else {                                 // sorted in place, in the run
    __syncthreads();
    mad_bitonic_sort(head, kp);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    counts[row] = s;
    add_run(plan, head, s);
  }
}

// Ascending sort of tiles of kTile keys in shared memory, in place, each
// tile's keys before the ~0 padding counted and added to the plan.
__global__ void __launch_bounds__(kTileThreads)
tile_sort(u64* __restrict__ keys, long long N, int* __restrict__ counts,
          u64* __restrict__ plan) {
  __shared__ u64 s[kTile];
  __shared__ int s_real;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  if (threadIdx.x == 0) s_real = 0;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x)
    s[i] = base + i < N ? keys[base + i] : kNone;
  __syncthreads();
  mad_bitonic_sort(s, kTile);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    if (base + i < N) keys[base + i] = s[i];
    if (s[i] != kNone && (i + 1 == kTile || s[i + 1] == kNone))
      s_real = i + 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = s_real;
    add_run(plan, s, s_real);
  }
}

// Positions of x and y in p[0, n) (lower bounds), both searches a step.
__device__ __forceinline__ void lower_bounds(const u64* p, long long n,
                                             u64 x, u64 y, long long& a,
                                             long long& e) {
  a = e = 0;
  for (long long step = pow2_at_least(n + 1) >> 1; step > 0; step >>= 1) {
    const u64 pa = a + step <= n ? p[a + step - 1] : kNone;
    const u64 pe = e + step <= n ? p[e + step - 1] : kNone;
    if (a + step <= n && pa < x) a += step;
    if (e + step <= n && pe < y) e += step;
  }
}

// Run r: keys[r * stride, ...), ascending, its counts[r] keys before the
// ~0 padding.
struct Runs {
  const u64* keys;
  long long N, stride;
  const int* counts;
};

__global__ void __launch_bounds__(kSelThreads)
select_runs(Runs runs, int R, long long L, const u64* __restrict__ plan,
            u64* __restrict__ out) {
  __shared__ u64 buf[kBucketCap];
  __shared__ long long src[kSelThreads], start[kSelThreads + 1], red[32];

  // ~0 after the real keys
  const long long total = static_cast<long long>(plan[2]);
  const long long real = total < L ? total : L;
  for (long long i = real + static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < L; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = kNone;

  if (total == 0) return;
  u64 cur, end;
  bucket_of(runs.keys, runs.N, plan, reinterpret_cast<int*>(buf), red, &cur,
            &end);
  while (cur < end) {
    u64 upto = end;
    long long off, c;
    for (;;) {                             // keys in [cur, upto) into buf
      long long below = 0;
      c = 0;
      for (int r0 = 0; r0 < R; r0 += blockDim.x) {
        const int r = r0 + threadIdx.x;
        long long a = 0, e = 0;
        if (r < R) {
          lower_bounds(runs.keys + r * runs.stride, runs.counts[r], cur,
                       upto, a, e);
          below += a;
        }
        long long chunk;
        const long long ex = block_scan(e - a, red, &chunk);
        start[threadIdx.x] = c + ex;
        src[threadIdx.x] = r < R ? r * runs.stride + a : 0;
        if (threadIdx.x == 0) start[blockDim.x] = c + chunk;
        __syncthreads();
        // the chunk's keys, the block together: key i from the run whose
        // start is the last at or below it
        const long long lim = min(c + chunk, static_cast<long long>(
                                                 kBucketCap));
        for (long long i = c + threadIdx.x; i < lim; i += blockDim.x) {
          int l = 0, h = blockDim.x;       // start[l] <= i < start[h]
          while (h - l > 1) {
            const int mid = (l + h) >> 1;
            if (start[mid] <= i) l = mid;
            else h = mid;
          }
          buf[i] = runs.keys[src[l] + (i - start[l])];
        }
        c += chunk;
      }
      block_scan(below, red, &off);
      if (off >= L) return;
      if (c <= kBucketCap || upto - cur == 1) break;
      upto = cur + (upto - cur) / 2;
    }
    if (c > kBucketCap) {                  // c copies of the one key cur
      for (long long i = threadIdx.x; i < c && off + i < L; i += blockDim.x)
        out[off + i] = cur;
    } else if (c <= kRankMax) {
      __syncthreads();
      rank_scatter(buf, static_cast<int>(c), out + off, L - off);
    } else {
      const int S = static_cast<int>(pow2_at_least(c));
      for (int i = static_cast<int>(c) + threadIdx.x; i < S;
           i += blockDim.x)
        buf[i] = kNone;
      __syncthreads();
      mad_bitonic_sort(buf, S);
      __syncthreads();
      for (long long i = threadIdx.x; i < c && off + i < L; i += blockDim.x)
        out[off + i] = buf[i];
    }
    __syncthreads();
    cur = upto;
  }
}

int buckets(long long slots) {
  const long long want = (slots + kBucketKeys - 1) / kBucketKeys;
  return static_cast<int>(want < 1 ? 1 : want > kMaxBuckets ? kMaxBuckets
                                                             : want);
}

}  // namespace

// sim (rows, dl) float32, rows row0 .. row0 + rows - 1 of a table of dl
// columns; scratch: heads (rows * pow2(k)) uint64, counts (rows) int and
// plan (kPlan) uint64; out (L). Two kernels.
MAD_EXPORT int mad_pair_head(const float* sim, int dh, int dl, int k,
                             float thr, int row0, long long L,
                             unsigned long long* heads, int* counts,
                             unsigned long long* plan,
                             unsigned long long* out, cudaStream_t stream) {
  if (dh == 0 || k == 0 || L == 0) return 0;
  const int kp = static_cast<int>(pow2_at_least(k));
  const int cap = dl < kRowCap ? dl : kRowCap;
  const size_t smem = (cap + pow2_at_least(k < kSelCap ? k : kSelCap))
                      * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      row_heads, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaMemsetAsync(plan, 0, kPlan * sizeof(u64), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_heads<<<dh, kRowThreads, smem, stream>>>(sim, dl, k, kp, thr, row0,
                                               cap, heads, counts, plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long N = static_cast<long long>(dh) * kp;
  select_runs<<<buckets(N), kSelThreads, 0, stream>>>(
      Runs{heads, N, kp, counts}, dh, L, plan, out);
  return static_cast<int>(cudaGetLastError());
}

// The global top of a mesh run: the smallest L <= N of the N keys of the
// shards' heads (keys is scratch, sorted in place by tiles; counts
// (N / kTile rounded up) int and plan as above). Two kernels.
MAD_EXPORT int mad_pair_merge(unsigned long long* keys, long long N,
                              long long L, int* counts,
                              unsigned long long* plan,
                              unsigned long long* out, cudaStream_t stream) {
  if (N == 0 || L == 0) return 0;
  const int R = static_cast<int>((N + kTile - 1) / kTile);
  cudaError_t err = cudaMemsetAsync(plan, 0, kPlan * sizeof(u64), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sort<<<R, kTileThreads, 0, stream>>>(keys, N, counts, plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_runs<<<buckets(N), kSelThreads, 0, stream>>>(
      Runs{keys, N, kTile, counts}, R, L, plan, out);
  return static_cast<int>(cudaGetLastError());
}
