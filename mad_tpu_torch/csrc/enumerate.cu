// K19 / K20: the heads of the assembly enumerations.
//
// K19 replaces mad_tpu/engine/assemble.py:336-402 (_compiled_enumerate_head):
// rank r in [0, C(n, k)) decodes greedily, in lexicographic order, from the
// binomial table tab[x, i] = C(n-1-x, k-1-i) into a uint64 membership mask
// (n <= 64), and the tuple's score is the masked max of sym over the
// tuple's rows and columns (torch's amax of sym * m_a * m_b: NaN, so 0
// after the clamp below, where a non-finite entry lies outside them or a
// NaN inside). K20 replaces :498-548 (_compiled_hetero_head): rank r in
// [0, prod(sizes)) decodes in mixed radix, index g = (r / stride_g) %
// size_g, maps through the padded (G, max_n) group lists, and the score is
// the f32 sum of sym over the pairs i0 < i1 in itertools.combinations
// order, added one by one.
//
// sym[i][j] = ov[i][j] + ov[j][i] (one IEEE float32 add) for i, j < t, of
// K18's (n_ov, n_ov) upper-triangular overlap on the card: mad_tpu's
// _compiled_embed_sym (:316-333) folded into the heads' staging. K19 and
// K20 (up to kSymBytes of it: 128 solutions) stage it in shared memory;
// K20 above that forms it at each read from device memory.
//
// Keys: each score packs with its rank into one uint64 key, (float bits of
// max(score, 0)) << 32 | rank, so that the order of the keys is the order
// (score, rank), the tie order of the JAX bodies' running lax.top_k merge.
// Keys are unique, so any exact selection of the `head` smallest, sorted,
// gives the same bits.
//
// 1. score_filter (combo_head / product_head), `blocks` blocks of kThreads,
//    block b over the rank tiles b, b + blocks, ... of kTile ranks: each
//    thread scores kPer ranks of a tile and keeps a key only below the
//    threshold tau, the smaller of the block's own and the global word
//    *thr (re-read every tile, a tile ahead). Kept keys go into the
//    block's shared buffer of head + kRoom keys (a warp's slots by ballot
//    and one shared atomic). Before a tile that might not fit, the block
//    selects the head-th smallest of its buffer by a radix select (K10's
//    rule, csrc/pairs.cu, applied at every pass: the digit sits right
//    below the highest bit where the keys still in play differ,
//    kFirstBits wide first, then 8; a rank finish at kFinish keys), keeps
//    the keys at or below it, makes it its own tau and publishes it with
//    atomicMin on *thr. At the end it selects once more if it holds more
//    than head keys and writes them, in no order, with their count (one
//    block: sorted, into out, and no second launch).
// 2. final_head, one CTA, or a cluster of up to kCluster CTAs above
//    kOneCta kept keys: the blocks' kept keys at or below the final *thr
//    go into shared memory, a CTA's share of the blocks each; each CTA
//    selects the head of its share (the same radix select), the heads
//    gather in the first CTA through distributed shared memory, which
//    selects the head of theirs, sorts it (by rank up to kRankMax keys,
//    bitonically above) and writes it.
//
// Invariant: a block's tau and the word *thr are each the head-th smallest
// of head real keys, so each is at least the global head-th smallest key.
// A key above either is not in the head, whatever order the blocks run
// in; a key of the head passes every filter, stays among its block's head
// smallest, and lies at or below the final *thr. So the final launch sees
// every key of the head, and at least min(head, total) keys.
//
// Bound: operations. K19 decodes a rank in n table compares and takes k
// (k - 1) / 2 shared-memory maxima; K20 decodes its G members (a
// multiply-shift division and a list read each, once a rank up to
// kRegGroups groups, at each use above) and adds G (G - 1) / 2 pairs.
// Neither reads more than a few KB nor writes more than blocks x head
// keys, and no (total,) key vector exists. The selects are chains of
// barriers: a few a select, a few selects a block, then the final head's
// two selects and two cluster barriers. At 16^5 tuples (head 256) K20
// takes 0.050 ms: its first launch ~29 us (the scorer ~15, block 0's two
// selects ~7), the final head ~17 (reads 4, local select 3, gather and
// second select 6, sort 3); counts aggregated a warp at a time by
// __match_any_sync were slower (scripts/torch_enum_probe.py --variants
// split,clock; H100 80GB HBM3, 700 W).
#include <stdint.h>

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;       // score_filter's threads a block
constexpr int kPer = 2;             // ranks a thread scores a tile
constexpr int kTile = kThreads * kPer;
constexpr int kRoom = 4 * kTile;    // fresh keys a block holds beside its head
constexpr int kFinalThreads = 1024;
constexpr int kCluster = 8;         // CTAs of the final head, at most
constexpr int kOneCta = 4096;       // kept keys (blocks x head) one CTA takes
constexpr int kFinalKeys = 8192;    // a final CTA's share, and the gathered
                                    // heads, at most
constexpr int kMaxHead = 4096;
constexpr int kFirstBits = 11;      // the selects' first digit, at most
constexpr int kBins = 2048;
constexpr int kFinish = 64;         // a bin this small is ranked, not split
constexpr int kRankMax = 256;       // keys sorted by rank; bitonic above
constexpr int kSymBytes = 64 * 1024;   // K20's sym in shared memory up to
constexpr int kListBytes = 32 * 1024;  // K20's lists in shared memory up to
constexpr u64 kNone = ~0ull;
static_assert(kBins == 1 << kFirstBits, "kBins is 2^kFirstBits");
static_assert(kRoom >= kTile && kFinish <= kThreads,
              "a tile fits the room; a block ranks its finishing bin");

__device__ __forceinline__ u64 pack_key(float v, unsigned r) {
  const unsigned bits = v > 0.0f ? __float_as_uint(v) : 0u;
  return (static_cast<u64>(bits) << 32) | r;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Exclusive scan of x over the block (blockDim a multiple of 32); *total
// gets the sum. red holds 32 values; two barriers, the first frees red.
__device__ __forceinline__ int block_scan(int x, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    before += w < warp ? red[w] : 0;
    all += red[w];
  }
  *total = all;
  return before + incl - x;
}

// A select's shared state.
struct SelectState {
  int bins[kBins];
  u64 part[2][32];            // the warps' AND and OR
  u64 ao[2];                  // the block's
  u64 fin[kFinish];           // the keys of the finishing bin
  u64 t, tmax;
  int red[32];
  int nfin, bin, need, cnt, n;
};

// Radix select by a block of kT threads over the n unique keys of
// keys[0, n), more than need: on return the need smallest are those with
// (key & mask) <= prefix. A pass takes the live keys' AND and OR (live:
// (key & mask) == prefix), so its digit sits right below the highest bit
// where they differ (kFirstBits wide first, then 8) and splits them.
template <int kT>
__device__ void block_select(const u64* keys, int n, int need,
                             SelectState& st, u64& mask_out,
                             u64& prefix_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int per = kBins / kT;
  u64 mask = 0, prefix = 0;
  for (;;) {
    for (int i = tid; i < kBins; i += kT) st.bins[i] = 0;
    u64 a = kNone, o = 0;
    for (int i = tid; i < n; i += kT) {
      const u64 x = keys[i];
      if ((x & mask) == prefix) {
        a &= x;
        o |= x;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a &= __shfl_xor_sync(0xffffffffu, a, off);
      o |= __shfl_xor_sync(0xffffffffu, o, off);
    }
    if (lane == 0) {
      st.part[0][warp] = a;
      st.part[1][warp] = o;
    }
    __syncthreads();
    if (tid == 0) {
      u64 wa = kNone, wo = 0;
      for (int w = 0; w < kT / 32; ++w) {
        wa &= st.part[0][w];
        wo |= st.part[1][w];
      }
      st.ao[0] = wa;
      st.ao[1] = wo;
    }
    __syncthreads();
    a = st.ao[0];
    // more live keys than need: at least two, unique, so they differ
    const int top = 63 - __clzll(a ^ st.ao[1]);
    const int width = min(mask == 0 ? kFirstBits : 8, top + 1);
    const int shift = top + 1 - width;
    const u64 digit = (1ull << width) - 1;
    mask = top == 63 ? 0 : (kNone << (top + 1));
    prefix = a & mask;
    for (int i = tid; i < n; i += kT) {
      const u64 x = keys[i];
      if ((x & mask) == prefix) atomicAdd(&st.bins[(x >> shift) & digit], 1);
    }
    __syncthreads();
    // thread t reads bins [per t, per t + per); a block scan finds the bin
    // of the need-th key
    int hv[per], sum = 0;
#pragma unroll
    for (int q = 0; q < per; ++q) {
      hv[q] = st.bins[per * tid + q];
      sum += hv[q];
    }
    int total;
    int cum = block_scan(sum, st.red, &total);
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
      for (int i = tid; i < n; i += kT) {
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
// dst[*count] (a warp's slots by ballot and one atomic), their largest
// into *tmax where given.
template <int kT>
__device__ void compact(const u64* keys, int n, u64 mask, u64 prefix,
                        u64* dst, int* count, u64* tmax) {
  const int lane = threadIdx.x & 31;
  u64 most = 0;
  for (int i0 = 0; i0 < n; i0 += kT) {
    const int i = i0 + threadIdx.x;
    const u64 x = i < n ? keys[i] : kNone;
    const bool take = i < n && (x & mask) <= prefix;
    const unsigned b = __ballot_sync(0xffffffffu, take);
    if (b == 0u) continue;
    const int leader = __ffs(b) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count, __popc(b));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (take) {
      dst[base + __popc(b & ((1u << lane) - 1u))] = x;
      most = max(most, x);
    }
  }
  if (tmax != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      most = max(most, __shfl_xor_sync(0xffffffffu, most, off));
    if (lane == 0) atomicMax(tmax, most);
  }
}

// keys[0, s) sorted ascending into out[0, s): by rank (P threads a key)
// up to kRankMax keys, else bitonically in place (keys holds pow2(s)).
template <int kT>
__device__ void sort_out(u64* keys, int s, u64* __restrict__ out) {
  const int tid = threadIdx.x;
  if (s <= 0) return;
  if (s <= kRankMax) {
    int P = 1;
    while (P < 32 && 2 * P * s <= kT) P <<= 1;
    const int i = tid / P, q = tid % P;
    const u64 x = i < s ? keys[i] : 0;
    int rank = 0;
    if (i < s)
      for (int j = q; j < s; j += P) rank += keys[j] < x;
    for (int off = P >> 1; off > 0; off >>= 1)
      rank += __shfl_xor_sync(0xffffffffu, rank, off);
    if (i < s && q == 0) out[rank] = x;
  } else {
    const int S = pow2_at_least(s);
    for (int i = s + tid; i < S; i += kT) keys[i] = kNone;
    __syncthreads();
    mad_bitonic_sort(keys, S);
    for (int i = tid; i < s; i += kT) out[i] = keys[i];
  }
}

// Step 1 for one block: buf holds head + kRoom keys, tmp pow2(head); thr
// is null with one block.
template <class Source>
__device__ void score_filter(const Source& src, long long total, int head,
                             u64* buf, u64* tmp, SelectState& st,
                             u64* thr, u64* __restrict__ kept,
                             int* __restrict__ counts,
                             u64* __restrict__ out) {
  __shared__ int s_n;
  __shared__ u64 s_own, s_tau;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    s_n = 0;
    s_own = kNone;
  }
  // the head smallest of buf[0, s_n) kept in buf[0, head); their largest
  // becomes the block's tau and is published
  auto reduce = [&]() {
    const int n = s_n;
    if (tid == 0) {
      st.n = 0;
      st.tmax = 0;
    }
    u64 mask, prefix;
    block_select<kThreads>(buf, n, head, st, mask, prefix);
    compact<kThreads>(buf, n, mask, prefix, tmp, &st.n, &st.tmax);
    __syncthreads();
    for (int i = tid; i < head; i += kThreads) buf[i] = tmp[i];
    if (tid == 0) {
      s_n = head;
      s_own = st.tmax;
      if (thr != nullptr) atomicMin(thr, st.tmax);
    }
    __syncthreads();
  };
  // thread 0 reads the global word a tile ahead of its use, so the read's
  // latency hides behind the tile's scoring (an older word is larger,
  // still a bound)
  u64 word = kNone;
  const long long step = static_cast<long long>(gridDim.x) * kTile;
  for (long long base = static_cast<long long>(blockIdx.x) * kTile;
       base < total; base += step) {
    __syncthreads();                       // the last tile's slots taken
    if (s_n + kTile > head + kRoom) reduce();
    if (tid == 0) s_tau = min(s_own, word);
    __syncthreads();
    const u64 tau = s_tau;
    if (tid == 0 && thr != nullptr)
      word = *reinterpret_cast<volatile u64*>(thr);
    u64 key[kPer];
    unsigned b[kPer];
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const long long r = base + e * kThreads + tid;
      key[e] = r < total ? src(static_cast<unsigned>(r)) : kNone;
      b[e] = __ballot_sync(0xffffffffu, r < total && key[e] < tau);
      cnt += __popc(b[e]);
    }
    if (cnt == 0) continue;
    int slot = 0;
    if (lane == 0) slot = atomicAdd(&s_n, cnt);
    slot = __shfl_sync(0xffffffffu, slot, 0);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if ((b[e] >> lane) & 1u)
        buf[slot + __popc(b[e] & ((1u << lane) - 1u))] = key[e];
      slot += __popc(b[e]);
    }
  }
  __syncthreads();
  if (s_n > head) reduce();
  __syncthreads();
  const int n = s_n;
  if (gridDim.x == 1) {
    sort_out<kThreads>(buf, n, out);
    return;
  }
  u64* mine = kept + static_cast<long long>(blockIdx.x) * head;
  for (int i = tid; i < n; i += kThreads) mine[i] = buf[i];
  if (tid == 0) counts[blockIdx.x] = n;
}

struct ComboSource {
  const float* sym;      // (n, n), shared memory; diagonal folded when nf 0
  const int* tab;        // (n, k), shared memory
  int n, k, nf;          // nf: non-finite entries of sym
  __device__ u64 operator()(unsigned r) const {
    unsigned rem = r;
    int slot = 0;
    u64 mask = 0;
    for (int x = 0; x < n && slot < k; ++x) {
      const unsigned c = static_cast<unsigned>(tab[x * k + slot]);
      if (rem < c) {
        mask |= 1ull << x;
        ++slot;
      } else {
        rem -= c;
      }
    }
    float best = 0.0f;
    if (nf == 0) {
      // every off-diagonal entry holds the max of itself and its two
      // diagonal entries, so the tuple's pairs cover its diagonal too
      if (k == 1) {
        const int a = __ffsll(static_cast<long long>(mask)) - 1;
        best = fmaxf(best, sym[a * n + a]);
      }
      u64 ma = mask;
      while (ma) {
        const int a = __ffsll(static_cast<long long>(ma)) - 1;
        ma &= ma - 1;
        u64 mb = ma;
        while (mb) {
          const int b = __ffsll(static_cast<long long>(mb)) - 1;
          mb &= mb - 1;
          best = fmaxf(best, sym[a * n + b]);
        }
      }
    } else {
      // torch's amax of sym * m_a * m_b: NaN (so 0) unless every
      // non-finite entry lies in the tuple's rows and columns, none NaN
      int inside = 0;
      bool nan = false;
      for (u64 ma = mask; ma; ma &= ma - 1) {
        const int a = __ffsll(static_cast<long long>(ma)) - 1;
        for (u64 mb = mask; mb; mb &= mb - 1) {
          const int b = __ffsll(static_cast<long long>(mb)) - 1;
          const float v = sym[a * n + b];
          nan |= isnan(v);
          inside += !isfinite(v);
          best = fmaxf(best, v);
        }
      }
      if (nan || inside < nf) best = 0.0f;
    }
    return pack_key(best, r);
  }
};

// sym of the overlap ov (stride n_ov) at (i, j), as the staging forms it
__device__ __forceinline__ float sym_of(const float* ov, int n_ov, int i,
                                        int j) {
  return add_rn(ov[static_cast<long long>(i) * n_ov + j],
                ov[static_cast<long long>(j) * n_ov + i]);
}

// One group's mixed radix: its size, and r / stride as (m * r) >> s with
// m = ceil(2^s / stride), s = 31 + ceil(log2 stride), exact for r < 2^31
// (Granlund and Montgomery); the wrapper computes them.
struct Radix {
  int size;
  unsigned m;
  int s;
};

constexpr int kRegGroups = 8;   // groups whose members stay in registers

struct ProductSource {
  const float* sym;      // (nsol, nsol) staged in shared memory, or null
  const float* ov;       // the overlap (stride n_ov) read when sym is null
  const int* lists;      // (G, max_n), shared or device memory
  const Radix* radix;    // (G), shared memory
  int n_ov, nsol, max_n, G;
  __device__ unsigned quot(unsigned r, int g) const {
    return static_cast<unsigned>((static_cast<u64>(r) * radix[g].m)
                                 >> radix[g].s);
  }
  // group g's member from q = r / stride_g and up = r / stride_{g-1}:
  // its digit is q - size_g up
  __device__ int member(int g, unsigned q, unsigned up) const {
    return lists[g * max_n + static_cast<int>(q - up * radix[g].size)];
  }
  __device__ float pair(int a, int b) const {
    return sym != nullptr ? sym[a * nsol + b] : sym_of(ov, n_ov, a, b);
  }
  __device__ u64 operator()(unsigned r) const {
    float s = 0.0f;
    if (G <= kRegGroups) {               // members decoded once, in order
      int m[kRegGroups];
      unsigned up = 0;
#pragma unroll
      for (int g = 0; g < kRegGroups; ++g) {
        if (g < G) {
          const unsigned q = quot(r, g);
          m[g] = member(g, q, up);
          up = q;
        }
      }
#pragma unroll
      for (int i0 = 0; i0 < kRegGroups; ++i0) {
#pragma unroll
        for (int i1 = i0 + 1; i1 < kRegGroups; ++i1)
          if (i1 < G) s = add_rn(s, pair(m[i0], m[i1]));
      }
    } else {                             // any G: members decoded at use
      for (int i0 = 0; i0 < G; ++i0) {
        const int a = member(i0, quot(r, i0), i0 > 0 ? quot(r, i0 - 1) : 0u);
        for (int i1 = i0 + 1; i1 < G; ++i1)
          s = add_rn(s, pair(a, member(i1, quot(r, i1), quot(r, i1 - 1))));
      }
    }
    return pack_key(s, r);
  }
};

// The first launch's shared memory: buf (head + kRoom keys) and tmp
// (pow2(head) keys), then the source's staging.
__host__ __device__ __forceinline__ size_t filter_bytes(int head) {
  return static_cast<size_t>(head + kRoom + pow2_at_least(head)) * 8;
}

__global__ void __launch_bounds__(kThreads)
combo_head(const float* __restrict__ ov, int n_ov,
           const int* __restrict__ tab, int n, int k, long long total,
           int head, u64* thr, u64* __restrict__ kept,
           int* __restrict__ counts, u64* __restrict__ out) {
  extern __shared__ u64 smem[];
  __shared__ SelectState st;
  __shared__ int s_nf;
  u64* buf = smem;
  u64* tmp = buf + head + kRoom;
  float* s_sym = reinterpret_cast<float*>(tmp + pow2_at_least(head));
  int* s_tab = reinterpret_cast<int*>(s_sym + n * n);
  if (threadIdx.x == 0) s_nf = 0;
  __syncthreads();
  int nf = 0;
  for (int i = threadIdx.x; i < n * n; i += kThreads) {
    const float v = sym_of(ov, n_ov, i / n, i % n);
    s_sym[i] = v;
    nf += !isfinite(v);
  }
  if (nf) atomicAdd(&s_nf, nf);
  for (int i = threadIdx.x; i < n * k; i += kThreads) s_tab[i] = tab[i];
  __syncthreads();
  nf = s_nf;
  if (nf == 0) {             // fold the diagonal into the pairs (finite)
    for (int i = threadIdx.x; i < n * n; i += kThreads) {
      const int a = i / n, b = i % n;
      if (a != b)
        s_sym[i] = fmaxf(s_sym[i], fmaxf(s_sym[a * n + a], s_sym[b * n + b]));
    }
    __syncthreads();
  }
  score_filter(ComboSource{s_sym, s_tab, n, k, nf}, total, head, buf, tmp,
               st, thr, kept, counts, out);
}

__global__ void __launch_bounds__(kThreads)
product_head(const float* __restrict__ ov, int n_ov, int nsol,
             const int* __restrict__ lists, int max_n,
             const Radix* __restrict__ radix, int G, long long total,
             int head, u64* thr, u64* __restrict__ kept,
             int* __restrict__ counts, u64* __restrict__ out) {
  extern __shared__ u64 smem[];
  __shared__ SelectState st;
  u64* buf = smem;
  u64* tmp = buf + head + kRoom;
  Radix* s_radix = reinterpret_cast<Radix*>(tmp + pow2_at_least(head));
  int* s_lists = reinterpret_cast<int*>(s_radix + G);
  const bool lists_smem = static_cast<long long>(G) * max_n * 4 <= kListBytes;
  float* s_sym = reinterpret_cast<float*>(s_lists + (lists_smem ? G * max_n
                                                                 : 0));
  const bool sym_smem = static_cast<long long>(nsol) * nsol * 4 <= kSymBytes;
  for (int i = threadIdx.x; i < G; i += kThreads) s_radix[i] = radix[i];
  if (lists_smem)
    for (int i = threadIdx.x; i < G * max_n; i += kThreads)
      s_lists[i] = lists[i];
  if (sym_smem)
    for (int i = threadIdx.x; i < nsol * nsol; i += kThreads)
      s_sym[i] = sym_of(ov, n_ov, i / nsol, i % nsol);
  __syncthreads();
  score_filter(ProductSource{sym_smem ? s_sym : nullptr, ov,
                             lists_smem ? s_lists : lists, s_radix, n_ov,
                             nsol, max_n, G},
               total, head, buf, tmp, st, thr, kept, counts, out);
}

// Step 2: the head smallest of the blocks' kept keys at or below *thr,
// sorted, into out, by one CTA or a cluster (kMulti): each CTA selects the
// head of its share of the blocks, the heads gather in the first CTA
// (through distributed shared memory), which selects theirs and sorts it.
// Shared memory: `cap` keys a CTA (its share, then the first CTA's second
// select's keys), then `gather` keys (the gathered heads).
template <bool kMulti>
__global__ void __launch_bounds__(kFinalThreads)
final_head(const u64* __restrict__ kept, const int* __restrict__ counts,
           int blocks, int head, int cap, const u64* __restrict__ thr,
           u64* __restrict__ out) {
  extern __shared__ u64 fsm[];
  __shared__ SelectState st;
  __shared__ int s_n, s_sel;
  u64* keys = fsm;
  u64* sel = fsm + cap;
  const int tid = threadIdx.x, lane = tid & 31;
  int rank = 0, C = 1;
  int* gathered = &s_sel;
  if constexpr (kMulti) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    C = static_cast<int>(cluster.num_blocks());
    sel = cluster.map_shared_rank(sel, 0);
    gathered = cluster.map_shared_rank(&s_sel, 0);
  }
  if (tid == 0) {
    s_n = 0;
    s_sel = 0;
  }
  // on a cluster, every CTA has started and set its counts before any
  // writes to the first
  if constexpr (kMulti) cg::this_cluster().sync();
  else __syncthreads();
  // the slots of this CTA's blocks rank, rank + C, ..., read at once
  const u64 g = *thr;
  const int slots = (blocks - rank + C - 1) / C * head;
  for (int i0 = 0; i0 < slots; i0 += kFinalThreads) {
    const int i = i0 + tid;
    const int b = rank + i / head * C, j = i % head;
    u64 x = kNone;
    if (i < slots && j < counts[b])
      x = kept[static_cast<long long>(b) * head + j];
    const bool take = x <= g && x != kNone;
    const unsigned m = __ballot_sync(0xffffffffu, take);
    if (m == 0u) continue;
    int slot = 0;
    if (lane == 0) slot = atomicAdd(&s_n, __popc(m));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (take) keys[slot + __popc(m & ((1u << lane) - 1u))] = x;
  }
  __syncthreads();
  int n = s_n;
  u64 mask = 0, prefix = kNone;            // every key
  if (n > head) block_select<kFinalThreads>(keys, n, head, st, mask, prefix);
  compact<kFinalThreads>(keys, n, mask, prefix, sel, gathered, nullptr);
  if constexpr (kMulti) {
    cg::this_cluster().sync();
    if (rank != 0) return;
    sel = fsm + cap;                       // the gathered heads, here
    n = s_sel;
    if (n > head) {                        // the head of the heads
      if (tid == 0) s_n = 0;
      block_select<kFinalThreads>(sel, n, head, st, mask, prefix);
      compact<kFinalThreads>(sel, n, mask, prefix, keys, &s_n, nullptr);
      __syncthreads();
      sel = keys;
      n = head;
    }
  } else {
    __syncthreads();
    n = s_sel;
  }
  sort_out<kFinalThreads>(sel, n, out);
}

// Set on every launch: static and dynamic shared memory together above
// 48 KB need it, and a value set for another call persists.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The scratch of `blocks` > 1 blocks: kept keys (blocks x head), the
// threshold word, the counts (ints).
struct Scratch {
  u64* kept;
  u64* thr;
  int* counts;
};

Scratch carve(u64* scratch, int blocks, int head) {
  if (blocks == 1) return Scratch{nullptr, nullptr, nullptr};
  u64* thr = scratch + static_cast<long long>(blocks) * head;
  return Scratch{scratch, thr, reinterpret_cast<int*>(thr + 1)};
}

// The final head's CTAs: one up to kOneCta kept keys, else a cluster of
// up to kCluster whose gathered heads fit in kFinalKeys keys.
int final_ctas(int blocks, int head) {
  if (blocks * head <= kOneCta) return 1;
  return min(kCluster, kFinalKeys / head);
}

int check_plan(long long total, int head, int blocks) {
  if (total < 1 || total > 0x7fffffffLL || head < 1 || head > kMaxHead ||
      blocks < 1 || (blocks > 1 && blocks > min(kCluster, kFinalKeys / head)
                                                * (kFinalKeys / head)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int final_launch(const Scratch& s, int blocks, int head,
                 unsigned long long* out, cudaStream_t stream) {
  const int C = final_ctas(blocks, head);
  const int p2 = pow2_at_least(head);
  const int cap = max((blocks + C - 1) / C * head, p2);
  const int gather = max(C * head, p2);
  const size_t bytes = static_cast<size_t>(cap + gather) * 8;
  cudaError_t err;
  if (C == 1) {
    err = allow_smem(final_head<false>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    final_head<false><<<1, kFinalThreads, bytes, stream>>>(
        s.kept, s.counts, blocks, head, cap, s.thr, out);
    return static_cast<int>(cudaGetLastError());
  }
  err = allow_smem(final_head<true>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kFinalThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, final_head<true>, static_cast<const u64*>(s.kept),
      static_cast<const int*>(s.counts), blocks, head, cap,
      static_cast<const u64*>(s.thr), out));
}

// With more than one block: the threshold word reset, then the first
// launch (already made by the caller's `first`), then the final head.
template <class First>
int run_heads(First first, const Scratch& s, int blocks, int head,
              unsigned long long* out, cudaStream_t stream) {
  if (blocks > 1) {
    const cudaError_t err = cudaMemsetAsync(s.thr, 0xff, 8, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err = first();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  return final_launch(s, blocks, head, out, stream);
}

}  // namespace

// K19. ov (n_ov, n_ov) f32 overlap (its first n rows and columns read),
// tab (n, k) int32 (entries clamped to `total`), total = C(n, k) < 2^31,
// 1 <= head <= kMaxHead; `blocks` first-launch blocks; scratch, with more
// than one block, blocks x head + 1 + ceil(blocks / 2) 64-bit words; out
// (head): the min(head, total) smallest keys, sorted.
MAD_EXPORT int mad_enumerate_head(const float* ov, int n_ov, const int* tab,
                                  int n, int k, long long total, int head,
                                  int blocks, unsigned long long* scratch,
                                  unsigned long long* out,
                                  cudaStream_t stream) {
  int bad = check_plan(total, head, blocks);
  if (bad || n > n_ov || n > 64 || k < 1 || k > n) {
    return bad ? bad : static_cast<int>(cudaErrorInvalidValue);
  }
  const Scratch s = carve(scratch, blocks, head);
  const size_t bytes = filter_bytes(head) + static_cast<size_t>(n) * n * 4
                       + static_cast<size_t>(n) * k * 4;
  cudaError_t err = allow_smem(combo_head, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return run_heads([&] {
    combo_head<<<blocks, kThreads, bytes, stream>>>(
        ov, n_ov, tab, n, k, total, head, s.thr, s.kept, s.counts, out);
    return cudaGetLastError();
  }, s, blocks, head, out, stream);
}

// K20. ov (n_ov, n_ov) f32 overlap of which the first nsol rows and
// columns are read (sym in shared memory up to kSymBytes); lists (G,
// max_n) int32 (in shared memory up to kListBytes); radix (G) of Radix,
// three int32 a group; total = prod(sizes) < 2^31; the rest as for
// mad_enumerate_head.
MAD_EXPORT int mad_hetero_head(const float* ov, int n_ov, int nsol,
                               const int* lists, int max_n, const int* radix,
                               int G, long long total, int head, int blocks,
                               unsigned long long* scratch,
                               unsigned long long* out, cudaStream_t stream) {
  int bad = check_plan(total, head, blocks);
  if (bad || nsol > n_ov || G < 1 || max_n < 1)
    return bad ? bad : static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = carve(scratch, blocks, head);
  const long long list_bytes = static_cast<long long>(G) * max_n * 4;
  const long long sym_bytes = static_cast<long long>(nsol) * nsol * 4;
  const size_t bytes = filter_bytes(head) + sizeof(Radix) * G
                       + (list_bytes <= kListBytes ? list_bytes : 0)
                       + (sym_bytes <= kSymBytes ? sym_bytes : 0);
  cudaError_t err = allow_smem(product_head, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return run_heads([&] {
    product_head<<<blocks, kThreads, bytes, stream>>>(
        ov, n_ov, nsol, lists, max_n, reinterpret_cast<const Radix*>(radix),
        G, total, head, s.thr, s.kept, s.counts, out);
    return cudaGetLastError();
  }, s, blocks, head, out, stream);
}
