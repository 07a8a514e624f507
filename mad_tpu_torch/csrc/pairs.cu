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
// min(max_pairs, rows * k) keys; mad_pair_merge, stages 2 and 3 alone over
// the shards' heads concatenated, keeps the smallest L: the single-device
// head, since a key among the L smallest overall is among the L smallest
// of its own shard.
//
// 1. row_heads, one block per row: count the survivors; where there are
//    more than k = min(row_cap, dl), a radix select (four 8-bit digits,
//    histograms in shared memory, the row re-read from L1/L2 each pass, so
//    no row length limit) finds the value key T of the k-th; keys < T go in
//    whole, keys == T (equal cosines) in column order by a block scan until
//    the row holds k. Empty slots get ~0.
// 2. tile_sort: bitonic sort of tiles of kTile keys in shared memory.
// 3. merge_pass, log2(N / kTile) times: runs of width w merge pairwise by
//    rank (each key's place in the other run by binary search), each run
//    cut at L keys (a key behind L others in its run is behind L overall).
//
// Bound: bytes, the (dh, dl) cosines read once (6.7 MB at the bench:
// 366 x 4,588) and L keys written. The row is read six times (count, four
// digits, write), from L1 / L2 after the first.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kTile = 4096;
constexpr int kTileThreads = 1024;
constexpr int kMergeThreads = 256;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned value_key(float v) {
  const unsigned b = __float_as_uint(v);
  return ~((b & 0x80000000u) ? ~b : (b | 0x80000000u));
}

__device__ __forceinline__ unsigned long long pair_key(unsigned vk,
                                                       unsigned idx) {
  return (static_cast<unsigned long long>(vk) << 32) | idx;
}

// Sum of x over the block, returned to every thread. red holds 32 ints.
__device__ int block_sum(int x, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  __syncthreads();                      // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

__global__ void row_heads(const float* __restrict__ sim, int dl, int k,
                          float thr, int row0,
                          unsigned long long* __restrict__ heads) {
  __shared__ int hist[256];
  __shared__ int red[32];
  __shared__ unsigned s_prefix;
  __shared__ int s_need, s_slot;
  const int row = blockIdx.x;
  const float* v = sim + static_cast<long long>(row) * dl;
  unsigned long long* out = heads + static_cast<long long>(row) * k;
  const unsigned base = static_cast<unsigned>(row0 + row)
                        * static_cast<unsigned>(dl);

  int n = 0;
  for (int c = threadIdx.x; c < dl; c += blockDim.x) n += v[c] > thr;
  n = block_sum(n, red);
  const bool all = n <= k;

  // Radix select of the k-th smallest value key among the survivors.
  unsigned prefix = 0, mask = 0;
  int need = k;                        // rank of the target among matches
  if (!all) {
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
      __syncthreads();
      for (int c = threadIdx.x; c < dl; c += blockDim.x) {
        const float x = v[c];
        if (x > thr) {
          const unsigned kk = value_key(x);
          if ((kk & mask) == prefix)
            atomicAdd(&hist[(kk >> shift) & 255u], 1);
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int cum = 0;
        for (int b = 0; b < 256; ++b) {
          if (cum + hist[b] >= need) {
            s_prefix = prefix | (static_cast<unsigned>(b) << shift);
            s_need = need - cum;
            break;
          }
          cum += hist[b];
        }
      }
      __syncthreads();
      prefix = s_prefix;
      need = s_need;
      mask |= 255u << shift;
    }
  }
  // Keys below the k-th (all survivors when they fit) in any slot order.
  if (threadIdx.x == 0) s_slot = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < dl; c += blockDim.x) {
    const float x = v[c];
    if (x > thr) {
      const unsigned kk = value_key(x);
      if (all || kk < prefix)
        out[atomicAdd(&s_slot, 1)] = pair_key(kk, base + c);
    }
  }
  if (all) {
    __syncthreads();
    for (int i = n + threadIdx.x; i < k; i += blockDim.x) out[i] = kNone;
    return;
  }
  // Keys equal to the k-th: the first `need` in column order, into the
  // last `need` slots.
  int taken = 0;
  for (int c0 = 0; c0 < dl && taken < need; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool eq = c < dl && v[c] > thr && value_key(v[c]) == prefix;
    const unsigned m = __ballot_sync(0xffffffffu, eq);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();                    // red is free
    if (lane == 0) red[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      before += w < warp ? red[w] : 0;
      total += red[w];
    }
    const int rank = taken + before + __popc(m & ((1u << lane) - 1u));
    if (eq && rank < need)
      out[k - need + rank] = pair_key(prefix, base + c);
    taken += total;
  }
}

__global__ void tile_sort(unsigned long long* __restrict__ keys,
                          long long N) {
  __shared__ unsigned long long s[kTile];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x)
    s[i] = base + i < N ? keys[base + i] : kNone;
  __syncthreads();
  mad_bitonic_sort(s, kTile);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x)
    if (base + i < N) keys[base + i] = s[i];
}

// Sorted runs [r w, r w + min(w, L, N - r w)) merge pairwise into runs of
// 2 w, each cut at L. A key of a left run counts the partner's keys below
// it, a key of a right run those at or below it, so equal keys (only the
// ~0 padding) land in distinct places.
__global__ void merge_pass(const unsigned long long* __restrict__ in,
                           unsigned long long* __restrict__ out, long long N,
                           long long w, long long L) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= N) return;
  const long long cap = w < L ? w : L;
  const long long run = i / w, start = run * w;
  const long long pos = i - start;
  if (pos >= cap) return;
  const bool left = (run & 1) == 0;
  const long long pstart = left ? start + w : start - w;
  long long plen = pstart >= N ? 0 : N - pstart;
  if (plen > cap) plen = cap;
  const unsigned long long key = in[i];
  long long lo = 0, hi = plen;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const unsigned long long pk = in[pstart + mid];
    if (left ? pk < key : pk <= key) lo = mid + 1;
    else hi = mid;
  }
  const long long opos = pos + lo;
  if (opos < L) out[(left ? start : pstart) + opos] = key;
}

// Stages 2 and 3: the smallest L of the N keys in `keys` (sorted in place
// by tiles; tmp N more) into out, ascending.
int select_smallest(unsigned long long* keys, unsigned long long* tmp,
                    long long N, long long L, unsigned long long* out,
                    cudaStream_t stream) {
  tile_sort<<<static_cast<int>((N + kTile - 1) / kTile), kTileThreads, 0,
              stream>>>(keys, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long *src = keys, *dst = tmp;
  const int blocks = static_cast<int>((N + kMergeThreads - 1)
                                      / kMergeThreads);
  for (long long w = kTile; w < N; w *= 2) {
    merge_pass<<<blocks, kMergeThreads, 0, stream>>>(src, dst, N, w, L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  return static_cast<int>(cudaMemcpyAsync(out, src, L * sizeof(*out),
                                          cudaMemcpyDeviceToDevice, stream));
}

}  // namespace

// sim (rows, dl) float32, rows row0 .. row0 + rows - 1 of a table of dl
// columns; heads and tmp (rows * k) uint64 scratch; out (L).
MAD_EXPORT int mad_pair_head(const float* sim, int dh, int dl, int k,
                             float thr, int row0, long long L,
                             unsigned long long* heads,
                             unsigned long long* tmp,
                             unsigned long long* out, cudaStream_t stream) {
  const long long N = static_cast<long long>(dh) * k;
  if (N == 0 || L == 0) return 0;
  row_heads<<<dh, kRowThreads, 0, stream>>>(sim, dl, k, thr, row0, heads);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return select_smallest(heads, tmp, N, L, out, stream);
}

// The global top of a mesh run: the smallest L <= N of the N keys of the
// shards' heads (keys is scratch, sorted in place by tiles; tmp N more).
MAD_EXPORT int mad_pair_merge(unsigned long long* keys, long long N,
                              long long L, unsigned long long* tmp,
                              unsigned long long* out, cudaStream_t stream) {
  if (N == 0 || L == 0) return 0;
  return select_smallest(keys, tmp, N, L, out, stream);
}
