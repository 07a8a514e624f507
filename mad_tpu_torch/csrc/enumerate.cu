// K19 / K20: the heads of the assembly enumerations.
//
// K19 replaces mad_tpu/engine/assemble.py:336-402 (_compiled_enumerate_head):
// rank r in [0, C(n, k)) decodes greedily, in lexicographic order, from the
// binomial table tab[x, i] = C(n-1-x, k-1-i) into a uint64 membership mask
// (n <= 64), and the tuple's score is the largest sym[a][b] over its pairs.
// K20 replaces :498-548 (_compiled_hetero_head): rank r in [0,
// prod(sizes)) decodes in mixed radix, index g = (r / stride_g) % size_g,
// maps through the padded (G, max_n) group lists, and the score is the f32
// sum of sym over the pairs i0 < i1 in itertools.combinations order, added
// one by one.
//
// sym[i][j] = ov[i][j] + ov[j][i] (one IEEE float32 add) for i, j < t, of
// K18's (n_ov, n_ov) upper-triangular overlap on the card: mad_tpu's
// _compiled_embed_sym (:316-333), which the port once ran as a kernel of
// its own (K20b), is folded into the heads' staging. K19 and K20 (up to
// 128 solutions) form it as they stage it in shared memory; K20 above
// that forms it at each read from device memory.
//
// Head: each score packs with its rank into one uint64 key,
// (float bits of score >= 0) << 32 | rank, so that the order of the keys
// is the order (score, rank) -- the tie order of the JAX bodies' running
// lax.top_k merge. A block keeps the smallest `head` keys of its ranks in
// the first `head` slots of a shared-memory array of S keys (S a power of
// two >= 2 head): it fills the other S - head slots with fresh keys,
// bitonic-sorts all S, and repeats over its share of the ranks. A second
// launch of one block reduces the blocks' heads the same way.
//
// Bound: K19 is decode-bound (one table lookup and compare per candidate
// solution, then k (k - 1) / 2 shared-memory reads a rank); K20 is bound
// by the G (G - 1) / 2 integer divisions and table reads a rank. Both read
// only a few KB (tables, lists, the overlap) and write `head`
// keys per block, so the (ranks,) score vector never exists; the sorts
// cost about log2(S)^2 / 2 passes over S keys per S - head ranks.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned long long pack_key(float v, int r) {
  const unsigned bits = v > 0.0f ? __float_as_uint(v) : 0u;
  return (static_cast<unsigned long long>(bits) << 32)
         | static_cast<unsigned>(r);
}

// The block's smallest `head` keys of src(r), r in its share of [0, total),
// written sorted to out (kNone where there are fewer).
template <class Source>
__device__ void block_head(const Source& src, long long total, int head,
                           int S, unsigned long long* keys,
                           unsigned long long* out) {
  for (int i = threadIdx.x; i < head; i += blockDim.x) keys[i] = kNone;
  const int fresh = S - head;
  for (long long base = blockIdx.x * static_cast<long long>(fresh);
       base < total; base += gridDim.x * static_cast<long long>(fresh)) {
    for (int i = threadIdx.x; i < fresh; i += blockDim.x) {
      const long long r = base + i;
      keys[head + i] = r < total ? src(r) : kNone;
    }
    __syncthreads();
    mad_bitonic_sort(keys, S);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < head; i += blockDim.x) out[i] = keys[i];
}

struct ComboSource {
  const float* sym;      // (n, n), shared memory
  const int* tab;        // (n, k), shared memory
  int n, k;
  __device__ unsigned long long operator()(long long r64) const {
    const int r = static_cast<int>(r64);
    int rem = r, slot = 0;
    unsigned long long mask = 0;
    for (int x = 0; x < n && slot < k; ++x) {
      const int c = tab[x * k + slot];
      if (rem < c) {
        mask |= 1ull << x;
        ++slot;
      } else {
        rem -= c;
      }
    }
    float best = 0.0f;
    unsigned long long ma = mask;
    while (ma) {
      const int a = __ffsll(static_cast<long long>(ma)) - 1;
      ma &= ma - 1;
      unsigned long long mb = ma;
      while (mb) {
        const int b = __ffsll(static_cast<long long>(mb)) - 1;
        mb &= mb - 1;
        best = fmaxf(best, sym[a * n + b]);
      }
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

// Stage sym (t, t) of the overlap in shared memory.
__device__ __forceinline__ void stage_sym(const float* __restrict__ ov,
                                          int n_ov, int t, float* s_sym) {
  for (int i = threadIdx.x; i < t * t; i += blockDim.x)
    s_sym[i] = sym_of(ov, n_ov, i / t, i % t);
}

struct ProductSource {
  const float* sym;      // (nsol, nsol) staged in shared memory, or null
  const float* ov;       // the overlap (stride n_ov) read when sym is null
  const int* lists;      // (G, max_n)
  const int* radix;      // sizes (G) then strides (G)
  int n_ov, nsol, max_n, G;
  __device__ float pair(int a, int b) const {
    return sym != nullptr ? sym[a * nsol + b] : sym_of(ov, n_ov, a, b);
  }
  __device__ unsigned long long operator()(long long r64) const {
    const int r = static_cast<int>(r64);
    float s = 0.0f;
    for (int i0 = 0; i0 < G; ++i0) {
      const int a =
          lists[i0 * max_n + (r / radix[G + i0]) % radix[i0]];
      for (int i1 = i0 + 1; i1 < G; ++i1) {
        const int b =
            lists[i1 * max_n + (r / radix[G + i1]) % radix[i1]];
        s = add_rn(s, pair(a, b));
      }
    }
    return pack_key(s, r);
  }
};

struct KeySource {
  const unsigned long long* keys;
  __device__ unsigned long long operator()(long long r) const {
    return keys[r];
  }
};

__global__ void combo_head(const float* __restrict__ ov, int n_ov,
                           const int* __restrict__ tab, int n, int k,
                           long long total, int head, int S,
                           unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  float* s_sym = reinterpret_cast<float*>(smem + S);
  int* s_tab = reinterpret_cast<int*>(s_sym + n * n);
  stage_sym(ov, n_ov, n, s_sym);
  for (int i = threadIdx.x; i < n * k; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  block_head(ComboSource{s_sym, s_tab, n, k}, total, head, S, smem,
             out + static_cast<long long>(blockIdx.x) * head);
}

__global__ void product_head(const float* __restrict__ ov, int n_ov,
                             int nsol, bool sym_in_smem,
                             const int* __restrict__ lists, int max_n,
                             const int* __restrict__ radix, int G,
                             long long total, int head, int S,
                             unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  int* s_radix = reinterpret_cast<int*>(smem + S);
  float* s_sym = reinterpret_cast<float*>(s_radix + 2 * G);
  for (int i = threadIdx.x; i < 2 * G; i += blockDim.x) s_radix[i] = radix[i];
  if (sym_in_smem) stage_sym(ov, n_ov, nsol, s_sym);
  __syncthreads();
  block_head(ProductSource{sym_in_smem ? s_sym : nullptr, ov, lists, s_radix,
                           n_ov, nsol, max_n, G},
             total, head, S, smem,
             out + static_cast<long long>(blockIdx.x) * head);
}

__global__ void key_head(const unsigned long long* __restrict__ in,
                         long long total, int head, int S,
                         unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  block_head(KeySource{in}, total, head, S, smem, out);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Second pass: one block reduces `blocks` heads in `partial` into out.
int reduce_heads(const unsigned long long* partial, int blocks, int head,
                 int S, unsigned long long* out, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(S) * 8;
  cudaError_t err = allow_smem(key_head, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  key_head<<<1, kThreads, bytes, stream>>>(
      partial, static_cast<long long>(blocks) * head, head, S, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K19. ov (n_ov, n_ov) f32 overlap (its first n rows and columns read),
// tab (n, k) int32 (entries clamped to `total`), total = C(n, k) < 2^31;
// `blocks` first-pass blocks, each writing `head` keys to partial (blocks
// * head); out (head) the sorted smallest keys. With blocks == 1 the first
// pass writes out directly.
MAD_EXPORT int mad_enumerate_head(const float* ov, int n_ov, const int* tab,
                                  int n, int k, long long total, int head,
                                  int S, int blocks,
                                  unsigned long long* partial,
                                  unsigned long long* out,
                                  cudaStream_t stream) {
  if (n > n_ov) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(S) * 8
                       + static_cast<size_t>(n) * n * 4
                       + static_cast<size_t>(n) * k * 4;
  cudaError_t err = allow_smem(combo_head, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  combo_head<<<blocks, kThreads, bytes, stream>>>(
      ov, n_ov, tab, n, k, total, head, S, blocks == 1 ? out : partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  return reduce_heads(partial, blocks, head, S, out, stream);
}

// K20. ov (n_ov, n_ov) f32 overlap of which the first nsol rows and
// columns are read; sym (nsol, nsol) staged in shared memory when
// sym_in_smem; lists (G, max_n) int32; radix = sizes then strides (2 G
// int32); total = prod(sizes) < 2^31; the rest as for mad_enumerate_head.
MAD_EXPORT int mad_hetero_head(const float* ov, int n_ov, int nsol,
                               int sym_in_smem, const int* lists, int max_n,
                               const int* radix, int G, long long total,
                               int head, int S, int blocks,
                               unsigned long long* partial,
                               unsigned long long* out, cudaStream_t stream) {
  if (nsol > n_ov) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(S) * 8
                       + static_cast<size_t>(2 * G) * 4
                       + (sym_in_smem ? static_cast<size_t>(nsol) * nsol * 4
                                      : 0);
  cudaError_t err = allow_smem(product_head, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  product_head<<<blocks, kThreads, bytes, stream>>>(
      ov, n_ov, nsol, sym_in_smem != 0, lists, max_n, radix, G, total, head,
      S, blocks == 1 ? out : partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  return reduce_heads(partial, blocks, head, S, out, stream);
}
