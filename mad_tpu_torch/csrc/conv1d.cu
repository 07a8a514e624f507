// K1: 1D convolution of float32 volumes along one axis, zero padded,
// 'same' or 'full' output, and the fused three-pass LoG.
//
// Replaces mad_tpu/ops/convolve.py:79-124 (conv1d_along, the body of
// separable_conv3d / gaussian_filter3d and of the simulator's 'full' blur,
// ops/simulate.py:86-112) and :144-162 (log_filter3d's nine passes and its
// epilogue).
//
// A volume is viewed as (outer, n, inner) with the convolved axis in the
// middle (a leading batch axis is more outer); the output is (outer,
// out_n, inner) and
//   out[o, i, q] = sum_m w[m] * in[o, i + m - lo, q],  w[m] = taps[ksz-1-m]
// over in-range input rows, zero taps skipped, summed in m order with one
// rounding per multiply and per add: the order of the shift-add of
// kernels/conv1d.py (mad_tpu/ops/convolve.py:116-123). A sum starts from
// -0.0, which leaves its first term as it is, as the plain version's does.
//
// Entries:
//   * mad_conv1d: one kernel along one axis (mode kSingle), and its form
//     with the epilogues of the simulation's 'full' blur of a batch of
//     structures (mode kSingleEpi; ops/simulate.py, mad_tpu/ops/
//     simulate.py:103-105): div_keys divides each in-range input by
//     max(m_s, 1e-30), m_s its structure's max (an order key,
//     common.cuh), with an IEEE division in shared memory once the tile
//     has landed (the bits of dividing the volume first; the padding
//     stays +0, as when the plain version pads the divided volume);
//     max_keys merges the max of the outputs written into their
//     structure's key with an order-free atomicMax (a warp reduction,
//     then an atomic where it raises the key). A structure is outer_per_s
//     consecutive outer rows. Without either pointer mad_conv1d runs
//     kSingle, which has no epilogue code;
//   * mad_log_pass: the LoG of ops/convolve.py's log_filter3d in three
//     passes over its nine convolutions (g0, g2: order 0 and 2 taps):
//       x: ax = g0(vol), bx = g2(vol);
//       y: axy = g0(ax), a2y = g2(ax), bxy = g0(bx);
//       z: gauss = g0(axy) and log = clamp(-((g0(bxy) + g0(a2y)) +
//          g2(axy)) * sigma^2, min 0), rounded as torch.add, add_, neg_,
//          mul_ and clamp_ round on the card (NaN kept, ::max otherwise).
//     13 volumes move in place of the unfused chain's 30.
//
// Bound: bytes (each pass reads its inputs and writes its outputs once)
// and the unfused multiplies and adds (2 instructions a nonzero tap and
// output). Design:
//   * the taps are a kernel parameter (constant bank), reversed on the
//     host; the common tap counts (5, 9, 11, 17) are template arguments,
//     so the tap loop unrolls and the zero-tap test is a uniform branch on
//     a parameter; other counts take a generic loop;
//   * each thread keeps kR = 8 consecutive outputs along the axis in
//     registers and reads its window of kR + ksz - 1 inputs from shared
//     memory once;
//   * strided axes: a tile of 32 contiguous columns by up to 64 outputs
//     along the axis (the axis cut into equal tiles, so no tile is mostly
//     idle); the contiguous axis: a few rows (or equal segments of them) a
//     tile, the thread count sized to the rows (559-voxel rows: 70 threads
//     a row, 3 rows in 224 threads), the outputs staged in shared memory
//     and written coalesced;
//   * one tile a block, as many blocks as tiles, shared memory carved out
//     before L1; the tile's inputs copied with cp.async (4-byte copies
//     with the hardware's zero fill for rows outside the volume: 'same'
//     mode's padding), the other resident blocks' work covering the wait.
//     A persistent grid whose blocks walked the tiles, loading the next
//     while computing the current one, and 16-byte copies placed by each
//     row's offset mod 4, both measured slower on the H100 (PERF.md).
#include "common.cuh"

namespace {

constexpr int kMaxTaps = 129;
constexpr int kR = 8;              // outputs a thread keeps along the axis
constexpr int kQ = 32;             // contiguous columns of a strided tile
constexpr int kRows = 8;           // thread rows of a strided tile
constexpr int kTileA = kR * kRows; // outputs along the axis, strided tile
constexpr int kMaxContig = 256;    // threads of a contiguous-axis tile

enum { kSingle = 0, kLogX = 1, kLogY = 2, kLogZ = 3, kSingleEpi = 4 };

struct Taps {
  float init;                      // -0.0, or +0.0 when every tap is 0
  float w[kMaxTaps];               // w[m] = taps[ksz - 1 - m]
};

struct Pass {
  const float* in[3];
  float* out[3];
  Taps taps[2];                    // g0 (or the single kernel), g2
  float s2;                        // sigma^2 of the LoG epilogue
  int ksz, n, inner, out_n, lo;
  long long outer;
  // kSingleEpi's epilogues (either may be null)
  const unsigned* div_keys;        // divide inputs by their structure's max
  unsigned* max_keys;              // merge the outputs' max per structure
  long long outer_per_s;           // outer rows a structure
  // tiling: strided (a_tiles x q_tiles a row of outer, ta outputs a tile)
  // or contiguous (rows rows of seg outputs a tile, segs tiles along a row,
  // tpr threads a row)
  int a_tiles, ta, q_tiles, seg, segs, rows, tpr;
  long long tiles;
  int buf_floats;                  // one input's staging buffer (one row of
                                   // a contiguous tile), floats
};

// The convolutions of a pass: conv c reads input conv_in, with tap set
// conv_tap (0 = g0, 1 = g2).
__host__ __device__ constexpr bool single(int mode) {
  return mode == kSingle || mode == kSingleEpi;
}
__host__ __device__ constexpr int n_in(int mode) {
  return mode == kLogY ? 2 : (mode == kLogZ ? 3 : 1);
}
__host__ __device__ constexpr int n_conv(int mode) {
  return single(mode) ? 1 : (mode == kLogX ? 2 : (mode == kLogY ? 3 : 4));
}
__host__ __device__ constexpr int n_out(int mode) {
  return mode == kLogZ ? 2 : n_conv(mode);
}
__host__ __device__ constexpr int conv_in(int mode, int c) {
  return mode == kLogY ? (c == 2 ? 1 : 0)
                       : (mode == kLogZ ? (c <= 1 ? 0 : c - 1) : 0);
}
__host__ __device__ constexpr int conv_tap(int mode, int c) {
  return (!single(mode) && c == 1) ? 1 : 0;
}

// kSingleEpi's divide: the divisor of outer row o's inputs, and one
// input divided by a divisor that is not NaN (a zero divided by a positive
// divisor is itself, with its sign, so zeros skip the division, whose zero
// dividend takes its slow path; so does the staged padding, which stays
// +0).
__device__ __forceinline__ float row_divisor(const Pass& p, long long o) {
  return mad_norm_divisor(p.div_keys[o / p.outer_per_s]);
}
__device__ __forceinline__ float divided(float v, float d) {
  return v == 0.0f && !isnan(d) ? v : __fdiv_rn(v, d);
}

// kSingleEpi's max: merge this thread's max key k (0: it stored none) of
// outputs in outer row o into its structure's key: a warp whose lanes
// share a structure reduces first, and an atomic goes out only where it
// raises the key (no barrier, no shared memory).
__device__ __forceinline__ void merge_max(const Pass& p, long long o,
                                          unsigned k) {
  const long long s = o / p.outer_per_s;
  if (__all_sync(0xffffffffu, s == __shfl_sync(0xffffffffu, s, 0))) {
    k = __reduce_max_sync(0xffffffffu, k);
    if ((threadIdx.x & 31) != 0) return;
  }
  if (k != 0 && k > p.max_keys[s]) atomicMax(p.max_keys + s, k);
}

// Sum the pass's convolutions of one input window into acc. win(j) is the
// j-th input of the thread's window (j < kR + ksz - 1).
template <int MODE, int KSZ, int I, typename Win>
__device__ __forceinline__ void convolve_input(const Pass& p, Win win,
                                               float (&acc)[4][kR]) {
  if constexpr (KSZ > 0) {
    float v[kR + KSZ - 1];
#pragma unroll
    for (int j = 0; j < kR + KSZ - 1; ++j) v[j] = win(j);
#pragma unroll
    for (int c = 0; c < n_conv(MODE); ++c) {
      if (conv_in(MODE, c) != I) continue;
      const Taps& t = p.taps[conv_tap(MODE, c)];
#pragma unroll
      for (int m = 0; m < KSZ; ++m) {
        const float w = t.w[m];
        if (w != 0.0f) {
#pragma unroll
          for (int r = 0; r < kR; ++r)
            acc[c][r] = add_rn(acc[c][r], mul_rn(w, v[r + m]));
        }
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < n_conv(MODE); ++c) {
      if (conv_in(MODE, c) != I) continue;
      const Taps& t = p.taps[conv_tap(MODE, c)];
      for (int m = 0; m < p.ksz; ++m) {
        const float w = t.w[m];
        if (w == 0.0f) continue;
#pragma unroll
        for (int r = 0; r < kR; ++r)
          acc[c][r] = add_rn(acc[c][r], mul_rn(w, win(r + m)));
      }
    }
  }
}

template <int MODE>
__device__ __forceinline__ void init_acc(const Pass& p, float (&acc)[4][kR]) {
#pragma unroll
  for (int c = 0; c < n_conv(MODE); ++c)
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[c][r] = p.taps[conv_tap(MODE, c)].init;
}

// Output k of the pass from the sums of output slot r.
template <int MODE>
__device__ __forceinline__ float result(const Pass& p,
                                        const float (&acc)[4][kR], int k,
                                        int r) {
  if constexpr (MODE == kLogZ) {
    if (k == 0) return acc[0][r];
    // lap = (term_x + term_y) + term_z, then neg_, mul_(sigma^2), clamp_
    const float lap = add_rn(add_rn(acc[3][r], acc[2][r]), acc[1][r]);
    const float v = mul_rn(-lap, p.s2);
    return isnan(v) ? v : fmaxf(v, 0.0f);
  } else {
    return acc[k][r];
  }
}

// ---- strided axes (inner > 1) ---------------------------------------------

template <int MODE>
__device__ __forceinline__ void strided_load(const Pass& p, long long t,
                                             float* buf) {
  const int qt = static_cast<int>(t % p.q_tiles);
  const long long rest = t / p.q_tiles;
  const int at = static_cast<int>(rest % p.a_tiles);
  const long long o = rest / p.a_tiles;
  const int a0 = at * p.ta, q0 = qt * kQ;
  const int rows = p.ta + p.ksz - 1;
  for (int idx = threadIdx.x; idx < rows * kQ; idx += blockDim.x) {
    const int r = idx / kQ, c = idx % kQ;
    const int src = a0 - p.lo + r, q = q0 + c;
    const bool valid = src >= 0 && src < p.n && q < p.inner;
    const long long off =
        valid ? (o * p.n + src) * static_cast<long long>(p.inner) + q : 0;
#pragma unroll
    for (int i = 0; i < n_in(MODE); ++i)
      cp_async4(buf + i * p.buf_floats + idx, p.in[i] + off, valid);
  }
}

template <int MODE, int KSZ>
__global__ void __launch_bounds__(kQ * kRows) conv_strided(
    const __grid_constant__ Pass p) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x % kQ, ty = threadIdx.x / kQ;
  const long long t = blockIdx.x;
  strided_load<MODE>(p, t, smem);
  cp_async_wait_all();
  const int qt = static_cast<int>(t % p.q_tiles);
  const long long rest = t / p.q_tiles;
  const int at = static_cast<int>(rest % p.a_tiles);
  const long long o = rest / p.a_tiles;
  // kSingleEpi's divide: as the window is read (the padding is +0, which
  // divided() keeps), or, for a NaN divisor, of the in-range inputs in
  // place first (the padding then stays +0 while the inputs become NaN)
  float d = 1.0f;
  bool divide_on_read = false;
  if constexpr (MODE == kSingleEpi) {
    if (p.div_keys != nullptr) {
      d = row_divisor(p, o);
      divide_on_read = !isnan(d);
      if (!divide_on_read) {
        // the thread's own copies have landed
        const int rows = p.ta + p.ksz - 1;
        for (int idx = threadIdx.x; idx < rows * kQ; idx += blockDim.x) {
          const int src = at * p.ta - p.lo + idx / kQ;
          const int q = qt * kQ + idx % kQ;
          if (src >= 0 && src < p.n && q < p.inner)
            smem[idx] = __fdiv_rn(smem[idx], d);
        }
      }
    }
  }
  __syncthreads();
  const int q = qt * kQ + tx;
  float acc[4][kR];
  init_acc<MODE>(p, acc);
#pragma unroll
  for (int i = 0; i < n_in(MODE); ++i) {
    const float* col = smem + i * p.buf_floats + ty * kR * kQ + tx;
    if constexpr (MODE == kSingleEpi) {
      auto win = [col, d, divide_on_read](int j) {
        const float v = col[j * kQ];
        return divide_on_read ? divided(v, d) : v;
      };
      convolve_input<MODE, KSZ, 0>(p, win, acc);
    } else {
      auto win = [col](int j) { return col[j * kQ]; };
      if (i == 0) convolve_input<MODE, KSZ, 0>(p, win, acc);
      if (i == 1) convolve_input<MODE, KSZ, 1>(p, win, acc);
      if (i == 2) convolve_input<MODE, KSZ, 2>(p, win, acc);
    }
  }
  if constexpr (MODE == kSingleEpi) {
    unsigned kmax = 0;
    if (q < p.inner) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int a = ty * kR + r, i = at * p.ta + a;
        if (a >= p.ta || i >= p.out_n) break;
        p.out[0][(o * p.out_n + i) * static_cast<long long>(p.inner) + q] =
            acc[0][r];
        if (p.max_keys != nullptr) kmax = max(kmax, mad_max_key(acc[0][r]));
      }
    }
    if (p.max_keys != nullptr) merge_max(p, o, kmax);
    return;
  }
  if (q >= p.inner) return;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int a = ty * kR + r, i = at * p.ta + a;
    if (a >= p.ta || i >= p.out_n) break;
    const long long at_out = (o * p.out_n + i) * static_cast<long long>(
                                 p.inner) + q;
#pragma unroll
    for (int k = 0; k < n_out(MODE); ++k)
      p.out[k][at_out] = result<MODE>(p, acc, k, r);
  }
}

// ---- the contiguous axis (inner == 1) -------------------------------------

// A tile: rows consecutive rows (outer indices) by one segment of seg
// outputs; tpr threads a row, kR outputs a thread.
template <int MODE>
__device__ __forceinline__ void contig_load(const Pass& p, long long t,
                                            float* buf) {
  const long long o0 = t / p.segs * p.rows;
  const int s0 = static_cast<int>(t % p.segs) * p.seg;
  const int len = p.tpr * kR + p.ksz - 1;
  for (int r = 0; r < p.rows; ++r) {
    const long long o = o0 + r;
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int src = s0 - p.lo + j;
      const bool valid = o < p.outer && src >= 0 && src < p.n;
      const long long off = valid ? o * p.n + src : 0;
#pragma unroll
      for (int i = 0; i < n_in(MODE); ++i)
        cp_async4(buf + (i * p.rows + r) * p.buf_floats + j, p.in[i] + off,
                  valid);
    }
  }
}

template <int MODE, int KSZ>
__global__ void __launch_bounds__(kMaxContig) conv_contig(
    const __grid_constant__ Pass p) {
  extern __shared__ float smem[];
  const int cap = p.tpr * kR;                     // outputs a row holds
  float* staged = smem + n_in(MODE) * p.rows * p.buf_floats;
  const int row = threadIdx.x / p.tpr, lane = threadIdx.x % p.tpr;
  const long long t = blockIdx.x;
  contig_load<MODE>(p, t, smem);
  cp_async_wait_all();
  if constexpr (MODE == kSingleEpi) {
    // the thread's own copies have landed: divide them in place
    if (p.div_keys != nullptr) {
      const long long o0 = t / p.segs * p.rows;
      const int s0 = static_cast<int>(t % p.segs) * p.seg;
      const int len = p.tpr * kR + p.ksz - 1;
      for (int r = 0; r < p.rows && o0 + r < p.outer; ++r) {
        const float d = row_divisor(p, o0 + r);
        for (int j = threadIdx.x; j < len; j += blockDim.x) {
          const int src = s0 - p.lo + j;
          float& v = smem[r * p.buf_floats + j];
          if (src >= 0 && src < p.n) v = divided(v, d);
        }
      }
    }
  }
  __syncthreads();
  unsigned kmax = 0;
  if (row < p.rows) {
    float acc[4][kR];
    init_acc<MODE>(p, acc);
#pragma unroll
    for (int i = 0; i < n_in(MODE); ++i) {
      const float* win0 = smem + (i * p.rows + row) * p.buf_floats
                          + lane * kR;
      if constexpr (KSZ > 0) {
        // the window as aligned 16-byte loads
        constexpr int W4 = (kR + KSZ - 1 + 3) / 4;
        float v[4 * W4];
#pragma unroll
        for (int j = 0; j < W4; ++j) {
          const float4 f = reinterpret_cast<const float4*>(win0)[j];
          v[4 * j] = f.x;
          v[4 * j + 1] = f.y;
          v[4 * j + 2] = f.z;
          v[4 * j + 3] = f.w;
        }
        auto win = [&v](int j) { return v[j]; };
        if (i == 0) convolve_input<MODE, KSZ, 0>(p, win, acc);
        if (i == 1) convolve_input<MODE, KSZ, 1>(p, win, acc);
        if (i == 2) convolve_input<MODE, KSZ, 2>(p, win, acc);
      } else {
        auto win = [win0](int j) { return win0[j]; };
        if (i == 0) convolve_input<MODE, KSZ, 0>(p, win, acc);
        if (i == 1) convolve_input<MODE, KSZ, 1>(p, win, acc);
        if (i == 2) convolve_input<MODE, KSZ, 2>(p, win, acc);
      }
    }
    if constexpr (MODE == kSingleEpi) {
      // the max of the outputs this thread holds that are stored
      const long long o = t / p.segs * p.rows + row;
      const int len = min(p.seg, p.out_n - static_cast<int>(t % p.segs)
                                             * p.seg);
      if (p.max_keys != nullptr && o < p.outer)
#pragma unroll
        for (int r = 0; r < kR; ++r)
          if (lane * kR + r < len) kmax = max(kmax, mad_max_key(acc[0][r]));
    }
#pragma unroll
    for (int k = 0; k < n_out(MODE); ++k) {
      float4* dst = reinterpret_cast<float4*>(
          staged + (k * p.rows + row) * cap + lane * kR);
#pragma unroll
      for (int j = 0; j < kR / 4; ++j)
        dst[j] = make_float4(result<MODE>(p, acc, k, 4 * j),
                             result<MODE>(p, acc, k, 4 * j + 1),
                             result<MODE>(p, acc, k, 4 * j + 2),
                             result<MODE>(p, acc, k, 4 * j + 3));
    }
  }
  __syncthreads();
  const long long o0 = t / p.segs * p.rows;
  const int s0 = static_cast<int>(t % p.segs) * p.seg;
  const int len = min(p.seg, p.out_n - s0);
  for (int r = 0; r < p.rows && o0 + r < p.outer; ++r) {
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
#pragma unroll
      for (int k = 0; k < n_out(MODE); ++k)
        p.out[k][(o0 + r) * p.out_n + s0 + j] =
            staged[(k * p.rows + r) * cap + j];
    }
  }
  if constexpr (MODE == kSingleEpi)
    if (p.max_keys != nullptr)
      merge_max(p, min(o0 + row, p.outer - 1), kmax);
}

// ---- launch ----------------------------------------------------------------

template <typename K>
cudaError_t run(K kernel, const Pass& p, int threads, size_t smem,
                cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  // shared memory before L1: the tiles are the reuse
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (p.tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(p.tiles), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE, int KSZ>
cudaError_t launch_mode(Pass& p, cudaStream_t stream) {
  constexpr int nin = n_in(MODE), nout = n_out(MODE);
  if (p.inner > 1) {
    p.a_tiles = (p.out_n + kTileA - 1) / kTileA;
    p.ta = (p.out_n + p.a_tiles - 1) / p.a_tiles;
    p.q_tiles = (p.inner + kQ - 1) / kQ;
    p.tiles = p.outer * p.a_tiles * p.q_tiles;
    // rows past ta are read by idle thread rows and never stored
    p.buf_floats = (kTileA + p.ksz - 1) * kQ;
    const size_t smem = sizeof(float) * nin * p.buf_floats;
    return run(conv_strided<MODE, KSZ>, p, kQ * kRows, smem, stream);
  }
  // equal segments of at most kMaxContig threads' outputs; then as many
  // rows a tile (up to 8) as keep the fewest of the block's threads idle
  p.segs = (p.out_n + kMaxContig * kR - 1) / (kMaxContig * kR);
  p.seg = (p.out_n + p.segs - 1) / p.segs;
  p.tpr = (p.seg + kR - 1) / kR;
  // a row's window: the last thread's, rounded up to whole 16-byte loads
  p.buf_floats = (p.tpr * kR + p.ksz - 1 + 7) / 4 * 4;
  const auto threads_for = [&](int rows) { return (rows * p.tpr + 31) / 32
                                                  * 32; };
  const auto smem_for = [&](int rows) {
    return sizeof(float) * rows * (nin * p.buf_floats
                                   + nout * p.tpr * kR);
  };
  p.rows = 1;
  for (int rows = 2; rows <= 8; ++rows) {
    if (threads_for(rows) > kMaxContig || smem_for(rows) > 96 * 1024) break;
    if (rows * p.tpr * threads_for(p.rows) > p.rows * p.tpr
        * threads_for(rows))
      p.rows = rows;
  }
  p.tiles = (p.outer + p.rows - 1) / p.rows * p.segs;
  return run(conv_contig<MODE, KSZ>, p, threads_for(p.rows),
             smem_for(p.rows), stream);
}

template <int MODE>
cudaError_t launch_taps(Pass& p, cudaStream_t stream) {
  switch (p.ksz) {
    case 17: return launch_mode<MODE, 17>(p, stream);
    case 11: if constexpr (single(MODE))
               return launch_mode<MODE, 11>(p, stream);
             break;
    case 9: if constexpr (single(MODE))
              return launch_mode<MODE, 9>(p, stream);
            break;
    case 5: if constexpr (single(MODE))
              return launch_mode<MODE, 5>(p, stream);
            break;
    default: break;
  }
  return launch_mode<MODE, 0>(p, stream);
}

void set_taps(Taps& t, const float* k, int ksz) {
  bool any = false;
  for (int m = 0; m < kMaxTaps; ++m) {
    t.w[m] = m < ksz ? k[ksz - 1 - m] : 0.0f;
    any = any || t.w[m] != 0.0f;
  }
  t.init = any ? -0.0f : 0.0f;
}

}  // namespace

// taps: host array of ksz float32 (copied into the kernel's parameters).
// div_keys, max_keys: null, or one uint32 order key per structure of
// outer_per_s outer rows (kSingleEpi's epilogues).
MAD_EXPORT int mad_conv1d(const float* in, float* out, const float* taps,
                          int ksz, long long outer, int n, int inner,
                          int out_n, int lo, const unsigned* div_keys,
                          unsigned* max_keys, long long outer_per_s,
                          cudaStream_t stream) {
  if (ksz < 1 || ksz > kMaxTaps || outer < 1 || n < 1 || inner < 1
      || outer_per_s < 1 || outer % outer_per_s != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Pass p{};
  p.in[0] = in;
  p.out[0] = out;
  set_taps(p.taps[0], taps, ksz);
  p.ksz = ksz;
  p.n = n;
  p.inner = inner;
  p.out_n = out_n;
  p.lo = lo;
  p.outer = outer;
  p.div_keys = div_keys;
  p.max_keys = max_keys;
  p.outer_per_s = outer_per_s;
  if (div_keys == nullptr && max_keys == nullptr)
    return static_cast<int>(launch_taps<kSingle>(p, stream));
  return static_cast<int>(launch_taps<kSingleEpi>(p, stream));
}

// One pass of the fused LoG of an (X, Y, Z) volume, 'same' mode: pass 0
// (x) reads in0 = vol and writes ax, bx; pass 1 (y) reads ax, bx and
// writes axy, a2y, bxy; pass 2 (z) reads axy, a2y, bxy and writes gauss,
// log. g0, g2: host arrays of ksz float32.
MAD_EXPORT int mad_log_pass(int pass, const float* in0, const float* in1,
                            const float* in2, float* out0, float* out1,
                            float* out2, const float* g0, const float* g2,
                            int ksz, int X, int Y, int Z, float s2,
                            cudaStream_t stream) {
  if (ksz < 1 || ksz > kMaxTaps || pass < 0 || pass > 2 || X < 1 || Y < 1
      || Z < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Pass p{};
  p.in[0] = in0;
  p.in[1] = in1;
  p.in[2] = in2;
  p.out[0] = out0;
  p.out[1] = out1;
  p.out[2] = out2;
  set_taps(p.taps[0], g0, ksz);
  set_taps(p.taps[1], g2, ksz);
  p.s2 = s2;
  p.ksz = ksz;
  p.lo = ksz / 2;
  const int dims[3] = {X, Y, Z};
  p.n = p.out_n = dims[pass];
  p.outer = pass == 0 ? 1 : (pass == 1 ? X : static_cast<long long>(X) * Y);
  p.inner = pass == 0 ? Y * Z : (pass == 1 ? Z : 1);
  cudaError_t err;
  if (pass == 0) err = launch_taps<kLogX>(p, stream);
  else if (pass == 1) err = launch_taps<kLogY>(p, stream);
  else err = launch_taps<kLogZ>(p, stream);
  return static_cast<int>(err);
}
