// K1: 1D convolution of a 3D float32 volume along one axis, zero padded,
// 'same' or 'full' output.
//
// Replaces mad_tpu/ops/convolve.py:79-124 (conv1d_along, the body of
// separable_conv3d / gaussian_filter3d / log_filter3d and of the
// simulator's 'full' blur, ops/simulate.py:86-112).
//
// The volume is viewed as (outer, n, inner) with the convolved axis in the
// middle; the output is (outer, out_n, inner) and
//   out[o, i, q] = sum_m taps[ksz-1-m] * in[o, i + m - lo, q]
// over in-range input rows, zero taps skipped, summed in m order with one
// rounding per multiply and per add -- the order of the shift-add in
// convolve.py:116-123, so the result matches the plain version bit for bit.
//
// Bound: device memory bandwidth. Each pass reads the volume and writes
// the output once (8 bytes a voxel); ksz <= 17 taps is ~2 flops a byte,
// far below the H100's compute roof. Design: every input element is read
// from device memory once per block through a shared-memory tile that
// holds the block's rows plus the ksz-1 halo, and neighbouring threads
// touch neighbouring addresses:
//   * inner == 1 (the contiguous axis): 256 threads along the axis, one
//     row segment of 256 outputs + halo per block;
//   * inner > 1 (strided axes): a 32-wide slab of the contiguous dimension
//     (coalesced loads) by 64 outputs along the axis, 8 rows of threads.
#include "common.cuh"

namespace {

constexpr int kInnerTile = 256;   // outputs per block, contiguous axis
constexpr int kSlabW = 32;        // contiguous width of a strided tile
constexpr int kSlabA = 64;        // outputs along the axis per strided tile
constexpr int kSlabRows = 8;      // thread rows of a strided tile

__global__ void conv_contig(const float* __restrict__ in,
                            float* __restrict__ out,
                            const float* __restrict__ taps, int ksz,
                            int n, int out_n, int lo, int tiles) {
  extern __shared__ float seg[];
  const long long o = blockIdx.x / tiles;
  const int i0 = (blockIdx.x % tiles) * kInnerTile;
  const float* row = in + o * n;
  const int span = kInnerTile + ksz - 1;
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const int idx = i0 - lo + j;
    seg[j] = (idx >= 0 && idx < n) ? row[idx] : 0.0f;
  }
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (i >= out_n) return;
  float acc = 0.0f;
  for (int m = 0; m < ksz; ++m) {
    const float w = taps[ksz - 1 - m];
    if (w != 0.0f) acc = add_rn(acc, mul_rn(w, seg[threadIdx.x + m]));
  }
  out[o * out_n + i] = acc;
}

__global__ void conv_strided(const float* __restrict__ in,
                             float* __restrict__ out,
                             const float* __restrict__ taps, int ksz,
                             int n, int inner, int out_n, int lo) {
  extern __shared__ float tile[];   // [(kSlabA + ksz - 1) * kSlabW]
  const long long o = blockIdx.z;
  const int a0 = blockIdx.y * kSlabA;
  const int q = blockIdx.x * kSlabW + threadIdx.x;
  const int span = kSlabA + ksz - 1;
  const float* src = in + o * (long long)n * inner;
  for (int r = threadIdx.y; r < span; r += kSlabRows) {
    const int idx = a0 - lo + r;
    tile[r * kSlabW + threadIdx.x] =
        (idx >= 0 && idx < n && q < inner) ? src[(long long)idx * inner + q]
                                           : 0.0f;
  }
  __syncthreads();
  if (q >= inner) return;
  float* dst = out + o * (long long)out_n * inner;
  for (int a = threadIdx.y; a < kSlabA; a += kSlabRows) {
    if (a0 + a >= out_n) break;
    float acc = 0.0f;
    for (int m = 0; m < ksz; ++m) {
      const float w = taps[ksz - 1 - m];
      if (w != 0.0f) acc = add_rn(acc, mul_rn(w, tile[(a + m) * kSlabW
                                                      + threadIdx.x]));
    }
    dst[(long long)(a0 + a) * inner + q] = acc;
  }
}

}  // namespace

MAD_EXPORT int mad_conv1d(const float* in, float* out, const float* taps,
                          int ksz, int outer, int n, int inner, int out_n,
                          int lo, cudaStream_t stream) {
  if (inner == 1) {
    const int tiles = (out_n + kInnerTile - 1) / kInnerTile;
    const size_t smem = (kInnerTile + ksz - 1) * sizeof(float);
    conv_contig<<<(unsigned)((long long)outer * tiles), kInnerTile, smem,
                  stream>>>(in, out, taps, ksz, n, out_n, lo, tiles);
  } else {
    dim3 grid((inner + kSlabW - 1) / kSlabW, (out_n + kSlabA - 1) / kSlabA,
              outer);
    dim3 block(kSlabW, kSlabRows);
    const size_t smem = (kSlabA + ksz - 1) * kSlabW * sizeof(float);
    conv_strided<<<grid, block, smem, stream>>>(in, out, taps, ksz, n,
                                                inner, out_n, lo);
  }
  return static_cast<int>(cudaGetLastError());
}
