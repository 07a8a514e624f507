// K17: the CCC of each model grid against the map over the model's box.
//
// Replaces mad_tpu/engine/score.py:31-59 (_compiled_batched_ccc). Model m
// (bx, by, bz) has its (0, 0, 0) corner at map voxel starts[m], possibly
// outside the map. Over the box voxels inside the (X, Y, Z) map:
//   olap = sum(map * model), n1 = sum(map^2), n2 = sum(model^2),
//   ccc = olap / max(sqrt(n1 * n2), 1e-30).
// A voxel outside the map adds nothing to any of the three (mad_tpu's zero
// padding and in-map mask), so the kernel reads the unpadded map with
// bounds checks and no padded copy of it exists.
//
// Bound: bytes. Each in-map model voxel and its map voxel are read once
// (8 B a voxel: 1.7 GB for the bench's 10 models of 288x256x288); the
// three float64 products a voxel are far below the card's float64 rate.
// Design: a (blocks, models) grid; each block takes a contiguous range of
// the model's (x, y) rows and each warp one row at a time, its lanes along
// z, so a warp reads 128 contiguous bytes of the model and of the map; rows
// and z ranges outside the map are skipped, not read. Every thread sums in
// float64 in a fixed order and the block reduces by warp shuffles and
// shared memory; the (model, block) partial sums go to a buffer that a
// second launch (one block per model) reduces in the same fixed order. So
// the result does not change from run to run.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sum of v over the block (fixed order); the result is valid in thread 0.
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = red[0];
    for (int w = 1; w < kWarps; ++w) v = __dadd_rn(v, red[w]);
  }
  return v;
}

__global__ void ccc_partial(const float* __restrict__ map, int X, int Y,
                            int Z, const float* __restrict__ models, int bx,
                            int by, int bz, const int* __restrict__ starts,
                            int nblk, double* __restrict__ partial) {
  __shared__ double red[kWarps];
  const int m = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sx = starts[3 * m], sy = starts[3 * m + 1], sz = starts[3 * m + 2];
  const int rows = bx * by;
  const int per = (rows + nblk - 1) / nblk;
  const int r0 = blockIdx.x * per;
  const int r1 = min(rows, r0 + per);
  const int k0 = max(0, -sz), k1 = min(bz, Z - sz);
  const float* model = models + static_cast<long long>(m) * rows * bz;
  double olap = 0.0, n1 = 0.0, n2 = 0.0;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const int i = r / by, j = r - i * by;
    const int x = sx + i, y = sy + j;
    if (x < 0 || x >= X || y < 0 || y >= Y) continue;
    const float* mrow = model + static_cast<long long>(r) * bz;
    const float* srow = map + (static_cast<long long>(x) * Y + y) * Z + sz;
    for (int k = k0 + lane; k < k1; k += 32) {
      const double mv = static_cast<double>(mrow[k]);
      const double sv = static_cast<double>(srow[k]);
      olap = __dadd_rn(olap, __dmul_rn(sv, mv));
      n1 = __dadd_rn(n1, __dmul_rn(sv, sv));
      n2 = __dadd_rn(n2, __dmul_rn(mv, mv));
    }
  }
  olap = block_sum(olap, red);
  n1 = block_sum(n1, red);
  n2 = block_sum(n2, red);
  if (threadIdx.x == 0) {
    double* p = partial + (static_cast<long long>(m) * nblk + blockIdx.x) * 3;
    p[0] = olap;
    p[1] = n1;
    p[2] = n2;
  }
}

__global__ void ccc_finish(const double* __restrict__ partial, int nblk,
                           float* __restrict__ out) {
  __shared__ double red[kWarps];
  const int m = blockIdx.x;
  double s[3] = {0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < nblk; b += blockDim.x)
    for (int q = 0; q < 3; ++q)
      s[q] = __dadd_rn(s[q], partial[(static_cast<long long>(m) * nblk + b) *
                                     3 + q]);
  for (int q = 0; q < 3; ++q) s[q] = block_sum(s[q], red);
  if (threadIdx.x == 0)
    out[m] = static_cast<float>(s[0] / fmax(sqrt(s[1] * s[2]), 1e-30));
}

}  // namespace

// map (X, Y, Z) f32; models (M, bx, by, bz) f32; starts (M, 3) int32;
// partial (M, nblk, 3) f64 scratch; out (M) f32.
MAD_EXPORT int mad_batched_ccc(const float* map, int X, int Y, int Z,
                               const float* models, int M, int bx, int by,
                               int bz, const int* starts, int nblk,
                               double* partial, float* out,
                               cudaStream_t stream) {
  if (M <= 0) return 0;
  ccc_partial<<<dim3(nblk, M), kThreads, 0, stream>>>(
      map, X, Y, Z, models, bx, by, bz, starts, nblk, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ccc_finish<<<M, kThreads, 0, stream>>>(partial, nblk, out);
  return static_cast<int>(cudaGetLastError());
}
