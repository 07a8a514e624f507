// K18: pairwise occupancy overlap fractions of docking solutions.
//
// Replaces mad_tpu/engine/assemble.py:123-166 (_compiled_pack_overlap).
// Three kernels on one stream:
//   (a) pack: one warp per (solution, x, y, word) of the common frame; lane
//       b reads voxel z = 32 * word + b of the solution's box placed at its
//       lattice offset, and __ballot_sync of (density > 0) is the packed
//       word, bit b = z mod 32, as the JAX body's shift-and-sum packs it;
//   (b) counts: one block per pair i <= j sums __popc(a & b) over the two
//       packed rows into an int32 count;
//   (c) fractions: ov[i, j] = f32(count) / f32(max(count[i, i], 1)) with an
//       IEEE division, 0 where count[i, i] == 0, upper triangle (k = 1).
//
// Bound: memory. The packed frame is m * FX * FY * FZ / 32 words (a few MB
// on the main path: 16 solutions in a ~150^3 frame), one read of the
// density boxes packs it, and the pair pass reads each row about m / 2
// times, mostly from L2. The (m, X, Y, Z) frame of booleans never exists.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void pack_rows(const float* __restrict__ dens,
                          const int* __restrict__ offsets, int m, int X,
                          int Y, int Z, int FX, int FY, int W,
                          uint32_t* __restrict__ packed) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x)
                          + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_words = static_cast<long long>(m) * FX * FY * W;
  if (warp >= n_words) return;            // whole warps leave together
  const int w = static_cast<int>(warp % W);
  long long rest = warp / W;
  const int fy = static_cast<int>(rest % FY);
  rest /= FY;
  const int fx = static_cast<int>(rest % FX);
  const int s = static_cast<int>(rest / FX);
  const int x = fx - offsets[3 * s];
  const int y = fy - offsets[3 * s + 1];
  const int z = 32 * w + lane - offsets[3 * s + 2];
  bool occ = false;
  if (x >= 0 && x < X && y >= 0 && y < Y && z >= 0 && z < Z)
    occ = dens[((static_cast<long long>(s) * X + x) * Y + y) * Z + z] > 0.0f;
  const uint32_t word = __ballot_sync(0xffffffffu, occ);
  if (lane == 0) packed[warp] = word;
}

__global__ void pair_counts(const uint32_t* __restrict__ packed,
                            long long L, int m, int* __restrict__ counts) {
  const int i = blockIdx.y, j = blockIdx.x;
  if (j < i) return;
  const uint32_t* a = packed + i * L;
  const uint32_t* b = packed + j * L;
  int c = 0;
  for (long long w = threadIdx.x; w < L; w += blockDim.x)
    c += __popc(a[w] & b[w]);
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xffffffffu, c, d);
  __shared__ int part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) total += part[k];
    counts[i * m + j] = total;
  }
}

__global__ void fractions(const int* __restrict__ counts, int m,
                          float* __restrict__ ov) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * m) return;
  const int i = t / m, j = t % m;
  const int d = counts[i * m + i];
  float v = 0.0f;
  if (j > i && d != 0)
    v = __fdiv_rn(static_cast<float>(counts[t]),
                  static_cast<float>(d > 1 ? d : 1));
  ov[t] = v;
}

}  // namespace

// dens (m, X, Y, Z) f32; offsets (m, 3) int32 lattice offsets in the frame;
// frame FX x FY x 32 W voxels; packed (m, FX * FY * W) uint32 scratch;
// counts (m, m) int32 scratch, zeroed by the caller; ov (m, m) f32 out.
MAD_EXPORT int mad_pack_overlap(const float* dens, const int* offsets, int m,
                                int X, int Y, int Z, int FX, int FY, int W,
                                uint32_t* packed, int* counts, float* ov,
                                cudaStream_t stream) {
  if (m == 0) return 0;
  const long long n_words = static_cast<long long>(m) * FX * FY * W;
  const long long pack_threads = n_words * 32;
  pack_rows<<<static_cast<unsigned>((pack_threads + kThreads - 1) / kThreads),
              kThreads, 0, stream>>>(dens, offsets, m, X, Y, Z, FX, FY, W,
                                     packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_counts<<<dim3(m, m), kThreads, 0, stream>>>(
      packed, static_cast<long long>(FX) * FY * W, m, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fractions<<<(m * m + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      counts, m, ov);
  return static_cast<int>(cudaGetLastError());
}
