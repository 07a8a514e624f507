// K4: LoG peak mask + compaction.
//
// Replaces mad_tpu/ops/detect.py:48-52 and 190-212 (_maxpool3 and the
// is_peak / top_k part of detect_counts): a voxel is a peak when it
//   * equals the maximum of its 3x3x3 neighbourhood (the neighbourhood is
//     clipped at the volume edge, as reduce_window's -inf SAME padding),
//   * is above threshold,
//   * lies at least `border` voxels inside the real extent (rx, ry, rz).
// Each peak is appended as (value, flat index) through one atomic counter;
// the wrapper sorts the survivors by (-value, index), which is the exact
// top-k of detect.py with its flat-index tie order.
//
// Bound: one read of the LoG volume (4 bytes a voxel; the 26 neighbour
// reads hit L1/L2). Design: the threshold and border tests run first, so
// only the few voxels above threshold pay the neighbourhood reads; one
// grid-stride pass, no intermediate max-pooled volume in device memory
// (the plain version writes one), and the survivors -- a few thousand of
// 10^8 voxels -- are the only output.
#include "common.cuh"

namespace {

__global__ void peak_mask_compact(const float* __restrict__ vol, int X,
                                  int Y, int Z, int rx, int ry, int rz,
                                  int border, float threshold,
                                  float* __restrict__ out_vals,
                                  int* __restrict__ out_idx,
                                  int* __restrict__ counter, int capacity) {
  const long long total = (long long)X * Y * Z;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float v = vol[i];
    if (!(v > threshold)) continue;
    const int z = (int)(i % Z);
    const int y = (int)((i / Z) % Y);
    const int x = (int)(i / ((long long)Y * Z));
    if (x < border || x >= rx - border || y < border || y >= ry - border ||
        z < border || z >= rz - border)
      continue;
    float m = v;
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= X) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= Y) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int zz = z + dz;
          if (zz < 0 || zz >= Z) continue;
          m = fmaxf(m, vol[((long long)xx * Y + yy) * Z + zz]);
        }
      }
    }
    if (v >= m) {
      const int slot = atomicAdd(counter, 1);
      if (slot < capacity) {
        out_vals[slot] = v;
        out_idx[slot] = (int)i;
      }
    }
  }
}

}  // namespace

MAD_EXPORT int mad_peak_mask_compact(const float* vol, int X, int Y, int Z,
                                     int rx, int ry, int rz, int border,
                                     float threshold, float* out_vals,
                                     int* out_idx, int* counter,
                                     int capacity, cudaStream_t stream) {
  const long long total = (long long)X * Y * Z;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  peak_mask_compact<<<(unsigned)blocks, 256, 0, stream>>>(
      vol, X, Y, Z, rx, ry, rz, border, threshold, out_vals, out_idx,
      counter, capacity);
  return static_cast<int>(cudaGetLastError());
}
