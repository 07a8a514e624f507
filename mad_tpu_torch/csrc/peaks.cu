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
// Offset form (capacity mode, detect.py:236-275 detect_shard): the volume
// is a block of E x-rows, of which rows [row0, row0 + rows) are the
// shard's own and the others its neighbours' halo, read only by the 3x3x3
// neighbourhood; x0 is the global row of own row 0, so the border test is
// in global coordinates. The index emitted is local to the own rows (the
// wrapper adds x0 * Y * Z in int64). The single-device call is row0 = 0,
// rows = E, x0 = 0.
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
                                  int Y, int Z, int row0, int rows, int x0,
                                  int rx, int ry, int rz, int border,
                                  float threshold,
                                  float* __restrict__ out_vals,
                                  int* __restrict__ out_idx,
                                  int* __restrict__ counter, int capacity) {
  const long long total = (long long)rows * Y * Z;
  const float* own = vol + (long long)row0 * Y * Z;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float v = own[i];
    if (!(v > threshold)) continue;
    const int z = (int)(i % Z);
    const int y = (int)((i / Z) % Y);
    const int x = row0 + (int)(i / ((long long)Y * Z));   // block row
    const int gx = x0 + x - row0;                          // global row
    if (gx < border || gx >= rx - border || y < border || y >= ry - border ||
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
                                     int row0, int rows, int x0, int rx,
                                     int ry, int rz, int border,
                                     float threshold, float* out_vals,
                                     int* out_idx, int* counter,
                                     int capacity, cudaStream_t stream) {
  const long long total = (long long)rows * Y * Z;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  peak_mask_compact<<<(unsigned)blocks, 256, 0, stream>>>(
      vol, X, Y, Z, row0, rows, x0, rx, ry, rz, border, threshold, out_vals,
      out_idx, counter, capacity);
  return static_cast<int>(cudaGetLastError());
}
