// K11: occupancy of the map anchors, dilated by a voxel sphere.
//
// Replaces mad_tpu/engine/match.py:94-117 (_field_body). The field
// (X, Y, Z) int8 is 1 at every voxel within r voxels of an anchor voxel
// (dx^2 + dy^2 + dz^2 <= r^2), 0 elsewhere. The JAX body ORs the shifted
// occupancy once per sphere offset (123 volume passes at r = 3); here the
// field is cleared once and each (anchor, cube offset) thread writes its
// voxel. All writers write the same byte 1, so no atomics are needed and
// the result is exact.
//
// Bound: bytes, the field written once (X * Y * Z bytes: 19.7 MB at the
// bench, 5.9 us at 3.35 TB/s); the sphere writes are A * 123 bytes on top,
// scattered but few (tens of KB).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void anchor_field(const int* __restrict__ lo_vox, int A, int X,
                             int Y, int Z, int r,
                             signed char* __restrict__ field) {
  const int side = 2 * r + 1;
  const int cube = side * side * side;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (t >= static_cast<long long>(A) * cube) return;
  const int a = static_cast<int>(t / cube);
  const int o = static_cast<int>(t % cube);
  const int dx = o / (side * side) - r;
  const int dy = (o / side) % side - r;
  const int dz = o % side - r;
  if (dx * dx + dy * dy + dz * dz > r * r) return;
  const int x = lo_vox[3 * a] + dx;
  const int y = lo_vox[3 * a + 1] + dy;
  const int z = lo_vox[3 * a + 2] + dz;
  if (x < 0 || x >= X || y < 0 || y >= Y || z < 0 || z >= Z) return;
  field[(static_cast<long long>(x) * Y + y) * Z + z] = 1;
}

}  // namespace

// lo_vox (A, 3) int32 anchor voxels; field (X, Y, Z) int8, written whole.
MAD_EXPORT int mad_anchor_field(const int* lo_vox, int A, int X, int Y,
                                int Z, int r, signed char* field,
                                cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      field, 0, static_cast<size_t>(X) * Y * Z, stream);
  if (err != cudaSuccess || A == 0) return static_cast<int>(err);
  const int side = 2 * r + 1;
  const long long n = static_cast<long long>(A) * side * side * side;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  anchor_field<<<blocks, kThreads, 0, stream>>>(lo_vox, A, X, Y, Z, r,
                                                 field);
  return static_cast<int>(cudaGetLastError());
}
