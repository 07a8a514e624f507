// K9: mass-weighted trilinear scatter of atoms onto lattice-registered
// boxes, for a batch of structures in one launch.
//
// Replaces the scatter of mad_tpu/ops/simulate.py:86-102 and :126-141
// (grid.at[i0 + corner].add(w, mode="drop") over the 8 cell corners of
// every atom). One thread takes one (structure, atom): it computes the
// voxel-space position g = margin + (c - vox_min) / voxsp, the floor and
// the corner weights ((m * wx) * wy) * wz with IEEE division and products
// in the plain version's order, then adds each weight to its corner with
// an atomicAdd. A corner outside the box on any axis is dropped, as
// mode="drop" does; a zero-mass (padding) atom adds nothing.
//
// Bound: the atomics, 8 per atom into a few MB of grid (10^4-10^5 atoms a
// call on the main path), and the launch itself. The order in which the
// atomics land varies from run to run, so the grid's last bits do too;
// the values are the plain version's up to that order of f32 additions.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void scatter_atoms(const float* __restrict__ coords,
                              const float* __restrict__ masses,
                              const float* __restrict__ vox_min, int M,
                              int N, int X, int Y, int Z, float margin,
                              float voxsp, float* __restrict__ grids) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= static_cast<long long>(M) * N) return;
  const float m = masses[t];
  if (m == 0.0f) return;
  const int s = static_cast<int>(t / N);
  float w0[3], w1[3];
  int i0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = __fsub_rn(coords[3 * t + a], vox_min[3 * s + a]);
    const float g = __fadd_rn(margin, __fdiv_rn(d, voxsp));
    const float f = floorf(g);
    w1[a] = __fsub_rn(g, f);
    w0[a] = __fsub_rn(1.0f, w1[a]);
    i0[a] = static_cast<int>(f);
  }
  float* grid = grids + static_cast<long long>(s) * X * Y * Z;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int x = i0[0] + dx;
    if (x < 0 || x >= X) continue;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = i0[1] + dy;
      if (y < 0 || y >= Y) continue;
      const float wxy = mul_rn(mul_rn(m, dx ? w1[0] : w0[0]),
                               dy ? w1[1] : w0[1]);
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int z = i0[2] + dz;
        if (z < 0 || z >= Z) continue;
        atomicAdd(grid + (static_cast<long long>(x) * Y + y) * Z + z,
                  mul_rn(wxy, dz ? w1[2] : w0[2]));
      }
    }
  }
}

}  // namespace

MAD_EXPORT int mad_scatter_atoms(const float* coords, const float* masses,
                                 const float* vox_min, int M, int N, int X,
                                 int Y, int Z, float margin, float voxsp,
                                 float* grids, cudaStream_t stream) {
  const long long total = static_cast<long long>(M) * N;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  scatter_atoms<<<blocks, kThreads, 0, stream>>>(coords, masses, vox_min, M,
                                                 N, X, Y, Z, margin, voxsp,
                                                 grids);
  return static_cast<int>(cudaGetLastError());
}
