// K9: mass-weighted trilinear scatter of atoms onto lattice-registered
// boxes, for a batch of structures, deterministic and in mad_tpu's order.
//
// Replaces the scatter of mad_tpu/ops/simulate.py:86-102 and :126-141
// (grid.at[i0 + corner].add(w, mode="drop") over the 8 cell corners of
// every atom): eight scatters, one per corner in the dx, dy, dz loop order,
// each over the atoms in index order. A voxel's value is therefore the
// float32 sum, from 0, of its contributions in (corner, atom) order. The
// kernels give exactly that sum, with no float atomics:
//   1. count: one thread per (structure, atom) computes the voxel-space
//      position g = margin + (c - vox_min) / voxsp and its floor cell, and
//      counts the atom in its (structure, cell) bucket with an int32
//      atomic (its slot in the bucket is the atomic's return value). Cells
//      run over [-1, X-1] on each axis: an atom outside that range, or of
//      zero mass, reaches no voxel of the box and is dropped;
//   2. scan: an exclusive scan of the counts (chunk sums, their scan, the
//      chunks' scans, each staged in shared memory for coalesced loads)
//      gives each bucket's start;
//   3. fill: each atom writes its index at its bucket's start + slot;
//   4. gather: one thread per run of kRun = 2 voxels along z reads the
//      starts of the 4 x (kRun + 2) buckets its voxels share once (a run
//      whose buckets are all empty writes zeros), then for each voxel
//      visits the cells v - corner in corner order, takes each
//      bucket's atoms in ascending index (selected in order from the few a
//      bucket holds; the fill order does not matter), recomputes each
//      weight ((m * wx) * wy) * wz with IEEE division and products in the
//      plain version's order, and adds it in that order.
// Integer counts are exact in any order, so the grid is the same in every
// run and equal to the plain version's (kernels/scatter.py) bit for bit.
//
// Bound: bytes. The grids are written once; the buckets' counts and starts
// (one int32 a cell, about the grid's size) are zeroed, counted, scanned
// (read twice, written once) and read by the gather: some five times the
// grid's bytes, the price of the fixed order against one atomic add per
// corner before. (Buckets by (x, y) column of cells, ordered by cell z,
// need no cell-sized array, but their gather walks each column's atoms in
// a chain of dependent loads, which measured slower on the bench models'
// batch.)
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanItems = 16;                       // per thread
constexpr int kScanChunk = kThreads * kScanItems;    // per block
constexpr int kSumThreads = 1024;
constexpr int kRun = 2;        // consecutive z voxels a gather thread sums

struct Box {
  int M, N, X, Y, Z;
  float margin, voxsp;
  long long cells;          // (X + 1) * (Y + 1) * (Z + 1) buckets a structure
};

// Voxel-space floor and corner weights of atom t (of structure s) on one
// axis a: the plain version's arithmetic.
__device__ __forceinline__ float axis_pos(const float* __restrict__ coords,
                                          const float* __restrict__ vox_min,
                                          long long t, int s, int a,
                                          const Box& b, float* w0,
                                          float* w1) {
  const float d = __fsub_rn(coords[3 * t + a], vox_min[3 * s + a]);
  const float g = __fadd_rn(b.margin, __fdiv_rn(d, b.voxsp));
  const float f = floorf(g);
  *w1 = __fsub_rn(g, f);
  *w0 = __fsub_rn(1.0f, *w1);
  return f;
}

__global__ void count_cells(const float* __restrict__ coords,
                            const float* __restrict__ masses,
                            const float* __restrict__ vox_min, Box b,
                            int* __restrict__ counts,
                            long long* __restrict__ cell_of,
                            int* __restrict__ slot) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= static_cast<long long>(b.M) * b.N) return;
  const int s = static_cast<int>(t / b.N);
  const int dims[3] = {b.X, b.Y, b.Z};
  long long cell = 0;
  bool keep = masses[t] != 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float w0, w1;
    const float f = axis_pos(coords, vox_min, t, s, a, b, &w0, &w1);
    // the floor cell in [-1, dim - 1] (NaN fails both tests)
    keep = keep && f >= -1.0f && f <= static_cast<float>(dims[a] - 1);
    cell = cell * (dims[a] + 1) + (keep ? static_cast<int>(f) + 1 : 0);
  }
  if (!keep) {
    slot[t] = -1;
    return;
  }
  cell += s * b.cells;
  cell_of[t] = cell;
  slot[t] = atomicAdd(counts + cell, 1);
}

// Block-wide exclusive scan of one int a thread; returns the block total.
__device__ __forceinline__ int block_exclusive(int v, int* excl) {
  __shared__ int warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  if (warp == 0) {
    int w = lane < nw ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < nw) warp_tot[lane] = w;       // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_tot[warp - 1];
  const int total = warp_tot[nw - 1];
  *excl = before + inc - v;
  __syncthreads();                           // warp_tot reused next call
  return total;
}

__global__ void chunk_sums(const int* __restrict__ counts, long long n,
                           int* __restrict__ sums) {
  // an integer sum: any order, so the loads go in coalesced order
  const long long base = blockIdx.x * static_cast<long long>(kScanChunk);
  int v = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const long long j = base + i * kThreads + threadIdx.x;
    if (j < n) v += counts[j];
  }
  int excl;
  const int total = block_exclusive(v, &excl);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: exclusive scan of the chunk sums in place.
__global__ void scan_sums(int* __restrict__ sums, int nb) {
  int carry = 0;
  for (int i0 = 0; i0 < nb; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int v = i < nb ? sums[i] : 0;
    int excl;
    const int total = block_exclusive(v, &excl);
    if (i < nb) sums[i] = carry + excl;
    carry += total;
  }
}

// The chunk staged in shared memory so that the global loads and stores
// are coalesced while each thread scans kScanItems consecutive counts
// (a padding word every 32 keeps the thread's reads off one bank).
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__global__ void scan_chunks(int* __restrict__ counts, long long n,
                            const int* __restrict__ sums) {
  __shared__ int chunk[kScanChunk + kScanChunk / 32];
  const long long base = blockIdx.x * static_cast<long long>(kScanChunk);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    chunk[padded(k)] = base + k < n ? counts[base + k] : 0;
  }
  __syncthreads();
  int v[kScanItems], tot = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = chunk[padded(threadIdx.x * kScanItems + i)];
    tot += v[i];
  }
  int run;
  block_exclusive(tot, &run);
  run += sums[blockIdx.x];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    chunk[padded(threadIdx.x * kScanItems + i)] = run;
    run += v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    if (base + k < n) counts[base + k] = chunk[padded(k)];
  }
}

__global__ void fill_buckets(const long long* __restrict__ cell_of,
                             const int* __restrict__ slot,
                             const int* __restrict__ start, long long total,
                             int* __restrict__ ids) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= total || slot[t] < 0) return;
  ids[start[cell_of[t]] + slot[t]] = static_cast<int>(t);
}

// Atom t's weight at corner (dx, dy, dz): the plain version's arithmetic.
__device__ __forceinline__ float corner_weight(
    const float* __restrict__ coords, const float* __restrict__ masses,
    const float* __restrict__ vox_min, int t, int s, const Box& b, int dx,
    int dy, int dz) {
  float w0, w1;
  axis_pos(coords, vox_min, t, s, 0, b, &w0, &w1);
  const float wx = dx ? w1 : w0;
  axis_pos(coords, vox_min, t, s, 1, b, &w0, &w1);
  const float wy = dy ? w1 : w0;
  axis_pos(coords, vox_min, t, s, 2, b, &w0, &w1);
  const float wz = dz ? w1 : w0;
  return mul_rn(mul_rn(mul_rn(masses[t], wx), wy), wz);
}

// Add the atoms of bucket [beg, end) at corner (dx, dy, dz) to acc, in
// ascending atom index (selected in order from the few a bucket holds).
__device__ __forceinline__ float add_bucket(
    float acc, const float* __restrict__ coords,
    const float* __restrict__ masses, const float* __restrict__ vox_min,
    const int* __restrict__ ids, int beg, int end, int s, const Box& b,
    int dx, int dy, int dz) {
  int last = -1;
  for (int k = beg; k < end; ++k) {
    int t = 0x7fffffff;
    for (int j = beg; j < end; ++j) {
      const int id = ids[j];
      if (id > last && id < t) t = id;
    }
    last = t;
    acc = add_rn(acc, corner_weight(coords, masses, vox_min, t, s, b, dx, dy,
                                    dz));
  }
  return acc;
}

__global__ void gather_voxels(const float* __restrict__ coords,
                              const float* __restrict__ masses,
                              const float* __restrict__ vox_min, Box b,
                              const int* __restrict__ start,
                              const int* __restrict__ ids,
                              float* __restrict__ grids) {
  // one structure a grid row, kRun voxels along z a thread: the four
  // (dx, dy) columns of cells hold the starts of all their buckets in
  // kRun + 2 consecutive entries
  const int runs = (b.Z + kRun - 1) / kRun;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= b.X * b.Y * runs) return;
  const int s = blockIdx.y;
  const int z0 = (v % runs) * kRun, r = v / runs;
  const int y = r % b.Y, x = r / b.Y;
  const int* st = start + s * b.cells;
  int col[4][kRun + 2];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int* cs = st + ((x - (c >> 1) + 1) * (b.Y + 1) + (y - (c & 1) + 1))
                             * (b.Z + 1);
#pragma unroll
    for (int j = 0; j < kRun + 2; ++j)  // bucket z index z0 + j, or the end
      col[c][j] = cs[min(z0 + j, b.Z + 1)];
  }
  // most runs lie where no atom is: their buckets are all empty
  bool any = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) any = any || col[c][kRun + 1] != col[c][0];
  float* out = grids + (static_cast<long long>(s) * b.X * b.Y
                        + static_cast<long long>(x) * b.Y + y) * b.Z;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int z = z0 + i;
    if (z >= b.Z) break;
    float acc = 0.0f;
    if (any)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        // the cell at z - dz: bucket z index z0 + i + 1 - dz
        acc = add_bucket(acc, coords, masses, vox_min, ids,
                         col[c][i + 1 - dz], col[c][i + 2 - dz], s, b,
                         c >> 1, c & 1, dz);
    }
    out[z] = acc;
  }
}

unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// Scratch from the caller, cells = (X + 1) * (Y + 1) * (Z + 1): counts
// (M * cells + 1 int32, zeroed), sums (ceil((M * cells + 1) / 4096)
// int32), cell_of (M * N int64), slot and ids (M * N int32 each).
MAD_EXPORT int mad_scatter_atoms(const float* coords, const float* masses,
                                 const float* vox_min, int M, int N, int X,
                                 int Y, int Z, float margin, float voxsp,
                                 int* counts, int* sums, long long* cell_of,
                                 int* slot, int* ids, float* grids,
                                 cudaStream_t stream) {
  const long long atoms = static_cast<long long>(M) * N;
  const Box b{M, N, X, Y, Z, margin, voxsp,
              static_cast<long long>(X + 1) * (Y + 1) * (Z + 1)};
  const long long n = M * b.cells + 1;
  const long long nb = (n + kScanChunk - 1) / kScanChunk;
  const long long runs = static_cast<long long>(X) * Y * ((Z + kRun - 1)
                                                          / kRun);
  if (atoms > 0x7fffffffLL || nb > 0x7fffffffLL || b.cells >= 0x7fffffffLL
      || runs > 0x7fffffffLL || M > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (atoms > 0)
    count_cells<<<blocks_for(atoms, kThreads), kThreads, 0, stream>>>(
        coords, masses, vox_min, b, counts, cell_of, slot);
  chunk_sums<<<static_cast<unsigned>(nb), kThreads, 0, stream>>>(counts, n,
                                                                 sums);
  scan_sums<<<1, kSumThreads, 0, stream>>>(sums, static_cast<int>(nb));
  scan_chunks<<<static_cast<unsigned>(nb), kThreads, 0, stream>>>(counts, n,
                                                                  sums);
  if (atoms > 0)
    fill_buckets<<<blocks_for(atoms, kThreads), kThreads, 0, stream>>>(
        cell_of, slot, counts, atoms, ids);
  if (runs > 0 && M > 0)
    gather_voxels<<<dim3(blocks_for(runs, kThreads), M), kThreads, 0,
                    stream>>>(coords, masses, vox_min, b, counts, ids, grids);
  return static_cast<int>(cudaGetLastError());
}
