// K9: mass-weighted trilinear scatter of atoms onto lattice-registered
// boxes, for a batch of structures, deterministic and in mad_tpu's order;
// with the per-structure max of the grids, and the simulation body's
// closing scale-and-clamp pass.
//
// Replaces the scatter of mad_tpu/ops/simulate.py:86-102 and :126-141
// (grid.at[i0 + corner].add(w, mode="drop") over the 8 cell corners of
// every atom): eight scatters, one per corner in the dx, dy, dz loop order,
// each over the atoms in index order. A voxel's value is therefore the
// float32 sum, from 0, of its contributions in (corner, atom) order. The
// kernels give exactly that sum, with no float atomics, and size their
// bookkeeping to the atoms, not to the grid:
//   1. bin: one thread per (structure, atom) computes the voxel-space
//      position g = margin + (c - vox_min) / voxsp, its floor cell and the
//      corner weights' w1 = g - floor(g) (kept for step 4), and counts the
//      atom in the bin of its shifted cell c + 1 (cells run over [-1,
//      X-1] on each axis; an atom outside that range, or of zero mass,
//      reaches no voxel of the box and is dropped). A bin is a voxel
//      tile's worth of cells, kTX x kTY x kTZ: one int32 a tile, not a
//      cell (the slot in the bin is the int32 atomic's return value);
//   2. scan: an exclusive scan of the bin counts (chunk sums, their scan,
//      the chunks' scans, each staged in shared memory for coalesced
//      loads) gives each bin's start;
//   3. fill: each atom writes its index and packed cell at its bin's
//      start + slot;
//   4. tiles: a persistent grid walks the kTX x kTY x kTZ voxel tiles,
//      a block a tile at a time. A voxel v takes terms from the cells v
//      and v - 1 on each axis, so a tile reads its own bin and its upper
//      neighbours' (8 bins, their sizes summed by a warp). A tile whose
//      bins are empty streams zeros with no barrier, each warp on its own
//      (there is no memset of the grids). Otherwise the block keeps the
//      atoms whose cell it needs as 64-bit keys (local cell, atom index)
//      in shared memory and marks their cells in a 64-bit mask per column
//      of cells along z. The fill's
//      slots come in whatever order the atomics gave; a sort of the keys
//      restores the fixed order (one warp in registers up to 32 keys, a
//      block bitonic sort up to kCap), and each candidate's (m, w1) is
//      staged beside its key. Each thread sums kVec consecutive z voxels
//      of a row (kVec voxels whose four columns hold no cell near them
//      are zero at once): per voxel the cells v - corner in corner order,
//      a cell found by its mask bit and a binary search of the keys, its
//      atoms in ascending index, each weight ((m * wx) * wy) * wz rounded as the
//      plain version rounds it; the kVec sums go out as one 16-byte
//      store. A tile with more candidates than shared memory holds sorts
//      them in a region of a global pool and walks them there: the same
//      code, the same bits, slower. Each block also reduces the max of
//      the voxels it wrote and merges it into its structure's max with an
//      integer atomicMax on an order key of the float's bits
//      (common.cuh), so the max is the same in any order, and NaN wins
//      as it does in torch.amax.
// Integer counts are exact in any order, so the grid is the same in every
// run and equal to the plain version's (kernels/scatter.py) bit for bit.
//
// The closing pass (mad_simulate_scale) divides each voxel of the blurred
// batch by max(its structure's max, 1e-30) and, when the isovalue is set,
// zeroes values below it (mad_tpu/ops/simulate.py:104-107), in place.
//
// Bound: bytes: the atoms read and the grids written once. The tile
// bookkeeping is one int32 a bin (some 122 K for the bench models' batch,
// against 215 M cells before), the atoms' bins, slots, indices, cells
// and weights (44 bytes an atom), and the pool (16 keys an atom, touched
// only by crowded tiles). The tiles with atoms (15 % of the models'
// batch's) cost a gather, a sort and a search each; they overlap the
// zeros the other blocks stream. The closing pass reads and writes the
// blurred volume once.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanItems = 16;                       // per thread
constexpr int kScanChunk = kThreads * kScanItems;    // per block
constexpr int kSumThreads = 1024;
// a voxel tile; z is the contiguous axis (a row of kTZ floats, 128 bytes)
constexpr int kTX = 8, kTY = 8, kTZ = 32;
// the cells a tile reads: kT + 1 on each axis (local cell = c + 1 - x0)
constexpr int kCX = kTX + 1, kCY = kTY + 1, kCZ = kTZ + 1;
constexpr int kCells = kCX * kCY * kCZ;
constexpr int kCap = 1024;     // candidates a tile sorts in shared memory
constexpr int kVec = 4;        // z voxels a thread sums (one 16-byte store)
constexpr int kRowThreads = kTZ / kVec;
constexpr int kRowsPerPass = kThreads / kRowThreads;
constexpr int kPasses = kTX * kTY / kRowsPerPass;
constexpr unsigned long long kNoKey = ~0ull;
constexpr int kCoordBits = 21;  // a shifted cell coordinate in cell_of
constexpr unsigned long long kCoordMask = (1ull << kCoordBits) - 1;

struct Box {
  int M, N, X, Y, Z;
  float margin, voxsp;
  int bx, by, bz;        // bins per axis: ceil(dim / tile) + 1
  int tx, ty, tz;        // tiles per axis: ceil(dim / tile)
  long long bins;        // bins a structure
  long long tiles;       // tiles a structure
};

// Voxel-space floor and corner weights of atom t (of structure s) on one
// axis a: the plain version's arithmetic.
__device__ __forceinline__ float axis_pos(const float* __restrict__ coords,
                                          const float* __restrict__ vox_min,
                                          long long t, int s, int a,
                                          const Box& b, float* w1) {
  const float d = __fsub_rn(coords[3 * t + a], vox_min[3 * s + a]);
  const float g = __fadd_rn(b.margin, __fdiv_rn(d, b.voxsp));
  const float f = floorf(g);
  *w1 = __fsub_rn(g, f);
  return f;
}

__global__ void bin_atoms(const float* __restrict__ coords,
                          const float* __restrict__ masses,
                          const float* __restrict__ vox_min, Box b,
                          int* __restrict__ counts, int* __restrict__ bin_of,
                          int* __restrict__ slot,
                          unsigned long long* __restrict__ cell_of,
                          float4* __restrict__ atom_w) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= static_cast<long long>(b.M) * b.N) return;
  const int s = static_cast<int>(t / b.N);
  const int dims[3] = {b.X, b.Y, b.Z};
  int c[3];
  float w1[3];
  bool keep = masses[t] != 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = axis_pos(coords, vox_min, t, s, a, b, &w1[a]);
    // the floor cell in [-1, dim - 1] (NaN fails both tests)
    keep = keep && f >= -1.0f && f <= static_cast<float>(dims[a] - 1);
    c[a] = keep ? static_cast<int>(f) + 1 : 0;     // shifted: [0, dim]
  }
  if (!keep) {
    slot[t] = -1;
    return;
  }
  const long long bin = s * b.bins
                        + (static_cast<long long>(c[0] / kTX) * b.by
                           + c[1] / kTY) * b.bz + c[2] / kTZ;
  bin_of[t] = static_cast<int>(bin);
  cell_of[t] = (static_cast<unsigned long long>(c[0]) << (2 * kCoordBits))
               | (static_cast<unsigned long long>(c[1]) << kCoordBits)
               | static_cast<unsigned long long>(c[2]);
  atom_w[t] = make_float4(masses[t], w1[0], w1[1], w1[2]);
  slot[t] = atomicAdd(counts + bin, 1);
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

// Each atom's index and packed cell at its bin's start + slot.
__global__ void fill_bins(const int* __restrict__ bin_of,
                          const int* __restrict__ slot,
                          const unsigned long long* __restrict__ cell_of,
                          const int* __restrict__ start, long long total,
                          int* __restrict__ ids,
                          unsigned long long* __restrict__ ent_cell) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= total || slot[t] < 0) return;
  const int at = start[bin_of[t]] + slot[t];
  ids[at] = static_cast<int>(t);
  ent_cell[at] = cell_of[t];
}

constexpr int kColumns = kCX * kCY;     // columns of cells along z
static_assert(kCZ <= 64, "a column's cells must fit one 64-bit mask");

struct TileSmem {
  float4 w[kCap];                       // sorted candidates' (m, w1)
  unsigned long long keys[kCap];        // (local cell << 32) | atom
  unsigned long long column[kColumns];  // bit z: cell (x, y, z) is held
  int n, n_pool;
  long long pool_off;
};

__device__ __forceinline__ int pow2_at_least(int n) {
  int S = 1;
  while (S < n) S <<= 1;
  return S;
}

// Lane q < 8 of every warp: the range in ids of bin q of the tile (its
// own, then its upper neighbours'); returns the atoms the 8 bins hold.
__device__ __forceinline__ int bin_range(const int* __restrict__ start,
                                         const Box& b, int s, int tx, int ty,
                                         int tz, int* beg, int* cnt) {
  const int q = threadIdx.x & 7;
  const long long bin = s * b.bins
                        + (static_cast<long long>(tx + (q >> 2)) * b.by
                           + ty + ((q >> 1) & 1)) * b.bz + tz + (q & 1);
  const bool mine = (threadIdx.x & 31) < 8;
  *beg = mine ? __ldg(start + bin) : 0;
  *cnt = mine ? __ldg(start + bin + 1) - *beg : 0;
  return __reduce_add_sync(0xffffffffu, *cnt);
}

// Append the atoms of the 8 bins whose cell the tile needs as (local
// cell, atom) keys at keys[atomicAdd(count)], those below cap, and mark
// their cells in the column masks when they are given. The 8 ranges
// (lanes 0-7's beg, cnt) are walked as one range of raw entries.
__device__ __forceinline__ void gather_candidates(
    int beg, int cnt, int raw, const int* __restrict__ ids,
    const unsigned long long* __restrict__ ent_cell, int x0, int y0, int z0,
    unsigned long long* keys, int* count, int cap,
    unsigned long long* column) {
  int b8[8], c8[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    b8[q] = __shfl_sync(0xffffffffu, beg, q);
    c8[q] = __shfl_sync(0xffffffffu, cnt, q);
  }
  for (int k = threadIdx.x; k < raw; k += blockDim.x) {
    int rest = k, at = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (rest >= 0 && rest < c8[q]) at = b8[q] + rest;
      rest -= c8[q];
    }
    const unsigned long long c = ent_cell[at];
    const int lx = static_cast<int>(c >> (2 * kCoordBits)) - x0;
    const int ly = static_cast<int>((c >> kCoordBits) & kCoordMask) - y0;
    const int lz = static_cast<int>(c & kCoordMask) - z0;
    if (lx < 0 || lx > kTX || ly < 0 || ly > kTY || lz < 0 || lz > kTZ)
      continue;
    const int cell = (lx * kCY + ly) * kCZ + lz;
    const int i = atomicAdd(count, 1);
    if (i < cap)
      keys[i] = (static_cast<unsigned long long>(cell) << 32)
                | static_cast<unsigned>(ids[at]);
    if (column != nullptr) atomicOr(column + lx * kCY + ly, 1ull << lz);
  }
}

// One voxel's sum: the cells v - corner in corner order, each cell's
// atoms in ascending index, found by a binary search of the n sorted keys
// where the cell's bit is set in its column's mask (col[dx][dy], the
// columns of (lx + 1 - dx, ly + 1 - dy)). W(k): the k-th sorted
// candidate's (m, w1).
template <class Weights>
__device__ __forceinline__ float voxel_sum(
    const unsigned long long (&col)[2][2], const unsigned long long* keys,
    int n, Weights W, int lx, int ly, int lz) {
  float acc = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        if (!((col[dx][dy] >> (lz + 1 - dz)) & 1ull)) continue;
        const int cell = ((lx + 1 - dx) * kCY + (ly + 1 - dy)) * kCZ
                         + (lz + 1 - dz);
        int lo = 0, hi = n;                  // the first key of the cell
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (static_cast<int>(keys[mid] >> 32) < cell) lo = mid + 1;
          else hi = mid;
        }
        for (int k = lo; k < n && static_cast<int>(keys[k] >> 32) == cell;
             ++k) {
          const float4 a = W(k);
          const float wx = dx ? a.y : __fsub_rn(1.0f, a.y);
          const float wy = dy ? a.z : __fsub_rn(1.0f, a.z);
          const float wz = dz ? a.w : __fsub_rn(1.0f, a.w);
          acc = add_rn(acc, mul_rn(mul_rn(mul_rn(a.x, wx), wy), wz));
        }
      }
  return acc;
}

// Sum (n > 0) or zero (n == 0) and store the tile's voxels; returns the
// max order key of the voxels this thread wrote. A thread's kVec voxels
// read the cells z0 + lz .. z0 + lz + kVec of four columns: where none
// is held, they are zero without a search.
template <class Weights>
__device__ __forceinline__ unsigned write_tile(
    const unsigned long long* column, const unsigned long long* keys, int n,
    Weights W, const Box& b, int s, int x0, int y0, int z0,
    float* __restrict__ grids) {
  unsigned kmax = 0;
  const bool vec = b.Z % kVec == 0;
  const int lz = (threadIdx.x % kRowThreads) * kVec;
  constexpr unsigned long long kSpan = (1ull << (kVec + 1)) - 1;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int row = pass * kRowsPerPass + threadIdx.x / kRowThreads;
    const int lx = row / kTY, ly = row % kTY;
    const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
    if (x >= b.X || y >= b.Y || z >= b.Z) continue;
    float v[kVec] = {};
    if (n > 0) {
      unsigned long long col[2][2];
      unsigned long long near = 0;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          col[dx][dy] = column[(lx + 1 - dx) * kCY + (ly + 1 - dy)];
          near |= (col[dx][dy] >> lz) & kSpan;
        }
      if (near != 0)
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          v[j] = voxel_sum(col, keys, n, W, lx, ly, lz + j);
    }
    float* out = grids + ((static_cast<long long>(s) * b.X + x) * b.Y + y)
                             * static_cast<long long>(b.Z) + z;
    if (vec) {
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) kmax = max(kmax, mad_max_key(v[j]));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (z + j < b.Z) {
          out[j] = v[j];
          kmax = max(kmax, mad_max_key(v[j]));
        }
    }
  }
  return kmax;
}

// Merge the block's max key of structure s (each thread's k) into
// max_keys[s]: a warp reduction, then one atomic a warp where it raises
// the key.
__device__ __forceinline__ void flush_max(unsigned* __restrict__ max_keys,
                                          int s, unsigned k) {
  k = __reduce_max_sync(0xffffffffu, k);
  if ((threadIdx.x & 31) == 0 && k > max_keys[s]) atomicMax(max_keys + s, k);
}

// Ascending bitonic sort of the 32 lanes' keys in registers.
__device__ __forceinline__ unsigned long long warp_sort(
    unsigned long long key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key,
                                                       stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      key = keep_min ? min(key, other) : max(key, other);
    }
  return key;
}

// A persistent grid walks the tiles (structure-major). An empty tile (its
// 8 bins hold no atom) costs two loads in 8 lanes a warp, a warp sum and
// its stores, with no barrier, so the warps stream zeros on their own; a
// tile with atoms is gathered, sorted and summed by the whole block.
__global__ void __launch_bounds__(kThreads) tile_sums(
    const float4* __restrict__ atom_w,
    const unsigned long long* __restrict__ ent_cell,
    const int* __restrict__ start, const int* __restrict__ ids, Box b,
    unsigned long long* pool, unsigned long long* pool_used,
    float* __restrict__ grids, unsigned* __restrict__ max_keys) {
  __shared__ TileSmem sm;
  const int total = b.M * static_cast<int>(b.tiles);
  const int tiles = static_cast<int>(b.tiles), tyz = b.ty * b.tz;
  int cur = -1;
  unsigned kmax = 0;
  const auto none = [](int) { return make_float4(0, 0, 0, 0); };
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int s = tile / tiles;
    int r = tile - s * tiles;
    const int tx = r / tyz;
    r -= tx * tyz;
    const int ty = r / b.tz, tz = r - ty * b.tz;
    const int x0 = tx * kTX, y0 = ty * kTY, z0 = tz * kTZ;
    if (s != cur) {
      if (cur >= 0) flush_max(max_keys, cur, kmax);
      cur = s;
      kmax = 0;
    }
    int beg, cnt;
    const int raw = bin_range(start, b, s, tx, ty, tz, &beg, &cnt);
    if (raw == 0) {
      kmax = max(kmax, write_tile(sm.column, sm.keys, 0, none, b, s, x0, y0,
                                  z0, grids));
      continue;
    }
    __syncthreads();                  // the last tile's readers are done
    if (threadIdx.x == 0) {
      sm.n = 0;
      sm.n_pool = 0;
    }
    if (threadIdx.x < kColumns) sm.column[threadIdx.x] = 0;
    __syncthreads();
    gather_candidates(beg, cnt, raw, ids, ent_cell, x0, y0, z0, sm.keys,
                      &sm.n, kCap, sm.column);
    __syncthreads();
    const int n = sm.n;
    if (n <= kCap) {
      if (n <= 32) {
        // one warp sorts in registers
        if (threadIdx.x < 32) {
          const unsigned long long key =
              warp_sort(threadIdx.x < n ? sm.keys[threadIdx.x] : kNoKey);
          if (threadIdx.x < n) {
            sm.keys[threadIdx.x] = key;
            sm.w[threadIdx.x] = __ldg(atom_w + static_cast<unsigned>(key));
          }
        }
      } else {
        const int S = pow2_at_least(n);
        for (int i = n + threadIdx.x; i < S; i += blockDim.x)
          sm.keys[i] = kNoKey;
        __syncthreads();
        mad_bitonic_sort(sm.keys, S);
        for (int i = threadIdx.x; i < n; i += blockDim.x)
          sm.w[i] = __ldg(atom_w + static_cast<unsigned>(sm.keys[i]));
      }
      __syncthreads();
      const float4* w = sm.w;
      kmax = max(kmax, write_tile(sm.column, sm.keys, n,
                                  [w](int k) { return w[k]; }, b, s, x0, y0,
                                  z0, grids));
      continue;
    }
    // crowded: a region of S keys in the pool (its size bounds the sum of
    // every crowded tile's S), refilled there in full and sorted there
    if (threadIdx.x == 0)
      sm.pool_off = static_cast<long long>(
          atomicAdd(pool_used, static_cast<unsigned long long>(
                                   pow2_at_least(n))));
    __syncthreads();
    unsigned long long* keys = pool + sm.pool_off;
    gather_candidates(beg, cnt, raw, ids, ent_cell, x0, y0, z0, keys,
                      &sm.n_pool, n, nullptr);
    const int S = pow2_at_least(n);
    for (int i = n + threadIdx.x; i < S; i += blockDim.x) keys[i] = kNoKey;
    __syncthreads();
    mad_bitonic_sort(keys, S);
    kmax = max(kmax, write_tile(sm.column, keys, n, [keys, atom_w](int k) {
      return __ldg(atom_w + static_cast<unsigned>(keys[k]));
    }, b, s, x0, y0, z0, grids));
  }
  if (cur >= 0) flush_max(max_keys, cur, kmax);
}

__global__ void scale_clamp(float* __restrict__ vol, long long per,
                            long long total, const unsigned* __restrict__ keys,
                            float iso, int has_iso) {
  // kVec voxels a thread where a structure's voxels fill whole float4s
  const bool vec = per % kVec == 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long units = vec ? total / kVec : total;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x; u < units; u += step) {
    const long long i0 = vec ? u * kVec : u;
    const float d = mad_norm_divisor(keys[i0 / per]);
    auto one = [&](float v) {
      // a zero over a positive divisor is itself (its sign kept): zeros
      // skip the division, whose zero dividend takes its slow path
      const float q = v == 0.0f && !isnan(d) ? v : __fdiv_rn(v, d);
      return has_iso && q < iso ? 0.0f : q;
    };
    if (vec) {
      float4 v = reinterpret_cast<float4*>(vol)[u];
      v = make_float4(one(v.x), one(v.y), one(v.z), one(v.w));
      reinterpret_cast<float4*>(vol)[u] = v;
    } else {
      vol[i0] = one(vol[i0]);
    }
  }
}

unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// Scratch from the caller: counts (bins + 1 int32, zeroed; bins = M x
// (ceil(X / kTX) + 1) x (ceil(Y / kTY) + 1) x (ceil(Z / kTZ) + 1)), sums (ceil((bins + 1) / 4096) int32), bin_of, slot,
// ids (M * N int32 each), cell_of and ent_cell (M * N uint64 each),
// atom_w (M * N float4),
// pool (pool_keys uint64, >= 16 * M * N) and pool_used (one uint64,
// zeroed). max_keys (M uint32): each structure's max merges into it (zero
// it for a fresh max).
MAD_EXPORT int mad_scatter_atoms(const float* coords, const float* masses,
                                 const float* vox_min, int M, int N, int X,
                                 int Y, int Z, float margin, float voxsp,
                                 int* counts, int* sums, int* bin_of,
                                 int* slot, int* ids, void* cell_of,
                                 void* ent_cell,
                                 void* atom_w, void* pool,
                                 long long pool_keys, void* pool_used,
                                 float* grids, unsigned* max_keys,
                                 cudaStream_t stream) {
  Box b{};
  b.M = M;
  b.N = N;
  b.X = X;
  b.Y = Y;
  b.Z = Z;
  b.margin = margin;
  b.voxsp = voxsp;
  b.tx = (X + kTX - 1) / kTX;
  b.ty = (Y + kTY - 1) / kTY;
  b.tz = (Z + kTZ - 1) / kTZ;
  b.bx = b.tx + 1;
  b.by = b.ty + 1;
  b.bz = b.tz + 1;
  b.bins = static_cast<long long>(b.bx) * b.by * b.bz;
  b.tiles = static_cast<long long>(b.tx) * b.ty * b.tz;
  const long long atoms = static_cast<long long>(M) * N;
  const long long n = M * b.bins + 1;
  const long long nb = (n + kScanChunk - 1) / kScanChunk;
  if (atoms > 0x7fffffffLL || n > 0x7fffffffLL || M * b.tiles > 0x7fffffffLL
      || X > static_cast<int>(kCoordMask) || Y > static_cast<int>(kCoordMask)
      || Z > static_cast<int>(kCoordMask) || pool_keys < 16 * atoms)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || b.tiles == 0) return 0;
  auto* cells = static_cast<unsigned long long*>(cell_of);
  auto* ents = static_cast<unsigned long long*>(ent_cell);
  auto* w = static_cast<float4*>(atom_w);
  if (atoms > 0)
    bin_atoms<<<blocks_for(atoms, kThreads), kThreads, 0, stream>>>(
        coords, masses, vox_min, b, counts, bin_of, slot, cells, w);
  chunk_sums<<<static_cast<unsigned>(nb), kThreads, 0, stream>>>(counts, n,
                                                                 sums);
  scan_sums<<<1, kSumThreads, 0, stream>>>(sums, static_cast<int>(nb));
  scan_chunks<<<static_cast<unsigned>(nb), kThreads, 0, stream>>>(counts, n,
                                                                  sums);
  if (atoms > 0)
    fill_bins<<<blocks_for(atoms, kThreads), kThreads, 0, stream>>>(
        bin_of, slot, cells, counts, atoms, ids, ents);
  // a persistent grid: as many blocks as fit on the card at once (asked
  // once a card)
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_sums,
                                                          kThreads, 0);
    resident[dev] = sms * per_sm;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = std::min(
      M * b.tiles, static_cast<long long>(dev < 64 ? resident[dev] : 1024));
  tile_sums<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      w, ents, counts, ids, b, static_cast<unsigned long long*>(pool),
      static_cast<unsigned long long*>(pool_used), grids, max_keys);
  return static_cast<int>(cudaGetLastError());
}

// vol: M structures of `per` float32 voxels each, scaled in place by
// 1 / max(max_s, 1e-30) (max_s decoded from keys[s]) and, when has_iso,
// set to +0 below iso.
MAD_EXPORT int mad_simulate_scale(float* vol, int M, long long per,
                                  const unsigned* keys, float iso,
                                  int has_iso, cudaStream_t stream) {
  const long long total = static_cast<long long>(M) * per;
  if (total <= 0) return 0;
  const long long units = per % kVec == 0 ? total / kVec : total;
  const unsigned blocks = static_cast<unsigned>(
      std::min(static_cast<long long>(blocks_for(units, kThreads)),
               132LL * 16));
  scale_clamp<<<blocks, kThreads, 0, stream>>>(vol, per, total, keys, iso,
                                               has_iso);
  return static_cast<int>(cudaGetLastError());
}
