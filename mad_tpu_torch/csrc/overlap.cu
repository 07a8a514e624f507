// K18: pairwise occupancy overlap fractions of docking solutions, packed
// and counted by frame tile in one launch.
//
// Replaces mad_tpu/engine/assemble.py:123-166 (_compiled_pack_overlap).
// Each solution's box (density > 0 is occupied) sits at its lattice offset
// in a common frame of FX x FY x 32 W voxels. One block takes a tile of
// the frame, TX x TY columns (x, y) by TW 32-voxel words along z:
//   1. it stages the (m, 3) offsets in shared memory and lists, in
//      ascending order, the solutions whose boxes meet the tile; a tile
//      that no box meets reads no density;
//   2. it packs those solutions' words of the tile into shared memory,
//      zero where no box lies: a warp takes kColUnroll (listed solution,
//      frame column) items at once and reads, for each word of the column
//      inside the box, 32 z-voxels of one box row (128 B); __ballot_sync
//      of (density > 0) is the word, bit b = z mod 32, as the JAX body's
//      shift-and-sum packs it;
//   3. one warp a pair i <= j of listed solutions sums popcount(a & b)
//      over the tile's words and adds the sum into the (m, m) int32 counts
//      with one integer atomicAdd (none for a zero sum). Integer sums do
//      not depend on their order, so every run gives the same counts;
//   4. the last block to finish (a ticket after a __threadfence) writes
//      the fractions ov[i, j] = f32(count) / f32(max(count[i, i], 1)) with
//      an IEEE division, 0 where count[i, i] == 0, upper triangle (k = 1).
// The packed frame never reaches device memory; the counts and the ticket
// are cleared by the entry (cudaMemsetAsync).
//
// Bound: the function's own is the boxes read once (m * X * Y * Z floats;
// 37.9 MB, 0.0113 ms at the bench's 16 solutions of 84^3), and the tiles
// read only those bytes: the frame's tiles partition it, so every box
// voxel is read by one block, once. What holds the design back on the
// card is latency and instructions, not bytes: a tile packs its boxes'
// words from few rows, so each warp keeps up to kColUnroll * kTileWords
// 128-byte loads in flight (predicated loads: a load behind a
// short-circuit test compiled to a branch each, which took twice the
// time), only words inside a box load, a
// column's place in the tile is shifts and masks (the tile's columns are
// template arguments: integer division by a run-time extent for every
// word cost more than the loads), small tiles (2 x 8 columns) spread the
// boxes over many blocks, and the pair sums of a tile with many boxes
// wait on the packing's barrier.
// Shared memory is sized by m (the largest list a tile can hold): the
// tile shrinks (its depth, then its columns) until it fits, so any m up to
// the card's shared memory (over 11,000 solutions) runs.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileWords = 8;           // the deepest tile, in words
constexpr int kColUnroll = 2;           // columns a warp packs at once
constexpr int kSmemMax = 232448 - 1024;   // the card's, less static shared

// offsets, list and packed words of m solutions, `words` a solution in a
// tile
__host__ __device__ inline long long smem_bytes(int m, int words) {
  return 16LL * m + 4LL * m * words;
}

// A tile: TX x TY frame columns (compile-time, so that a column's place
// is shifts and masks) by TW words (at run time, at most kTileWords).
template <int TX, int TY>
__global__ void __launch_bounds__(kThreads)
    overlap_tiles(const float* __restrict__ dens,
                  const int* __restrict__ offsets, int m, int X, int Y,
                  int Z, int FX, int FY, int W, int TW, int tiles_x,
                  int tiles_y, int* __restrict__ counts,
                  float* __restrict__ ov) {
  constexpr int kCols = TX * TY;
  extern __shared__ int smem[];
  int* off = smem;                                     // (m, 3)
  int* list = off + 3 * m;                             // (m,)
  uint32_t* packed = reinterpret_cast<uint32_t*>(list + m);  // (P, T)
  __shared__ int warp_n[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int T = kCols * TW;                            // words a solution
  int b = blockIdx.x;
  const int fx0 = (b % tiles_x) * TX;
  b /= tiles_x;
  const int fy0 = (b % tiles_y) * TY;
  const int w0 = (b / tiles_y) * TW;
  const int fx1 = min(fx0 + TX, FX), fy1 = min(fy0 + TY, FY);
  const int w1 = min(w0 + TW, W);

  for (int t = threadIdx.x; t < 3 * m; t += kThreads) off[t] = offsets[t];
  __syncthreads();
  // 1. the solutions whose boxes meet the tile, ascending
  int P = 0;
  for (int s0 = 0; s0 < m; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    bool meets = false;
    if (s < m) {
      const int ox = off[3 * s], oy = off[3 * s + 1], oz = off[3 * s + 2];
      meets = ox < fx1 && ox + X > fx0 && oy < fy1 && oy + Y > fy0 &&
              oz < 32 * w1 && oz + Z > 32 * w0;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int at = P;
    for (int k = 0; k < warp; ++k) at += warp_n[k];
    if (meets) list[at + __popc(bal & ((1u << lane) - 1u))] = s;
    for (int k = 0; k < kWarps; ++k) P += warp_n[k];
    __syncthreads();
  }

  if (P > 0) {
    // 2. pack, a warp kColUnroll (listed solution, column) items at once,
    // all their words' loads sent before the ballots; words no box
    // covers stay 0
    for (int t = threadIdx.x; t < P * T; t += kThreads) packed[t] = 0u;
    __syncthreads();
    const int items = P * kCols;
    for (int j0 = warp * kColUnroll; j0 < items;
         j0 += kWarps * kColUnroll) {
      bool occ[kColUnroll][kTileWords];
      int at[kColUnroll];
#pragma unroll
      for (int cu = 0; cu < kColUnroll; ++cu) {
        const int j = j0 + cu, p = j / kCols, c = j % kCols;
        const int fx = fx0 + c / TY, fy = fy0 + c % TY;
        const int s = j < items ? list[p] : 0;
        const int x = fx - off[3 * s], y = fy - off[3 * s + 1];
        const bool col = j < items && fx < fx1 && fy < fy1 && x >= 0 &&
                         x < X && y >= 0 && y < Y;
        at[cu] = col ? (p * kCols + c) * TW : -1;
        const float* row =
            dens + ((static_cast<long long>(s) * X + x) * Y + y) * Z;
        const int z0 = 32 * w0 + lane - off[3 * s + 2];
#pragma unroll
        for (int w = 0; w < kTileWords; ++w) {
          const int z = z0 + 32 * w;
          const bool in = col && w0 + w < w1 && z >= 0 && z < Z;
          occ[cu][w] = (in ? __ldg(row + z) : 0.0f) > 0.0f;
        }
      }
#pragma unroll
      for (int cu = 0; cu < kColUnroll; ++cu)
#pragma unroll
        for (int w = 0; w < kTileWords; ++w) {
          const uint32_t word = __ballot_sync(0xffffffffu, occ[cu][w]);
          if (lane == 0 && at[cu] >= 0 && w < TW) packed[at[cu] + w] = word;
        }
    }
    __syncthreads();
    // 3. one warp a pair (i, i + r), r >= 0, of the list: row i holds
    // P - i pairs
    int i = 0, r = warp;
    while (i < P && r >= P - i) {
      r -= P - i;
      ++i;
    }
    while (i < P) {
      const uint32_t* a = packed + i * T;
      const uint32_t* bb = packed + (i + r) * T;
      int c = 0;
      for (int t = lane; t < T; t += 32) c += __popc(a[t] & bb[t]);
      for (int d = 16; d > 0; d >>= 1)
        c += __shfl_xor_sync(0xffffffffu, c, d);
      if (lane == 0 && c != 0)
        atomicAdd(&counts[list[i] * m + list[i + r]], c);
      r += kWarps;
      while (i < P && r >= P - i) {
        r -= P - i;
        ++i;
      }
    }
  }

  // 4. the last block to finish writes the fractions
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket =
        atomicAdd(reinterpret_cast<unsigned*>(counts + m * m), 1u);
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int t = threadIdx.x; t < m * m; t += kThreads) {
    const int i = t / m, j = t - (t / m) * m;
    const int d = __ldcg(&counts[i * m + i]);
    float v = 0.0f;
    if (j > i && d != 0)
      v = __fdiv_rn(static_cast<float>(__ldcg(&counts[t])),
                    static_cast<float>(d > 1 ? d : 1));
    ov[t] = v;
  }
}

template <int TX, int TY>
cudaError_t launch_tiles(const float* dens, const int* offsets, int m, int X,
                         int Y, int Z, int FX, int FY, int W, int TW,
                         long long smem, int* counts, float* ov,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        overlap_tiles<TX, TY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles_x = (FX + TX - 1) / TX, tiles_y = (FY + TY - 1) / TY;
  const long long blocks =
      static_cast<long long>(tiles_x) * tiles_y * ((W + TW - 1) / TW);
  overlap_tiles<TX, TY><<<static_cast<unsigned>(blocks), kThreads,
                          static_cast<size_t>(smem), stream>>>(
      dens, offsets, m, X, Y, Z, FX, FY, W, TW, tiles_x, tiles_y, counts,
      ov);
  return cudaGetLastError();
}

}  // namespace

// dens (m, X, Y, Z) f32; offsets (m, 3) int32 lattice offsets in the frame
// (every box inside it: the caller checks, kernels/overlap.check_frame);
// frame FX x FY x 32 W voxels; counts (m * m + 1,) int32 scratch, cleared
// here (the last int is the blocks' ticket); ov (m, m) f32 out. The tile
// is 2 x 8 columns by up to kTileWords words; for a large m its depth
// halves, then its columns drop to 1 x 4 and 1 x 1, until the packed words
// of m solutions fit in shared memory.
MAD_EXPORT int mad_pack_overlap(const float* dens, const int* offsets, int m,
                                int X, int Y, int Z, int FX, int FY, int W,
                                int* counts, float* ov, cudaStream_t stream) {
  if (m == 0) return 0;
  if (FX < 1 || FY < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, (static_cast<size_t>(m) * m + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (const int cols : {16, 4, 1}) {
    int TW = W < kTileWords ? W : kTileWords;
    while (smem_bytes(m, cols * TW) > kSmemMax && TW > 1) TW = (TW + 1) / 2;
    const long long smem = smem_bytes(m, cols * TW);
    if (smem > kSmemMax) continue;
    err = cols == 16 ? launch_tiles<2, 8>(dens, offsets, m, X, Y, Z, FX, FY,
                                          W, TW, smem, counts, ov, stream)
        : cols == 4  ? launch_tiles<1, 4>(dens, offsets, m, X, Y, Z, FX, FY,
                                          W, TW, smem, counts, ov, stream)
                     : launch_tiles<1, 1>(dens, offsets, m, X, Y, Z, FX, FY,
                                          W, TW, smem, counts, ov, stream);
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
