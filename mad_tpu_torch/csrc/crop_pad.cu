// K22: per-axis occupancy flags, and K23: crop and zero re-pad.
//
// K22 replaces mad_tpu/core/grid.py:31-42 (_compiled_axis_any): for a
// float32 C-contiguous (X, Y, Z) volume, three uint8 vectors of lengths
// X, Y and Z, flag[i] = any(v != 0) over the plane at i of that axis,
// written one after the other into one (X + Y + Z) buffer so the host
// pulls them in one copy. `v != 0.0f` is IEEE: a NaN counts (NaN != 0 is
// true), a -0.0 does not (-0.0 == 0.0). The build passes no fast-math
// flag, so the compare stays IEEE. The flags are zeroed by a memset, then
// one launch reads the volume once: a block of 32 x 8 threads takes an
// x-plane's run of kRows rows, a warp a row at a time, a lane every 32nd
// z (coalesced 128-byte loads, kRows / 8 rows in flight a thread). Each
// lane keeps its rows' and z column's flags in registers; a row's flag is
// one __any_sync and a store from lane 0, the z flags meet in shared
// bytes, and the block stores each flag that is set once, to global
// memory. Every store writes 1, so stores from many blocks to one flag do
// not race.
//
// K23 replaces mad_tpu/core/grid.py:45-57 (_compiled_crop_pad) and
// mad_tpu/ops/scalespace.py:68-80 (_compiled_prepare_pad, without the
// bucket padding): out (bx + 2p, by + 2p, bz + 2p) with
// out[i] = src[i - p + lo] inside the copied box and 0.0f outside. Each
// output voxel is written once, data and zeros in the same pass (no
// memset before a copy): a thread takes four consecutive output elements
// of the flat order, loads the ones inside the box (consecutive along z,
// so a warp's loads are coalesced) and writes all four with one 16-byte
// store; the output comes from the caching allocator, 16-byte aligned,
// and its last N % 4 elements are written singly. The values move as
// bits (a NaN's payload and a zero's sign are kept).
//
// Bounds: bytes. K22 reads the volume once (the bench's unreduced map);
// K23 reads the box once and writes the output once (the bench map's
// prepare: 78.97 MB read, 95.82 MB written, 0.052 ms at 3.35 TB/s).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kFlagRows = 32;       // rows of an x-plane a K22 block takes
constexpr int kFlagWarps = 8;
constexpr int kPadThreads = 256;

__global__ void axis_flags(const float* __restrict__ src, int X, int Y,
                           int Z, unsigned char* __restrict__ flags) {
  extern __shared__ unsigned char zset[];   // Z bytes
  __shared__ int xset;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int x = blockIdx.y;
  const int y0 = blockIdx.x * kFlagRows;
  for (int z = tid; z < Z; z += 32 * kFlagWarps) zset[z] = 0;
  if (tid == 0) xset = 0;
  __syncthreads();
  constexpr int kPer = kFlagRows / kFlagWarps;
  bool row_any[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) row_any[j] = false;
  bool any = false;
  const float* plane = src + static_cast<long long>(x) * Y * Z;
  for (int z = lane; z < Z; z += 32) {
    bool zany = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int y = y0 + warp + j * kFlagWarps;
      if (y < Y) {
        const bool nz = __ldg(plane + static_cast<long long>(y) * Z + z)
                        != 0.0f;
        row_any[j] |= nz;
        zany |= nz;
      }
    }
    if (zany) zset[z] = 1;
    any |= zany;
  }
  unsigned char* fx = flags;
  unsigned char* fy = flags + X;
  unsigned char* fz = flags + X + Y;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int y = y0 + warp + j * kFlagWarps;
    if (__any_sync(0xffffffffu, row_any[j]) && lane == 0 && y < Y) fy[y] = 1;
  }
  if (__any_sync(0xffffffffu, any) && lane == 0) xset = 1;
  __syncthreads();
  if (tid == 0 && xset) fx[x] = 1;
  for (int z = tid; z < Z; z += 32 * kFlagWarps)
    if (zset[z]) fz[z] = 1;
}

struct Box {
  int X, Y, Z;           // source shape
  int lx, ly, lz;        // the box's first source voxel
  int bx, by, bz;        // the box's extent
  int p;                 // zero padding on every side
  int Yo, Zo;            // output shape's last two axes
};

// Output element (x, y, z) as bits: the source voxel inside the box, else
// +0.0f.
__device__ __forceinline__ unsigned voxel(const unsigned* __restrict__ src,
                                          const Box& b, int x, int y,
                                          int z) {
  const int sx = x - b.p, sy = y - b.p, sz = z - b.p;
  if (static_cast<unsigned>(sx) >= static_cast<unsigned>(b.bx)
      || static_cast<unsigned>(sy) >= static_cast<unsigned>(b.by)
      || static_cast<unsigned>(sz) >= static_cast<unsigned>(b.bz))
    return 0u;
  return __ldg(src + ((static_cast<long long>(sx + b.lx) * b.Y + sy + b.ly)
                      * b.Z + sz + b.lz));
}

// Four consecutive output elements from flat index f (f % 4 == 0) a
// thread; Index is 32-bit where the output has fewer than 2^32 elements.
template <typename Index>
__global__ void crop_pad(const unsigned* __restrict__ src, Box b, Index N,
                         unsigned* __restrict__ out) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x * 4;
  for (Index f = (static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x)
                 * 4;
       f < N; f += stride) {
    const Index row = f / b.Zo;
    int z = static_cast<int>(f - row * b.Zo);
    int y = static_cast<int>(row % b.Yo);
    int x = static_cast<int>(row / b.Yo);
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = voxel(src, b, x, y, z);
      if (++z == b.Zo) {
        z = 0;
        if (++y == b.Yo) {
          y = 0;
          ++x;
        }
      }
    }
    if (f + 4 <= N) {
      *reinterpret_cast<uint4*>(out + f) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; f + e < N; ++e) out[f + e] = v[e];
    }
  }
}

}  // namespace

// src: (X, Y, Z) float32; flags: (X + Y + Z) uint8, written whole (x
// planes, then y, then z).
MAD_EXPORT int mad_axis_flags(const float* src, int X, int Y, int Z,
                              unsigned char* flags, cudaStream_t stream) {
  const long long n = static_cast<long long>(X) + Y + Z;
  cudaError_t err = cudaMemsetAsync(flags, 0, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (X == 0 || Y == 0 || Z == 0) return 0;
  if (Z > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((Y + kFlagRows - 1) / kFlagRows, X);
  axis_flags<<<grid, dim3(32, kFlagWarps), Z, stream>>>(src, X, Y, Z, flags);
  return static_cast<int>(cudaGetLastError());
}

// src: (X, Y, Z) float32; the box [lo, lo + box) lies inside it; out:
// (bx + 2 pad, by + 2 pad, bz + 2 pad) float32, 16-byte aligned, written
// whole.
MAD_EXPORT int mad_crop_pad(const float* src, int X, int Y, int Z, int lx,
                            int ly, int lz, int bx, int by, int bz, int pad,
                            float* out, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const Box b{X, Y, Z, lx, ly, lz, bx, by, bz, pad, by + 2 * pad,
              bz + 2 * pad};
  const long long N = static_cast<long long>(bx + 2 * pad) * b.Yo * b.Zo;
  if (N == 0) return 0;
  const long long threads = (N + 3) / 4;
  const long long want = (threads + kPadThreads - 1) / kPadThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  const unsigned* s = reinterpret_cast<const unsigned*>(src);
  unsigned* o = reinterpret_cast<unsigned*>(out);
  if (N <= 0xffffffffLL - 4LL * kPadThreads * (1 << 20))
    crop_pad<unsigned><<<blocks, kPadThreads, 0, stream>>>(
        s, b, static_cast<unsigned>(N), o);
  else
    crop_pad<unsigned long long><<<blocks, kPadThreads, 0, stream>>>(
        s, b, static_cast<unsigned long long>(N), o);
  return static_cast<int>(cudaGetLastError());
}
