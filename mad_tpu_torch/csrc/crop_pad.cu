// K22: per-axis occupancy flags, and K23: crop and zero re-pad.
//
// K22 replaces mad_tpu/core/grid.py:31-42 (_compiled_axis_any): for a
// float32 C-contiguous (X, Y, Z) volume, three uint8 vectors of lengths
// X, Y and Z, flag[i] = any(v != 0) over the plane at i of that axis,
// written one after the other into one (X + Y + Z) buffer so the host
// pulls them in one copy. `v != 0.0f` is IEEE: a NaN counts (NaN != 0 is
// true), a -0.0 does not (-0.0 == 0.0). The build passes no fast-math
// flag, so the compare stays IEEE. The flags are zeroed by a memset, then
// one launch reads the volume once as a flat stream of 16-byte loads: a
// few blocks an SM (kFlagBlocksPerSm), each a contiguous span of 16-byte
// chunks, a thread kFlagSlots chunks in flight (a warp's loads on 512
// contiguous bytes) and the next iteration's chunks prefetched into L2 (the
// bare loads keep too few bytes in flight: 76 % of the card's bandwidth
// without, scripts/torch_localize_flags_probe.py). Rows are not 16-byte
// aligned (the bench's Z = 250 makes a row 1,000 bytes), but a chunk of 4
// values spans at most two rows when Z >= 4: a thread finds its first
// chunk's (x, y, z) by one division and then carries it forward, each step
// a few adds and compares (no division a chunk). A nonzero value marks its
// z, and its row's x and y, in the block's X + Y + Z flag bytes in shared
// memory (every store writes 1, so stores from many lanes to one flag do
// not race); the block then stores each flag that is set once, to global
// memory. The values before the first 16-byte boundary of the data and
// after the last whole chunk (all of them where Z < 4) are read one at a
// time, each position from a division.
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
// Bounds: bytes. K22 reads the volume once (the bench's unreduced map,
// 70.8 MB: 0.0211 ms at 3.35 TB/s); K23 reads the box once and writes the
// output once (the bench map's prepare: 78.97 MB read, 95.82 MB written,
// 0.052 ms at 3.35 TB/s).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kFlagThreads = 256;
constexpr int kFlagSlots = 4;       // 16-byte chunks in flight a thread
constexpr int kFlagBlocksPerSm = 4;
constexpr int kFlagAhead = 1;       // iterations of chunks prefetched ahead
constexpr int kPadThreads = 256;

// A voxel's position, and an advance along the flat order as a carry of
// (x, y, z) (dz < Z and dy < Y, so one carry an axis suffices).
struct Voxel {
  int x, y, z;
};

__device__ __forceinline__ void advance(Voxel& v, const Voxel& d, int Y,
                                        int Z) {
  v.x += d.x;
  v.y += d.y;
  v.z += d.z;
  if (v.z >= Z) {
    v.z -= Z;
    ++v.y;
  }
  if (v.y >= Y) {
    v.y -= Y;
    ++v.x;
  }
}

// The position of flat element e (one 32-bit division pair where e fits).
__device__ __forceinline__ Voxel voxel_of(long long e, int Y, int Z) {
  long long r;
  int z;
  if (e <= 0xffffffffLL) {
    const unsigned u = static_cast<unsigned>(e);
    const unsigned q = u / static_cast<unsigned>(Z);
    r = q;
    z = static_cast<int>(u - q * static_cast<unsigned>(Z));
  } else {
    r = e / Z;
    z = static_cast<int>(e - r * Z);
  }
  return Voxel{static_cast<int>(r / Y), static_cast<int>(r % Y), z};
}

// The flags of one 16-byte chunk whose first value is at v (Z >= 4: its
// values lie in v's row and at most the next).
__device__ __forceinline__ void mark_chunk(const float4& c, const Voxel& v,
                                           int Y, int Z,
                                           unsigned char* sx,
                                           unsigned char* sy,
                                           unsigned char* sz) {
  const unsigned m = static_cast<unsigned>(c.x != 0.0f)
                     | static_cast<unsigned>(c.y != 0.0f) << 1
                     | static_cast<unsigned>(c.z != 0.0f) << 2
                     | static_cast<unsigned>(c.w != 0.0f) << 3;
  if (m == 0) return;
  const int n1 = min(4, Z - v.z);            // values in v's row
  if (m & ((1u << n1) - 1u)) {
    sx[v.x] = 1;
    sy[v.y] = 1;
  }
  if (m >> n1) {
    const bool wrap = v.y + 1 == Y;
    sx[v.x + wrap] = 1;
    sy[wrap ? 0 : v.y + 1] = 1;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if ((m >> i) & 1u) sz[v.z + i < Z ? v.z + i : v.z + i - Z] = 1;
  }
}

// head: elements before the first 16-byte boundary; chunks: whole 16-byte
// chunks after it (0 where Z < 4), span of them a block; slot / step: the
// advances of kFlagThreads and of kFlagSlots * kFlagThreads chunks.
__global__ void __launch_bounds__(kFlagThreads, kFlagBlocksPerSm)
axis_flags(const float* __restrict__ src, int X, int Y, int Z, long long N,
           long long head, long long chunks, long long span, Voxel slot,
           Voxel step, unsigned char* __restrict__ flags) {
  extern __shared__ unsigned char seen[];   // X + Y + Z flag bytes
  const int F = X + Y + Z;
  unsigned char* sx = seen;
  unsigned char* sy = seen + X;
  unsigned char* sz = seen + X + Y;
  for (int i = threadIdx.x; i < F; i += kFlagThreads) seen[i] = 0;
  __syncthreads();
  // The values outside the whole chunks, one at a time.
  const long long tail = head + 4 * chunks;
  const long long singles = head + (N - tail);
  for (long long i = static_cast<long long>(blockIdx.x) * kFlagThreads
                     + threadIdx.x;
       i < singles; i += static_cast<long long>(gridDim.x) * kFlagThreads) {
    const long long e = i < head ? i : tail + (i - head);
    if (src[e] != 0.0f) {
      const Voxel v = voxel_of(e, Y, Z);
      sx[v.x] = 1;
      sy[v.y] = 1;
      sz[v.z] = 1;
    }
  }
  const float4* chunk = reinterpret_cast<const float4*>(src + head);
  const long long c0 = static_cast<long long>(blockIdx.x) * span;
  const long long c1 = min(c0 + span, chunks);
  Voxel at[kFlagSlots];
  at[0] = voxel_of(head + 4 * (c0 + threadIdx.x), Y, Z);
#pragma unroll
  for (int j = 1; j < kFlagSlots; ++j) {
    at[j] = at[j - 1];
    advance(at[j], slot, Y, Z);
  }
  for (long long c = c0 + threadIdx.x; c < c1;
       c += kFlagSlots * kFlagThreads) {
    float4 v[kFlagSlots];
#pragma unroll
    for (int j = 0; j < kFlagSlots; ++j) {
      const long long cj = c + j * kFlagThreads;
      v[j] = cj < c1 ? __ldcs(chunk + cj) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kFlagSlots; ++j) {
      const long long cj = c + (j + kFlagAhead * kFlagSlots) * kFlagThreads;
      if (cj < c1) asm volatile("prefetch.global.L2 [%0];" ::"l"(chunk + cj));
    }
#pragma unroll
    for (int j = 0; j < kFlagSlots; ++j) {
      mark_chunk(v[j], at[j], Y, Z, sx, sy, sz);
      advance(at[j], step, Y, Z);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < F; i += kFlagThreads)
    if (seen[i]) flags[i] = 1;
}

// The advance of n elements as a carry of (x, y, z).
Voxel advance_of(long long n, int Y, int Z) {
  const long long rows = n / Z;
  return Voxel{static_cast<int>(rows / Y), static_cast<int>(rows % Y),
               static_cast<int>(n % Z)};
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

// src: (X, Y, Z) float32, 4-byte aligned; flags: (X + Y + Z) uint8,
// written whole (x planes, then y, then z).
MAD_EXPORT int mad_axis_flags(const float* src, int X, int Y, int Z,
                              unsigned char* flags, cudaStream_t stream) {
  const int F = X + Y + Z;
  cudaError_t err = cudaMemsetAsync(flags, 0, F, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (X == 0 || Y == 0 || Z == 0) return 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  if (addr % 4 != 0) return cudaErrorMisalignedAddress;
  if (F > 48 * 1024) {
    err = cudaFuncSetAttribute(axis_flags,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  static int sms[64];                 // SMs of each card, read once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const int most = (dev < 64 ? sms[dev] : 132) * kFlagBlocksPerSm;
  const long long N = static_cast<long long>(X) * Y * Z;
  long long head = static_cast<long long>((16 - addr % 16) % 16 / 4);
  if (head > N) head = N;
  const long long chunks = Z >= 4 ? (N - head) / 4 : 0;
  const long long singles = N - 4 * chunks;
  const long long per = kFlagSlots * kFlagThreads;
  long long want = (chunks + per - 1) / per;
  const long long for_singles = (singles + kFlagThreads - 1) / kFlagThreads;
  if (want < for_singles) want = for_singles;
  const int blocks = static_cast<int>(want < 1 ? 1
                                      : (want > most ? most : want));
  const long long span = (chunks + blocks - 1) / blocks;
  axis_flags<<<blocks, kFlagThreads, F, stream>>>(
      src, X, Y, Z, N, head, chunks, span,
      advance_of(4LL * kFlagThreads, Y, Z),
      advance_of(4LL * kFlagSlots * kFlagThreads, Y, Z), flags);
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
