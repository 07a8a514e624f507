// K12: approximate pose repeatability, two lanes a pair behind a coarse
// occupancy map in shared memory.
//
// Replaces mad_tpu/engine/match.py:126-155 (_approx_repeat_body). For
// pair k every unique subunit anchor x moves to
// y = (x - h_k) @ R_k^T + l_k, summed as core/geometry.rows_times does
// (((x0 R_e0 + x1 R_e1) + x2 R_e2) + l_e, each step rounded, no FMA), and
// rounds to the voxel v = rint((y - origin) * inv_voxsp) (half to even, as
// torch.round). The pair's score is 100 * #{x : v in the grid and
// field[v] != 0} / A_hi. A pose far off the map cannot wrap an integer
// cast (the conversion saturates); a NaN coordinate is voxel 0, as mad_tpu's
// saturating int32 convert makes it.
//
// Bound: bytes, each pair's pose read once (60 B), the subunit cloud and
// the map anchors' voxels, the distinct in-grid voxels looked up, the
// scores written; ~20 flops a moved anchor (46,848 pairs x 32 anchors at
// the bench, a field of 19.7 MB in the 50 MB L2). The first form, a warp a
// pair and a one-byte gather a lane, ran in ~5.5 waves of 11,712 blocks,
// each wave an HBM round trip for the poses and an L2 round trip for the
// gathers: 1.5 M separate 32-byte sectors for one byte each. Design:
//  * the field is K11's (csrc/field.cu): 1 at the voxels within r of a map
//    anchor voxel u, in the grid. Each block first builds, in shared
//    memory, a map of coarse cells of edge 2^s, a byte a cell (the
//    smallest power of two whose map fits kMapBytes, chosen by the
//    launcher from the grid), set where some clipped box [u - r, u + r]
//    overlaps the cell: a superset of the field's set voxels. A moved
//    anchor in a clear cell counts 0 with no request to L2; only those in
//    a set cell gather. A thread an (anchor, cell of its box) stores a 1:
//    every writer writes the same byte, so no atomics (a bitmap of finer
//    cells, ORed by atomics, spent more in their contention than its
//    fewer gathers saved);
//  * a tile of 16 pairs a warp, two lanes a pair (each half of the
//    anchors, the two counts joined by a shuffle), kWarps warps a block,
//    one block an SM (a persistent grid whose warps stride over the
//    tiles). A tile's poses (rot, hi, lo: 960 B) are copied by cp.async
//    into the warp's slice of shared memory, the next tile's while the
//    current tile's anchors run, and read by each pair's lanes (strides of
//    9 and 3 words: no bank conflicts);
//  * the subunit cloud in shared memory (kCloud anchors at a time), read
//    as float4 broadcasts; kBatch anchors a lane at a time, their gathers
//    issued together; rint and the integer voxel in one conversion
//    (cvt.rni: half to even, saturating, NaN to 0); a tile's scores one
//    coalesced store.
// Every rounding of the first form is kept, so the scores are the same
// bits.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 24;         // warps (tiles of 16 pairs) a block
constexpr int kMapBytes = 49152;   // the coarse map's budget (a byte a cell)
constexpr int kCloud = 512;        // subunit anchors staged at a time
constexpr int kVox = 512;          // map anchors' boxes staged at a time
constexpr int kBatch = 8;          // anchors a lane whose gathers go together
constexpr int kPairs = 16;         // pairs a tile (a warp)
constexpr int kTileFloats = kPairs * 15;   // a tile's rot | hi | lo
constexpr int kTileVecs = kTileFloats / 4;

// A 16-byte copy from device to shared memory with cp.async, of its first
// `bytes` (the rest zero-filled; 0 copies nothing). dst and src 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// Vector q of tile t's poses into the warp's buffer: q < 36 of rot (9
// floats a pair), then 12 of hi and 12 of lo (3 a pair); n pairs in the
// tile. Bases are 16-byte aligned (the wrapper's check) and a tile starts
// at a multiple of 16 pairs, so every vector is aligned; the ragged end is
// zero-filled.
__device__ __forceinline__ void tile_copy(float* buf, const float* rot,
                                          const float* hi, const float* lo,
                                          long long t, int n, int q) {
  const float* src;
  int valid, off;
  if (q < 36) {
    src = rot + 9 * kPairs * t;
    valid = 9 * n;
    off = 4 * q;
  } else if (q < 48) {
    src = hi + 3 * kPairs * t;
    valid = 3 * n;
    off = 4 * (q - 36);
  } else {
    src = lo + 3 * kPairs * t;
    valid = 3 * n;
    off = 4 * (q - 48);
  }
  const int bytes = 4 * max(0, min(4, valid - off));
  cp_async16(buf + 4 * q, bytes > 0 ? src + off : src, bytes);
}

// Issue tile t's copies (every lane: vectors lane and lane + 32) and
// commit them as one group; n pairs (0: an empty group).
__device__ __forceinline__ void tile_issue(float* buf, const float* rot,
                                           const float* hi, const float* lo,
                                           int t, int n, int lane) {
  if (n > 0)
    for (int q = lane; q < kTileVecs; q += 32)
      tile_copy(buf, rot, hi, lo, t, n, q);
  cp_async_commit();
}

__global__ void __launch_bounds__(32 * kWarps)
approx_repeat(const signed char* __restrict__ field, int X, int Y, int Z,
              const int* __restrict__ vox, int A_lo, int r, int s, int CY,
              int CZ, int cells, const float* __restrict__ cloud, int A_hi,
              const float* __restrict__ origin, float inv,
              const float* __restrict__ rot, const float* __restrict__ hi,
              const float* __restrict__ lo, int P,
              float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = lane & (kPairs - 1), half = lane >> 4;
  float* poses = reinterpret_cast<float*>(smem) + 2 * warp * kTileFloats;
  float4* cl = smem + 2 * kWarps * kTileVecs;      // x, y, z, 0 an anchor
  int4* box = reinterpret_cast<int4*>(cl + kCloud);   // cells, an anchor
  unsigned char* map = reinterpret_cast<unsigned char*>(box + kVox);
  const int tiles = (P + kPairs - 1) / kPairs;
  const int stride = gridDim.x * kWarps;
  auto pairs_in = [&](int t) {
    return t < tiles ? min(kPairs, P - kPairs * t) : 0;
  };

  // The first tile's poses in flight while the map is built.
  int buf = 0;
  tile_issue(poses, rot, hi, lo, blockIdx.x * kWarps + warp,
             pairs_in(blockIdx.x * kWarps + warp), lane);
  const bool once = A_hi <= kCloud;
  if (once)
    for (int a = threadIdx.x; a < A_hi; a += blockDim.x)
      cl[a] = make_float4(cloud[3 * a], cloud[3 * a + 1], cloud[3 * a + 2],
                          0.0f);
  // The coarse map: the map anchors' clipped boxes in cell units, kVox
  // anchors at a time, then a thread an (anchor, cell of its box), the
  // cells a box spans along an axis rounded up to 2^sb (shifts, no
  // divisions).
  const int sb = 32 - __clz(((2 * r) >> s) + 1);   // ceil log2 of the span
  const int cube = 1 << (3 * sb);
  for (int v0 = 0; v0 < A_lo || v0 == 0; v0 += kVox) {
    const int nv = min(kVox, A_lo - v0);
    if (v0 > 0) __syncthreads();           // the last chunk marked
    for (int a = threadIdx.x; a < nv; a += blockDim.x) {
      const int* u = vox + 3 * (v0 + a);
      const int x0 = max(u[0] - r, 0), x1 = min(u[0] + r, X - 1);
      const int y0 = max(u[1] - r, 0), y1 = min(u[1] + r, Y - 1);
      const int z0 = max(u[2] - r, 0), z1 = min(u[2] + r, Z - 1);
      box[a] = (x0 > x1 || y0 > y1 || z0 > z1)
                   ? make_int4(1, 0, 0, 0)          // empty: x0 > x1
                   : make_int4((x0 >> s) | ((x1 >> s) << 16),
                               (y0 >> s) | ((y1 >> s) << 16),
                               (z0 >> s) | ((z1 >> s) << 16), 0);
    }
    if (v0 == 0)
      for (int w = threadIdx.x; 16 * w < cells; w += blockDim.x)
        reinterpret_cast<uint4*>(map)[w] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    for (int it = threadIdx.x; it < nv * cube; it += blockDim.x) {
      const int4 b = box[it >> (3 * sb)];
      const int cx = (b.x & 0xffff) + (it >> (2 * sb) & ((1 << sb) - 1));
      const int cy = (b.y & 0xffff) + (it >> sb & ((1 << sb) - 1));
      const int cz = (b.z & 0xffff) + (it & ((1 << sb) - 1));
      if (cx <= (b.x >> 16) && cy <= (b.y >> 16) && cz <= (b.z >> 16))
        map[(cx * CY + cy) * CZ + cz] = 1;
    }
  }
  __syncthreads();

  const float org[3] = {origin[0], origin[1], origin[2]};
  const unsigned dims[3] = {static_cast<unsigned>(X),
                            static_cast<unsigned>(Y),
                            static_cast<unsigned>(Z)};
  const float denom = static_cast<float>(A_hi > 1 ? A_hi : 1);
  // Block-uniform steps: every warp meets the cloud's barriers.
  for (int t0 = blockIdx.x * kWarps; t0 < tiles; t0 += stride) {
    const int t = t0 + warp, n = pairs_in(t);
    const bool mine = p < n;
    // this tile's copies landed; the next tile's go to the other buffer
    // (read by the warp two tiles ago)
    cp_async_wait<0>();
    __syncwarp();
    const float* pb = poses + buf * kTileFloats;
    float R[9], h[3], l[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = pb[9 * p + i];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      h[e] = pb[9 * kPairs + 3 * p + e];
      l[e] = pb[12 * kPairs + 3 * p + e];
    }
    __syncwarp();
    buf ^= 1;
    tile_issue(poses + buf * kTileFloats, rot, hi, lo, t + stride,
               pairs_in(t + stride), lane);
    int cnt = 0;
    for (int c0 = 0; c0 < A_hi; c0 += kCloud) {
      const int m = min(kCloud, A_hi - c0);
      if (!once) {
        __syncthreads();
        for (int a = threadIdx.x; a < m; a += blockDim.x)
          cl[a] = make_float4(cloud[3 * (c0 + a)], cloud[3 * (c0 + a) + 1],
                              cloud[3 * (c0 + a) + 2], 0.0f);
        __syncthreads();
      }
      if (n == 0) continue;
      // this lane's anchors: half, half + 2, ... of the chunk
      for (int a0 = half; a0 < m; a0 += 2 * kBatch) {
        unsigned idx[kBatch];
        bool need[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int a = a0 + 2 * u;
          const float4 x = cl[min(a, m - 1)];
          const float x0 = __fsub_rn(x.x, h[0]);
          const float x1 = __fsub_rn(x.y, h[1]);
          const float x2 = __fsub_rn(x.z, h[2]);
          int v[3];
          bool inb = mine && a < m;
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const float y = add_rn(add_rn(add_rn(mul_rn(x0, R[3 * e]),
                                                 mul_rn(x1, R[3 * e + 1])),
                                          mul_rn(x2, R[3 * e + 2])),
                                   l[e]);
            v[e] = __float2int_rn(mul_rn(__fsub_rn(y, org[e]), inv));
            inb = inb && static_cast<unsigned>(v[e]) < dims[e];
          }
          const int cell = inb ? ((v[0] >> s) * CY + (v[1] >> s)) * CZ
                                     + (v[2] >> s)
                               : 0;
          const bool near = map[cell] != 0;
          need[u] = inb && near;
          idx[u] = (static_cast<unsigned>(v[0]) * Y + v[1]) * Z + v[2];
        }
        signed char hit[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          hit[u] = 0;
          if (need[u]) hit[u] = field[idx[u]];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) cnt += hit[u] > 0 ? 1 : 0;
      }
    }
    cnt += __shfl_xor_sync(0xffffffffu, cnt, 16);   // the pair's two halves
    if (mine && half == 0)
      out[static_cast<long long>(kPairs) * t + p] = __fdiv_rn(
          __fmul_rn(100.0f, static_cast<float>(cnt)), denom);
  }
  cp_async_wait<0>();
}

}  // namespace

// field (X, Y, Z) int8, fewer than 2^31 voxels and sides below 2^16, K11's
// field of the map anchors' voxels vox (A_lo, 3) int32 at radius r; cloud
// (A_hi, 3), origin (3), rot (P, 3, 3), hi / lo (P, 3) float32, rot, hi
// and lo 16-byte aligned; out (P) float32.
MAD_EXPORT int mad_approx_repeat(const signed char* field, int X, int Y,
                                 int Z, const int* vox, int A_lo, int r,
                                 const float* cloud, int A_hi,
                                 const float* origin, float inv_voxsp,
                                 const float* rot, const float* hi,
                                 const float* lo, int P, float* out,
                                 cudaStream_t stream) {
  if (P == 0) return 0;
  if (static_cast<long long>(X) * Y * Z >= (1LL << 31) || r < 0
      || X >= (1 << 16) || Y >= (1 << 16) || Z >= (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  int s = 0;                      // the smallest cell edge 2^s that fits
  auto count = [&](int t) {
    const long long e = 1LL << t;
    return ((X + e - 1) >> t) * ((Y + e - 1) >> t) * ((Z + e - 1) >> t);
  };
  while (count(s) > kMapBytes) ++s;
  const int CY = (Y + (1 << s) - 1) >> s, CZ = (Z + (1 << s) - 1) >> s;
  const int cells = static_cast<int>(count(s));
  const size_t bytes = sizeof(float4) * (2 * kWarps * kTileVecs + kCloud)
                       + sizeof(int4) * kVox + 16 * ((cells + 15) / 16);
  const uintptr_t align = reinterpret_cast<uintptr_t>(rot)
                         | reinterpret_cast<uintptr_t>(hi)
                         | reinterpret_cast<uintptr_t>(lo);
  if (align % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        approx_repeat, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  static int sms[64];                 // SMs of each card, read once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const int most = dev < 64 ? sms[dev] : 132;
  const int tiles = (P + kPairs - 1) / kPairs;
  const int blocks = min((tiles + kWarps - 1) / kWarps, most);
  approx_repeat<<<blocks, 32 * kWarps, bytes, stream>>>(
      field, X, Y, Z, vox, A_lo, r, s, CY, CZ, cells, cloud, A_hi, origin,
      inv_voxsp, rot, hi, lo, P, out);
  return static_cast<int>(cudaGetLastError());
}
