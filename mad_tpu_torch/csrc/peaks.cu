// K4: LoG peak mask + compaction, as a wide-load threshold stream.
//
// Replaces mad_tpu/ops/detect.py:48-52 and 190-212 (_maxpool3 and the
// is_peak / top_k part of detect_counts): a voxel is a peak when it
//   * equals the maximum of its 3x3x3 neighbourhood (the neighbourhood is
//     clipped at the volume edge, as reduce_window's -inf SAME padding; a
//     NaN in it makes that maximum NaN, as in reduce_window and
//     max_pool3d, so the voxel is no peak: fmaxf alone would skip it),
//   * is above threshold,
//   * lies at least `border` voxels inside the real extent (rx, ry, rz).
// Each peak is appended as one 64-bit key: the high 32 bits order the
// values descending as lax.top_k ranks them (a monotone map of the
// float's bits, a total order: +0.0 above -0.0), the low 32 bits are the
// own-row flat index. Sorting the keys ascending as int64 gives the order
// (-value, flat index), lax.top_k's order with its ties; the wrapper reads
// the values back from the volume (kernels/peaks.py, peak_keys_plain).
//
// Offset form (capacity mode, detect.py:236-275 detect_shard): the volume
// is a block of X rows, of which rows [row0, row0 + rows) are the shard's
// own and the others its neighbours' halo, read only by the 3x3x3
// neighbourhood; x0 is the global row of own row 0, so the border test is
// in global coordinates. The index in a key is local to the own rows (the
// wrapper adds x0 * Y * Z in int64). The single-device call is row0 = 0,
// rows = X, x0 = 0. The own rows hold fewer than 2^31 voxels (the wrapper
// refuses more), so the stream's index arithmetic is 32-bit.
//
// Bound: one read of the own rows, 4 bytes a voxel (on the bench's
// upsampled octave 0.21 % of the voxels are above threshold, so the
// neighbourhoods and the keys are next to nothing). Design, two passes
// launched together:
//   1. a stream that keeps enough bytes in flight to reach the card's
//      bandwidth. Each warp takes 32 * kUnroll 16-byte float4 loads a step
//      (lane l the l-th of each 512-byte run), all sent before any is
//      tested; the grid fills the card once (as many blocks as are
//      resident at once) and strides over the rows. A scalar head reaches
//      the first 16-byte boundary of the own rows (row0 * Y * Z floats need
//      not be a multiple of 4) and a scalar tail ends them. A warp whose
//      values all lie below threshold does one vote a step. A value above
//      threshold pays for its coordinates, the border test and a test
//      against its z neighbours, which the warp holds in registers; the
//      survivors go to the warp's own region of a candidate buffer (fill
//      count in a register, no atomic), so no warp waits on memory in the
//      stream for a candidate's neighbourhood;
//   2. one warp a region: each candidate's clipped 3x3x3 neighbourhood,
//      all 27 loads sent before the max; the peaks append by warp, one
//      ballot and one atomicAdd a warp, each lane its slot;
//   3. one block sorts the keys (up to kSortMax) and writes the top-k's
//      values and global indices, so that the wrapper's one sync, for the
//      count, is its last step.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // float4 loads in flight a thread
constexpr int kChunk = 32 * kUnroll;  // float4s a warp takes a step
constexpr int kSortMax = 4096;        // peaks pass 3 orders in one block
constexpr int kSortThreads = 1024;

struct PeakArgs {
  const float* vol;
  int X, Y, Z, row0, rows, x0, rx, ry, rz, border;
  float threshold;
  unsigned long long* keys;
  int capacity;
  int* counter;   // [peaks, the most candidates of a warp, warps]
};

// The descending order key of a value and its own-row index (the plain
// form is kernels/peaks.py:peak_keys_plain).
__device__ __forceinline__ unsigned long long peak_key(float v, int i) {
  const unsigned b = __float_as_uint(v);
  const unsigned up = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const unsigned hi = up ^ 0x7fffffffu;   // descending, as a signed int32
  return (static_cast<unsigned long long>(hi) << 32) |
         static_cast<unsigned>(i);
}

__device__ __forceinline__ float lane_of(const float4& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

// Whether own-row voxel i lies `border` inside the real extent; its z.
__device__ __forceinline__ bool inside(const PeakArgs& a, int i, int* z) {
  const int t = i / a.Z;
  *z = i - t * a.Z;
  const int xl = t / a.Y, y = t - xl * a.Y;
  const int gx = a.x0 + xl;                              // global row
  return gx >= a.border && gx < a.rx - a.border && y >= a.border &&
         y < a.ry - a.border && *z >= a.border && *z < a.rz - a.border;
}

// Pass 1: the threshold stream over the own rows. Each warp appends the
// own-row indices of its candidates (above threshold, inside the border,
// not beaten by a z neighbour held in registers) to its own region of
// `cand`, R entries, with its fill in a register: no atomics in the loop.
// own: the first own voxel; head scalars reach a 16-byte boundary, then
// n4 float4s, then the tail scalars up to n own voxels.
__global__ void __launch_bounds__(kThreads)
    peak_stream(PeakArgs a, const float* __restrict__ own, int n, int head,
                int n4, int* __restrict__ cand, int R) {
  const float4* body = reinterpret_cast<const float4*>(own + head);
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int n_warps = gridDim.x * kWarps;
  int* region = cand + n_warps + static_cast<long long>(warp) * R;
  const unsigned below = (1u << lane) - 1u;
  int filled = 0;                                  // the warp's candidates
  for (int c0 = warp * kChunk; c0 < n4; c0 += n_warps * kChunk) {
    float4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = c0 + u * 32 + lane;
      q[u] = k < n4 ? __ldcs(body + k)
                    : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
    unsigned cand_bits = 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (lane_of(q[u], e) > a.threshold) cand_bits |= 1u << (4 * u + e);
    if (!__any_sync(0xffffffffu, cand_bits != 0u)) continue;
    // the z neighbours of each lane's first and last value (the
    // neighbouring lanes'; -inf outside the warp's step)
    float wrap_w[kUnroll], wrap_x[kUnroll], left[kUnroll], right[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      wrap_w[u] = __shfl_sync(0xffffffffu, q[u].w, 31);
      wrap_x[u] = __shfl_sync(0xffffffffu, q[u].x, 0);
      left[u] = __shfl_up_sync(0xffffffffu, q[u].w, 1);
      right[u] = __shfl_down_sync(0xffffffffu, q[u].x, 1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (lane == 0) left[u] = u > 0 ? wrap_w[u - 1] : -INFINITY;
      if (lane == 31) right[u] = u + 1 < kUnroll ? wrap_x[u + 1] : -INFINITY;
    }
#pragma unroll
    for (int b = 0; b < 4 * kUnroll; ++b) {
      bool c = (cand_bits >> b) & 1u;
      const int u = b / 4, e = b % 4;
      const int i = head + 4 * (c0 + u * 32 + lane) + e;
      if (c) {
        const float v = lane_of(q[u], e);
        const float vl = e > 0 ? lane_of(q[u], e - 1) : left[u];
        const float vr = e < 3 ? lane_of(q[u], e + 1) : right[u];
        int z;
        c = inside(a, i, &z) && !(z > 0 && vl > v) && !(z + 1 < a.Z && vr > v);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, c);
      if (c && filled + __popc(bal & below) < R)
        region[filled + __popc(bal & below)] = i;
      filled += __popc(bal);
    }
  }
  // the head and the tail (at most 3 + 3 voxels), by the grid's first warp
  if (warp == 0) {
    const int tail0 = head + 4 * n4;
    int i = -1;
    if (lane < head)
      i = lane;
    else if (lane < head + (n - tail0))
      i = tail0 + lane - head;
    int z;
    const bool c = i >= 0 && own[i] > a.threshold && inside(a, i, &z);
    const unsigned bal = __ballot_sync(0xffffffffu, c);
    if (c && filled + __popc(bal & below) < R)
      region[filled + __popc(bal & below)] = i;
    filled += __popc(bal);
  }
  if (lane == 0) {
    cand[warp] = filled;
    if (filled) atomicMax(a.counter + 1, filled);
    if (warp == 0) a.counter[2] = n_warps;
  }
}

// Pass 2: one warp a region of pass 1; a candidate is a peak when no
// neighbour of its clipped 3x3x3 neighbourhood is larger (all 27 loads
// sent before the max: one memory latency); the warp's peaks take
// consecutive key slots from one atomicAdd.
__global__ void __launch_bounds__(kThreads)
    peak_test(PeakArgs a, const int* __restrict__ cand, int n_warps, int R) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (warp >= n_warps) return;
  const int count = min(cand[warp], R);
  const int* region = cand + n_warps + static_cast<long long>(warp) * R;
  const int yz = a.Y * a.Z;
  for (int t0 = 0; t0 < count; t0 += 32) {
    const int t = t0 + lane;
    const int i = t < count ? region[t] : 0;
    bool peak = false;
    float v = 0.f;
    if (t < count) {
      const int xl = i / yz, r = i - xl * yz;
      const int y = r / a.Z, z = r - y * a.Z;
      const int x = a.row0 + xl;                         // block row
      const float* c = a.vol + static_cast<long long>(x) * yz + r;
      const bool okx[3] = {x > 0, true, x + 1 < a.X};
      const bool oky[3] = {y > 0, true, y + 1 < a.Y};
      const bool okz[3] = {z > 0, true, z + 1 < a.Z};
      float w[27];
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        const int dx = k / 9, dy = (k / 3) % 3, dz = k % 3;
        w[k] = okx[dx] && oky[dy] && okz[dz]
                   ? __ldg(c + (dx - 1) * static_cast<long long>(yz) +
                           (dy - 1) * a.Z + (dz - 1))
                   : -INFINITY;
      }
      v = w[13];
      float m = v;
      bool nan = false;
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        m = fmaxf(m, w[k]);
        nan |= w[k] != w[k];
      }
      peak = !nan && v >= m;   // reduce_window's max is NaN there
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, peak);
    if (!ballot) continue;
    const int leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(a.counter, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (peak) {
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
      if (slot < a.capacity) a.keys[slot] = peak_key(v, i);
    }
  }
}

// Pass 3, one block: up to kSortMax keys sorted ascending as int64 (a
// bitonic sort in shared memory of the keys with their sign bit flipped),
// then the first `out_cap` decoded: the value read from the own rows and
// the global flat index (base = x0 * Y * Z plus the own-row index). More
// keys than kSortMax are left to the caller.
__global__ void __launch_bounds__(kSortThreads)
    peak_order(const int* __restrict__ counter,
               const unsigned long long* __restrict__ keys, int capacity,
               const float* __restrict__ own, long long base, int out_cap,
               float* __restrict__ vals, long long* __restrict__ idx) {
  __shared__ unsigned long long sorted[kSortMax];
  constexpr unsigned long long kSign = 1ull << 63;
  const int n = counter[0];
  if (n > kSortMax || n > capacity) return;
  int S = 1;
  while (S < n) S <<= 1;
  for (int t = threadIdx.x; t < S; t += kSortThreads)
    sorted[t] = t < n ? keys[t] ^ kSign : ~0ull;
  __syncthreads();
  mad_bitonic_sort(sorted, S);
  for (int t = threadIdx.x; t < min(n, out_cap); t += kSortThreads) {
    const unsigned i = static_cast<unsigned>(sorted[t]);   // the low bits
    vals[t] = own[i];
    idx[t] = base + i;
  }
}

}  // namespace

// vol (X, Y, Z) f32; keys (capacity,) uint64 out; cand (cand_len,) int32
// scratch: one fill count a warp of pass 1, then a region of
// R = (cand_len - warps) / warps candidates a warp; counter (3,) int32
// out, cleared here: [the number of peaks, the most candidates a warp
// found, pass 1's warps]. Peaks beyond capacity, or candidates beyond a
// warp's region (counter[1] > R), are lost: the caller reruns with room.
// When there are at most kSortMax peaks, vals (out_cap,) f32 and idx
// (out_cap,) int64 get the first out_cap in order (pass 3).
MAD_EXPORT int mad_peak_mask_compact(const float* vol, int X, int Y, int Z,
                                     int row0, int rows, int x0, int rx,
                                     int ry, int rz, int border,
                                     float threshold,
                                     unsigned long long* keys, int capacity,
                                     int* cand, long long cand_len,
                                     int* counter, float* vals,
                                     long long* idx, int out_cap,
                                     cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(counter, 0, 3 * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(rows) * Y * Z;
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  const int n = static_cast<int>(total);
  const float* own = vol + static_cast<long long>(row0) * Y * Z;
  int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(own) & 15)) & 15) / 4);
  if (head > n) head = n;
  const int n4 = (n - head) / 4;
  // one wave: as many blocks as the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, peak_stream,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (static_cast<long long>(n4) + kChunk * kWarps - 1) /
                     (kChunk * kWarps);
  if (blocks > static_cast<long long>(sms) * per_sm)
    blocks = static_cast<long long>(sms) * per_sm;
  if (blocks < 1) blocks = 1;
  const int n_warps = static_cast<int>(blocks) * kWarps;
  const long long R = (cand_len - n_warps) / n_warps;
  if (R < 1 || R >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const PeakArgs a{vol,    X,         Y,    Z,        row0,   rows, x0, rx,
                   ry,     rz,        border, threshold, keys, capacity,
                   counter};
  peak_stream<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, own, n, head, n4, cand, static_cast<int>(R));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  peak_test<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a, cand, n_warps, static_cast<int>(R));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  peak_order<<<1, kSortThreads, 0, stream>>>(
      counter, keys, capacity, own, static_cast<long long>(x0) * Y * Z,
      out_cap, vals, idx);
  return static_cast<int>(cudaGetLastError());
}
