// K3: gradient field of a 3D float32 volume, (X, Y, Z) -> (X, Y, Z, 3),
// float32 or bfloat16.
//
// Replaces mad_tpu/ops/scalespace.py:238-262 (_grad_body). Per axis:
//   interior  (v[i + 1] - v[i - 1]) * 0.5
//   edges     v[1] - v[0] and v[n - 1] - v[n - 2]
// (jnp.gradient, unit spacing), each a float32 subtract and multiply with
// one rounding, as kernels/gradient.py:gradient_plain; the bfloat16 field
// holds those floats rounded to nearest even (__float2bfloat16_rn, what
// copy_ into a bfloat16 tensor and the JAX body's astype do).
//
// Bound: device memory bandwidth, 4 B read and 12 B (6 B) written a voxel.
//
// Design, a plane-marching stencil: a block owns a footprint of kTY x kTZ
// (y, z) columns, z contiguous, two rows a thread, and marches along x
// over kChunk planes. Planes x - 1, x and x + 1 of the footprint, each
// with its one-voxel y / z halo, sit in a ring in shared memory, and the
// next kAhead planes are copied in with cp.async (4-byte copies: the rows
// are not 16-byte aligned) while the block works on plane x, so each
// voxel comes from device memory about once and no thread divides an
// index. The block assembles each footprint row's 3 * kTZ record
// components in shared memory and its warps store them as contiguous
// runs, 128 B (64 B in bfloat16) a warp store. Each thread takes two
// rows, which halves the block's waits a voxel: on the H100, with one row
// a thread, a build without the stores took as long as the kernel (the
// march set the time); with two, the stores take most of it
// (scripts/torch_k3_probe.py builds both halves). Offsets are 64-bit once
// 3 * X * Y * Z reaches 2^32 (octaves above 1.4 G voxels), 32-bit below.
#include "common.cuh"

namespace {

constexpr int kTZ = 64;                  // footprint z: a thread each
constexpr int kRows = 4;                 // rows of threads
constexpr int kPer = 2;                  // footprint rows a thread
constexpr int kTY = kRows * kPer;        // footprint rows
constexpr int kThreads = kRows * kTZ;
constexpr int kChunk = 16;               // planes a block marches
constexpr int kPW = kTZ + 2;             // a plane's row with its z halo
constexpr int kPlane = (kTY + 2) * kPW;  // a plane with its y / z halo
constexpr int kAhead = 1;                // planes in flight past x + 1
constexpr int kRing = 4;                 // slots: a power of two
static_assert(kRing >= kAhead + 3 && (kRing & (kRing - 1)) == 0,
              "the ring holds x - 1 ... x + 1 + kAhead");

// The footprint's plane x, halo included, into ring slot s; cells outside
// the volume are left as they are (an edge voxel takes a one-sided
// difference and never reads them).
template <typename Idx>
__device__ __forceinline__ void load_plane(float* s, const float* v, int x,
                                           int X, int Y, int Z, int y0,
                                           int z0) {
  if (x < 0 || x >= X) return;
  const float* src = v + static_cast<Idx>(x) * Y * Z;
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int r = i / kPW;
    const int y = y0 - 1 + r, z = z0 - 1 + (i - r * kPW);
    if (y >= 0 && y < Y && z >= 0 && z < Z)
      cp_async4(s + i, src + static_cast<Idx>(y) * Z + z, true);
  }
}

// d/di at index i of an axis of n samples, from v[i - 1], v[i], v[i + 1].
__device__ __forceinline__ float diff(float lo, float mid, float hi, int i,
                                      int n) {
  if (i == 0) return __fsub_rn(hi, mid);
  if (i == n - 1) return __fsub_rn(mid, lo);
  return __fmul_rn(__fsub_rn(hi, lo), 0.5f);
}

__device__ __forceinline__ float cast(float g, float) { return g; }
__device__ __forceinline__ __nv_bfloat16 cast(float g, __nv_bfloat16) {
  return __float2bfloat16_rn(g);
}

template <typename Out, typename Idx>
__global__ void __launch_bounds__(kThreads)
    gradient(const float* __restrict__ v, int X, int Y, int Z,
             Out* __restrict__ out) {
  __shared__ float ring[kRing][kPlane];
  __shared__ __align__(4) unsigned char rec_bytes[kTY * 3 * kTZ *
                                                  sizeof(Out)];
  Out(*rec)[3 * kTZ] = reinterpret_cast<Out(*)[3 * kTZ]>(rec_bytes);
  const int tz = threadIdx.x % kTZ, tr = threadIdx.x / kTZ;
  const int z0 = blockIdx.x * kTZ, y0 = blockIdx.y * kTY;
  const int x0 = blockIdx.z * kChunk;
  const int x1 = min(x0 + kChunk, X);
  const int z = z0 + tz;
  const int nz = min(kTZ, Z - z0);
  // plane x lives in slot (x - x0 + 1) mod kRing
  auto slot = [&](int x) { return ring[(x - x0 + 1) & (kRing - 1)]; };

  // one copy group for planes x0 - 1 ... x0 + 1, then one a plane; the
  // chunk's last voxels read plane x1, not past it
  for (int x = x0 - 1; x <= x0 + 1 + kAhead; ++x) {
    if (x <= x1) load_plane<Idx>(slot(x), v, x, X, Y, Z, y0, z0);
    if (x >= x0 + 1) cp_async_commit();
  }
  for (int x = x0; x < x1; ++x) {
    if (x > x0) {
      // the slot of plane x + 1 + kAhead held plane x + 1 + kAhead -
      // kRing <= x - 2, which no thread reads any more
      const int next = x + 1 + kAhead;
      if (next <= x1)
        load_plane<Idx>(slot(next), v, next, X, Y, Z, y0, z0);
      cp_async_commit();
    }
    cp_async_wait<kAhead>();                 // planes up to x + 1 landed
    __syncthreads();
    const float* c = slot(x);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {         // footprint rows tr + p kRows
      const int ty = tr + p * kRows, y = y0 + ty;
      const int k = (ty + 1) * kPW + tz + 1;   // the voxel in its plane
      if (y < Y && z < Z) {
        Out* r = rec[ty] + 3 * tz;
        r[0] = cast(diff(slot(x - 1)[k], c[k], slot(x + 1)[k], x, X),
                    Out());
        r[1] = cast(diff(c[k - kPW], c[k], c[k + kPW], y, Y), Out());
        r[2] = cast(diff(c[k - 1], c[k], c[k + 1], z, Z), Out());
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int ty = tr + p * kRows, y = y0 + ty;
      if (y < Y) {
        Out* dst = out + 3 * ((static_cast<Idx>(x) * Y + y) * Z + z0);
        for (int j = tz; j < 3 * nz; j += kTZ) dst[j] = rec[ty][j];
      }
    }
    __syncthreads();                         // ring slot and rows reused
  }
}

template <typename Out>
int launch(const float* vol, int X, int Y, int Z, Out* out,
           long long wide_from, cudaStream_t stream) {
  const dim3 grid((Z + kTZ - 1) / kTZ, (Y + kTY - 1) / kTY,
                  (X + kChunk - 1) / kChunk);
  const long long wide = wide_from < (1LL << 32) ? wide_from : 1LL << 32;
  if (3LL * X * Y * Z < wide) {
    gradient<Out, unsigned><<<grid, kThreads, 0, stream>>>(vol, X, Y, Z,
                                                           out);
  } else {
    gradient<Out, long long><<<grid, kThreads, 0, stream>>>(vol, X, Y, Z,
                                                            out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vol (X, Y, Z) float32, every extent >= 2; out (X, Y, Z, 3) float32
// (out_type 0) or bfloat16 (out_type 1), written whole. Offsets are
// 64-bit once 3 * X * Y * Z reaches min(wide_from, 2^32) (a smaller
// wide_from tests that path).
MAD_EXPORT int mad_gradient(const float* vol, int X, int Y, int Z,
                            int out_type, void* out, long long wide_from,
                            cudaStream_t stream) {
  if (out_type == 0)
    return launch(vol, X, Y, Z, static_cast<float*>(out), wide_from,
                  stream);
  return launch(vol, X, Y, Z, static_cast<__nv_bfloat16*>(out), wide_from,
                stream);
}
