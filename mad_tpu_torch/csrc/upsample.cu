// K2: x2 Catmull-Rom upsampling of a 3D float32 volume,
// (X, Y, Z) -> (2X - 1, 2Y - 1, 2Z - 1), in one launch.
//
// Replaces mad_tpu/ops/convolve.py:184-215 (upsample2, _upsample_axis).
// Along each axis, x then y then z, n samples become 2n - 1:
//   out[2i]     = in[i]
//   out[2i + 1] = ((t0 + t1) + t2) + t3,
//   t_m = w[3 - m] * in[clamp(i + m - 1, 0, n - 1)],
//   w = (-1/16, 9/16, 9/16, -1/16),
// one rounding per product and per sum in that order: the order of the
// shift-add in kernels/upsample.py:upsample_axis_plain (and of
// mad_tpu/ops/convolve.py:200-203), so the result equals the three
// per-axis passes of upsample2_plain bit for bit.
//
// Bound: device memory bandwidth, the base read once and the octave
// written once (4 B in and about 32 B out a base voxel); the three
// per-axis launches it replaces also wrote and read back the two volumes
// between the passes.
//
// Design: a block takes an input tile of kTX x kTY x kTZ cells plus the
// taps' halo (cells i - 1 ... i + 2, clamped at the faces, which gives
// each pass's edge replication), copied into shared memory with cp.async
// (4-byte copies: rows of odd length are not 16-byte aligned). In shared
// memory it runs the x pass over the tile's y / z halo, then the y pass
// over its z halo, each value rounded as the per-axis pass rounds it; the
// z pass writes the 2kTX x 2kTY x 2kTZ outputs straight to device memory
// as z-runs, a warp store 128 contiguous bytes (on the H100 a lane
// writing an output pair, two stores at an 8-byte stride, was slower).
// The x and y passes read each line once into registers and give all its
// outputs; the y pass's output takes the input tile's place, so 29 KB of
// shared memory let seven blocks share an SM. Tiles of 2 x 8 x 64 cells
// and 256 threads were the fastest of the shapes tried on the bench map's
// base. The last tile of an axis is ragged; an axis of one sample has no
// half samples. Offsets are 64-bit once the output reaches
// 2^32 elements, 32-bit below.
#include "common.cuh"

namespace {

constexpr int kTX = 2, kTY = 8, kTZ = 64;              // input cells
constexpr int kIX = kTX + 3, kIY = kTY + 3, kIZ = kTZ + 3;  // with halo
constexpr int kOX = 2 * kTX, kOY = 2 * kTY, kOZ = 2 * kTZ;  // outputs
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr float kEdge = -0.0625f;    // w[0] = w[3] = -1/16
constexpr float kInner = 0.5625f;    // w[1] = w[2] = 9/16

// The half sample between b and c of four consecutive samples a, b, c, d.
__device__ __forceinline__ float half(float a, float b, float c, float d) {
  float acc = mul_rn(a, kEdge);
  acc = add_rn(acc, mul_rn(b, kInner));
  acc = add_rn(acc, mul_rn(c, kInner));
  return add_rn(acc, mul_rn(d, kEdge));
}

// One line of a pass: the N + 3 samples s[0], s[SI], ... (one cell before
// the tile's first to two after its last) give the 2N outputs o[0],
// o[SO], ...: o[2i] copies sample i + 1, o[2i + 1] is the half sample
// between samples i + 1 and i + 2.
template <int N, int SI, int SO>
__device__ __forceinline__ void up_line(const float* s, float* o) {
  float w[N + 3];
#pragma unroll
  for (int i = 0; i < N + 3; ++i) w[i] = s[i * SI];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    o[2 * i * SO] = w[i + 1];
    o[(2 * i + 1) * SO] = half(w[i], w[i + 1], w[i + 2], w[i + 3]);
  }
}

__device__ __forceinline__ int clamp_to(int i, int n) {
  return min(max(i, 0), n - 1);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    upsample2(const float* __restrict__ in, float* __restrict__ out, int X,
              int Y, int Z) {
  // the input tile, then (once the x pass has read it) the y pass's
  // output; the x pass's output between them
  constexpr int kIn = kIX * kIY * kIZ, kXY = kOX * kOY * kIZ;
  __shared__ float s_in[kIn > kXY ? kIn : kXY];
  __shared__ float s_x[kOX * kIY * kIZ];
  float* s_xy = s_in;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = blockIdx.z * kTX, j0 = blockIdx.y * kTY;
  const int k0 = blockIdx.x * kTZ;

  // the tile a z-row at a time, clamped at the faces
  for (int r = warp; r < kIX * kIY; r += kWarps) {
    const int a = r / kIY;
    const int x = clamp_to(i0 - 1 + a, X);
    const int y = clamp_to(j0 - 1 + (r - a * kIY), Y);
    const float* src = in + (static_cast<Idx>(x) * Y + y) * Z;
    for (int c = lane; c < kIZ; c += 32)
      cp_async4(s_in + r * kIZ + c, src + clamp_to(k0 - 1 + c, Z), true);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int yz = threadIdx.x; yz < kIY * kIZ; yz += kThreads)
    up_line<kTX, kIY * kIZ, kIY * kIZ>(s_in + yz, s_x + yz);
  __syncthreads();
  for (int col = threadIdx.x; col < kOX * kIZ; col += kThreads) {
    const int a = col / kIZ, c = col - a * kIZ;
    up_line<kTY, kIZ, kIZ>(s_x + a * kIY * kIZ + c,
                           s_xy + a * kOY * kIZ + c);
  }
  __syncthreads();

  // the z pass, a warp a z-run: lane l writes outputs l, l + 32, ...
  const int OY = 2 * Y - 1, OZ = 2 * Z - 1;
  const int nx = min(kOX, 2 * X - 1 - 2 * i0);
  const int ny = min(kOY, OY - 2 * j0);
  const int nz = min(kOZ, OZ - 2 * k0);
  for (int r = warp; r < kOX * kOY; r += kWarps) {
    const int a = r / kOY, b = r - a * kOY;
    if (a >= nx || b >= ny) continue;
    const float* s = s_xy + r * kIZ;
    float* dst = out + (static_cast<Idx>(2 * i0 + a) * OY + 2 * j0 + b) * OZ
                 + 2 * k0;
    for (int o = lane; o < nz; o += 32) {
      const float* p = s + (o >> 1);
      dst[o] = (o & 1) ? half(p[0], p[1], p[2], p[3]) : p[1];
    }
  }
}

}  // namespace

// in (X, Y, Z) float32, every extent >= 1; out (2X - 1, 2Y - 1, 2Z - 1)
// float32, written whole. Offsets are 64-bit once the output reaches
// min(wide_from, 2^32) elements (a smaller wide_from tests that path).
MAD_EXPORT int mad_upsample2(const float* in, float* out, int X, int Y,
                             int Z, long long wide_from,
                             cudaStream_t stream) {
  const dim3 grid((Z + kTZ - 1) / kTZ, (Y + kTY - 1) / kTY,
                  (X + kTX - 1) / kTX);
  const long long wide = wide_from < (1LL << 32) ? wide_from : 1LL << 32;
  if ((2LL * X - 1) * (2LL * Y - 1) * (2LL * Z - 1) < wide) {
    upsample2<unsigned><<<grid, kThreads, 0, stream>>>(in, out, X, Y, Z);
  } else {
    upsample2<long long><<<grid, kThreads, 0, stream>>>(in, out, X, Y, Z);
  }
  return static_cast<int>(cudaGetLastError());
}
