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
// Bound: device memory bandwidth. One thread per voxel reads its six
// neighbours (the same lines as its warp's neighbours, so the volume comes
// from device memory about once) and writes its 12 B (6 B) record; the
// warp's records are one contiguous span, merged in L2. The plain version
// makes ~15 strided passes. Offsets are 64-bit once 3 * X * Y * Z passes
// 2^32 (octaves above 1.4 G voxels); 32-bit below (cheaper division).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename Idx>
__device__ __forceinline__ float diff(const float* __restrict__ v, Idx t,
                                      Idx i, Idx n, Idx stride) {
  if (i == 0) return __fsub_rn(v[t + stride], v[t]);
  if (i == n - 1) return __fsub_rn(v[t], v[t - stride]);
  return __fmul_rn(__fsub_rn(v[t + stride], v[t - stride]), 0.5f);
}

__device__ __forceinline__ void store(float* out, float g) { *out = g; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float g) {
  *out = __float2bfloat16_rn(g);
}

template <typename Out, typename Idx>
__global__ void gradient(const float* __restrict__ v, Idx X, Idx Y, Idx Z,
                         Out* __restrict__ out) {
  const Idx t = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= X * Y * Z) return;
  const Idx z = t % Z;
  const Idx r = t / Z;
  const Idx y = r % Y;
  const Idx x = r / Y;
  Out* rec = out + 3 * t;
  store(rec, diff(v, t, x, X, Y * Z));
  store(rec + 1, diff(v, t, y, Y, Z));
  store(rec + 2, diff(v, t, z, Z, Idx(1)));
}

template <typename Out>
int launch(const float* vol, long long X, long long Y, long long Z,
           Out* out, cudaStream_t stream) {
  const long long n = X * Y * Z;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1)
                                                / kThreads);
  if (3 * n + kThreads < (1LL << 32)) {
    gradient<Out, unsigned><<<blocks, kThreads, 0, stream>>>(
        vol, static_cast<unsigned>(X), static_cast<unsigned>(Y),
        static_cast<unsigned>(Z), out);
  } else {
    gradient<Out, long long><<<blocks, kThreads, 0, stream>>>(vol, X, Y, Z,
                                                              out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vol (X, Y, Z) float32, every extent >= 2; out (X, Y, Z, 3) float32
// (out_type 0) or bfloat16 (out_type 1), written whole.
MAD_EXPORT int mad_gradient(const float* vol, int X, int Y, int Z,
                            int out_type, void* out, cudaStream_t stream) {
  if (out_type == 0)
    return launch(vol, X, Y, Z, static_cast<float*>(out), stream);
  return launch(vol, X, Y, Z, static_cast<__nv_bfloat16*>(out), stream);
}
