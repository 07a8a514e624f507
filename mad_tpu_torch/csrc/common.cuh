// Shared helpers of the hand-written kernels (plain C interface, no
// PyTorch headers; each exported launcher returns cudaGetLastError()).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define MAD_EXPORT extern "C" __attribute__((visibility("default")))

// Rounded multiply / add that nvcc may not contract into an FMA: the
// kernels sum in the same order, with the same roundings, as the plain
// PyTorch versions beside them (separate elementwise multiply and add).
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

// A 4-byte copy from device to shared memory with cp.async (zero-filled
// when !valid), then the thread's copies committed as one group and
// waited for; a __syncthreads() then shows every thread's copies. The
// port's volumes have odd row lengths, so their rows are not 16-byte
// aligned: neither TMA nor 16-byte copies can describe them.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of the thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// An order key of a float for an order-free max: an unsigned integer
// that orders as the floats do (-0.0 below +0.0), every NaN above all
// (torch.amax propagates NaN). atomicMax on keys merges a max in any
// order; key 0 is below every float (no value yet).
__device__ __forceinline__ unsigned mad_max_key(float v) {
  const unsigned b = __float_as_uint(v);
  if (isnan(v)) return 0xffffffffu;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
// The float of a key (a NaN key gives the quiet NaN torch.amax returns).
__device__ __forceinline__ float mad_key_value(unsigned k) {
  if (k == 0xffffffffu) return __uint_as_float(0x7fc00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
// The simulation's divisor max(m, 1e-30) of a max key, as torch.clamp(m,
// min=1e-30) gives it (a NaN stays NaN).
__device__ __forceinline__ float mad_norm_divisor(unsigned k) {
  const float m = mad_key_value(k);
  return isnan(m) ? m : fmaxf(m, 1e-30f);
}

// float32 of 2*pi, as the JAX and PyTorch code adds it to atan2 angles.
#define MAD_TWO_PI_F 6.28318530717958647692f

// Ascending bitonic sort of S (a power of two) keys in shared memory by
// the whole block; ends with a barrier.
__device__ __forceinline__ void mad_bitonic_sort(unsigned long long* keys,
                                                 int S) {
  for (int size = 2; size <= S; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < S; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = keys[i], b = keys[j];
          const bool up = (i & size) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}
