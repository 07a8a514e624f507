// K7: rotation-invariant descriptor histograms, one block per lane.
//
// Replaces mad_tpu/ops/describe.py:79-152 (_describe_body's
// one_descriptor) with the zone assignment of mad_tpu/ops/orient.py:141-160
// (zone_assign_fn). Per lane (anchor coord c, frame R = rfinal):
//   1. lattice point p -> q = p @ R + c (p @ R summed over i in order);
//   2. bounds test 0 <= q <= real_extent - 1; any point outside zeroes the
//      whole row (ok = valid_in & all in bounds);
//   3. nearest gather at ceil(q - 0.5), clamped (.5 goes to the lower index);
//   4. g -> g / max(|g|, 1e-30) where |g| > cutoff;
//   5. d = g @ R^T (canonical frame);
//   6. zone = the LAST of the zones whose 4-decimal bounds hold strictly
//      for (theta or theta + 2pi, phi), zone 0 when none does;
//   7. samples with |g| < zero_magn are dropped;
//   8. count per (region, zone) -> int16 row of nregions * nzones bins.
// Every multiply and add rounds on its own, in the order of the plain
// PyTorch version (kernels/describe.py), so the two agree bit for bit up
// to the last-ulp differences of atan2f / acosf between libraries.
//
// Offset form (capacity mode, describe.py:167-196 describe_shard, its
// gathers at describe.py:108-115): grad is a shard's x-slab extended by its
// neighbours' rows, its row 0 global row goff. The lattice and the bounds
// test stay global; the nearest sample's global index, minus goff on x,
// is gathered from the block (clamped to it), so each sample is the one
// the single-device kernel reads. The halo of radius * stride * 2 rows
// covers the rotated lattice of every lane the shard owns. The
// single-device call is goff = 0.
//
// Bound: the random 12-byte gathers of the gradient field (4096 a lane,
// from a field of up to ~2 GB that does not fit L2) and the per-point zone
// test (16 zones x a few compares). Design: one block of 256 threads per
// lane; the lane's histogram, frame and zone table live in shared memory
// and are bumped with shared-memory atomics, so the only device-memory
// traffic is the gathers and one 2 KB row write a lane; the (L, 4096)
// zone and magnitude intermediates of the plain version never exist.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void descriptor_hist(
    const T* __restrict__ grad, int X, int Y, int Z, int rx, int ry, int rz,
    int goff, const float* __restrict__ coords,
    const float* __restrict__ rfinal,
    const unsigned char* __restrict__ valid_in,
    const float* __restrict__ lattice, const int* __restrict__ region,
    int P, const float* __restrict__ bounds, int nzones, int nregions,
    float cutoff, float zero_magn, short* __restrict__ out,
    unsigned char* __restrict__ ok_out) {
  extern __shared__ int hist[];                 // [nregions * nzones]
  __shared__ float R[9], c[3], hi[3];
  __shared__ float zb[64 * 4];
  __shared__ int oob;
  const int lane = blockIdx.x;
  const int nbins = nregions * nzones;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) hist[k] = 0;
  if (threadIdx.x < 9) R[threadIdx.x] = rfinal[lane * 9 + threadIdx.x];
  if (threadIdx.x < 3) {
    c[threadIdx.x] = coords[lane * 3 + threadIdx.x];
    hi[threadIdx.x] = (float)((threadIdx.x == 0 ? rx : threadIdx.x == 1
                                                        ? ry : rz) - 1);
  }
  for (int k = threadIdx.x; k < nzones * 4; k += blockDim.x) zb[k] = bounds[k];
  if (threadIdx.x == 0) oob = 0;
  __syncthreads();

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float l0 = lattice[3 * p], l1 = lattice[3 * p + 1],
                l2 = lattice[3 * p + 2];
    float q[3];
    int id[3];
    const int dims[3] = {X, Y, Z};
    bool inb = true;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      q[j] = add_rn(add_rn(add_rn(mul_rn(l0, R[j]), mul_rn(l1, R[3 + j])),
                           mul_rn(l2, R[6 + j])),
                    c[j]);
      inb = inb && (q[j] >= 0.0f) && (q[j] <= hi[j]);
      int t = (int)ceilf(q[j] - 0.5f) - (j == 0 ? goff : 0);
      t = t < 0 ? 0 : (t > dims[j] - 1 ? dims[j] - 1 : t);
      id[j] = t;
    }
    if (!inb) oob = 1;
    const T* gp = grad + (((long long)id[0] * Y + id[1]) * Z + id[2]) * 3;
    float g[3] = {load_f(gp), load_f(gp + 1), load_f(gp + 2)};
    const float magn = sqrtf(add_rn(add_rn(mul_rn(g[0], g[0]),
                                           mul_rn(g[1], g[1])),
                                    mul_rn(g[2], g[2])));
    if (magn < zero_magn) continue;           // dropped from the counts
    if (magn > cutoff) {
      const float m = fmaxf(magn, 1e-30f);
      g[0] = __fdiv_rn(g[0], m);
      g[1] = __fdiv_rn(g[1], m);
      g[2] = __fdiv_rn(g[2], m);
    }
    float d[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      d[i] = add_rn(add_rn(mul_rn(g[0], R[3 * i]), mul_rn(g[1], R[3 * i + 1])),
                    mul_rn(g[2], R[3 * i + 2]));
    float theta = atan2f(d[1], d[0]);
    if (theta < 0.0f) theta = add_rn(theta, MAD_TWO_PI_F);
    const float phi = acosf(fminf(fmaxf(d[2], -1.0f), 1.0f));
    const float sth = add_rn(theta, MAD_TWO_PI_F);
    int zone = -1;
    for (int z = 0; z < nzones; ++z) {
      const float* b = zb + 4 * z;
      const bool th_ok = (theta > b[0]) && (theta < b[2]);
      const bool sth_ok = (sth > b[0]) && (sth < b[2]);
      const bool ph_ok = (phi > b[1]) && (phi < b[3]);
      if ((th_ok || sth_ok) && ph_ok) zone = z;
    }
    if (zone < 0) zone = 0;
    atomicAdd(&hist[region[p] * nzones + zone], 1);
  }
  __syncthreads();
  const bool ok = valid_in[lane] && !oob;
  short* row = out + (long long)lane * nbins;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x)
    row[k] = ok ? (short)hist[k] : (short)0;
  if (threadIdx.x == 0) ok_out[lane] = ok ? 1 : 0;
}

}  // namespace

// grad_dtype: 0 = float32, 1 = bfloat16 (the (X, Y, Z, 3) field).
MAD_EXPORT int mad_descriptor_hist(
    const void* grad, int grad_dtype, int X, int Y, int Z, int rx, int ry,
    int rz, int goff, const float* coords, const float* rfinal,
    const unsigned char* valid_in, int L, const float* lattice,
    const int* region, int P, const float* bounds, int nzones, int nregions,
    float cutoff, float zero_magn, short* out, unsigned char* ok_out,
    cudaStream_t stream) {
  if (L == 0) return 0;
  if (nzones > 64) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)nregions * nzones * sizeof(int);
  if (grad_dtype == 0) {
    descriptor_hist<float><<<L, kThreads, smem, stream>>>(
        static_cast<const float*>(grad), X, Y, Z, rx, ry, rz, goff, coords,
        rfinal, valid_in, lattice, region, P, bounds, nzones, nregions,
        cutoff, zero_magn, out, ok_out);
  } else {
    descriptor_hist<__nv_bfloat16><<<L, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(grad), X, Y, Z, rx, ry, rz, goff,
        coords, rfinal, valid_in, lattice, region, P, bounds, nzones,
        nregions, cutoff, zero_magn, out, ok_out);
  }
  return static_cast<int>(cudaGetLastError());
}
