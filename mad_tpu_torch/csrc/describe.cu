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
// from a field of up to ~2 GB that does not fit L2; each touches its own
// 32-byte sector on the upsampled octave), then each sample's atan2 /
// acos and zone test. Measured on the form before this one (one thread a
// lattice point in index order, shared-memory atomics; H100,
// scripts/torch_refine_describe_probe.py): its gathers alone took 57 % of
// its time on the bench map's upsampled octave, the zone scan with
// atan2 / acos 41 %, the atomics 1 %; in this form the gathers alone
// take 60-75 % and atan2 / acos 20 %. Design:
//   * the zone: phi's slot among the sorted distinct phi bounds (a binary
//     search) lists the few zones whose phi range meets it (the table of
//     kernels/orient.zone_table, K6's); they are tested from the last
//     down and the first that holds is the zone (the last that holds of
//     all zones, since no other zone can), in place of 16 tests a sample;
//   * a warp owns whole subregions: the wrapper lists the lattice points
//     region by region (kernels/describe.region_layout, each point's
//     (ix, iy, iz) packed in one int) and the kernel builds the lattice
//     coordinate from the index (-radius + 0.5 + i, or -2 radius + 1 + 2 i
//     upsampled; exact in float32), so no lattice or region array is
//     loaded a sample and a warp's samples are a compact rotated block;
//   * the warp counts its region's zones 32 samples at a time with one
//     __ballot_sync and __popc a zone present, into lane registers (the
//     lane of zone z holds its count), and writes each bin once: no
//     shared-memory histogram and no atomics;
//   * bounds first: each q_j is a chain of rounded multiplies and adds,
//     each monotone in its argument, so over the lattice's cube its
//     extremes, and any non-finite value, show at the 8 corners; every
//     warp tests the corners itself and a lane out of bounds writes its
//     zero row and skips its gathers;
//   * a block of kWarps warps a lane when the lanes fill the card, of
//     kWideWarps below kWideBelow lanes (the subunit's octaves: ~1 block
//     an SM, whose latency more warps hide).
#include "common.cuh"

namespace {

// Warps a block: kWarps, or kWideWarps when the lanes are fewer than
// kWideBelow (a launch of few blocks; more warps a lane hide its
// latency, while at many blocks the narrower block keeps more of them
// resident).
constexpr int kWarps = 8;
constexpr int kWideWarps = 32;
constexpr int kWideBelow = 4 * 132;
constexpr int kMaxZones = 64;            // two bins a warp lane
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The lattice coordinate of index i along an axis of n points.
__device__ __forceinline__ float lattice_at(int i, int n, bool upsampled) {
  return upsampled ? (float)(2 * i + 1 - n)
                   : add_rn((float)i, 0.5f - (float)(n / 2));
}

// q_j = ((l0 R[j] + l1 R[3 + j]) + l2 R[6 + j]) + c_j.
__device__ __forceinline__ float place(const float l[3], const float* R,
                                       const float* c, int j) {
  return add_rn(add_rn(add_rn(mul_rn(l[0], R[j]), mul_rn(l[1], R[3 + j])),
                       mul_rn(l[2], R[6 + j])),
                c[j]);
}

struct Zones {
  const float4* zb;     // [nz] (theta_min, phi_min, theta_max, phi_max)
  const float* edges;   // [nb]
  const int* start;     // [2 nb + 2]
  const int* zone;      // candidates of slot s: zone[start[s] .. start[s+1])
  int nb;
};

// Slot of phi: 0 below the first bound (or NaN), 2j + 1 on bound j, 2j + 2
// in the gap above it (kernels/orient.zone_table).
__device__ __forceinline__ int phi_slot(const Zones& t, float phi) {
  int lo = 0, hi = t.nb;                  // count of bounds <= phi
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.edges[mid] <= phi) lo = mid + 1;
    else hi = mid;
  }
  return lo == 0 ? 0 : (phi == t.edges[lo - 1] ? 2 * lo - 1 : 2 * lo);
}

// Gather lattice sample (ix, iy, iz) = packed of the lane: its nearest
// gradient g.
template <typename T>
__device__ __forceinline__ void sample_gather(
    const T* __restrict__ grad, int X, int Y, int Z, int goff, int n,
    bool upsampled, int packed, const float* R, const float* c,
    float g[3]) {
  const float l[3] = {lattice_at(packed & 0xff, n, upsampled),
                      lattice_at((packed >> 8) & 0xff, n, upsampled),
                      lattice_at(packed >> 16, n, upsampled)};
  const int dims[3] = {X, Y, Z};
  int id[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float q = place(l, R, c, j);
    int t = (int)ceilf(q - 0.5f) - (j == 0 ? goff : 0);
    t = t < 0 ? 0 : (t > dims[j] - 1 ? dims[j] - 1 : t);
    id[j] = t;
  }
  const T* gp = grad + (((long long)id[0] * Y + id[1]) * Z + id[2]) * 3;
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = load_f(gp + j);
}

// The zone of a sample's gradient g, or -1 when it is below zero_magn.
__device__ __forceinline__ int zone_of(float g[3], const float* R,
                                       const Zones& zt, float cutoff,
                                       float zero_magn) {
  const float magn = sqrtf(add_rn(add_rn(mul_rn(g[0], g[0]),
                                         mul_rn(g[1], g[1])),
                                  mul_rn(g[2], g[2])));
  if (magn < zero_magn) return -1;          // dropped from the counts
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
  const int s = phi_slot(zt, phi);
  for (int i = zt.start[s + 1] - 1; i >= zt.start[s]; --i) {
    const int z = zt.zone[i];
    const float4 b = zt.zb[z];
    const bool th_ok = (theta > b.x) && (theta < b.z);
    const bool sth_ok = (sth > b.x) && (sth < b.z);
    const bool ph_ok = (phi > b.y) && (phi < b.w);
    if ((th_ok || sth_ok) && ph_ok) return z;
  }
  return 0;
}

template <typename T, int kBlockWarps>
__global__ void __launch_bounds__(32 * kBlockWarps) descriptor_hist(
    const T* __restrict__ grad, int X, int Y, int Z, int rx, int ry, int rz,
    int goff, const float* __restrict__ coords,
    const float* __restrict__ rfinal,
    const unsigned char* __restrict__ valid_in, int n, int upsampled,
    const int* __restrict__ samples, const int* __restrict__ region_start,
    int nregions, const float* __restrict__ bounds, int nzones,
    const float* __restrict__ edges, int nb,
    const int* __restrict__ slot_start, const int* __restrict__ slot_zone,
    int n_cand, float cutoff, float zero_magn, short* __restrict__ out,
    unsigned char* __restrict__ ok_out) {
  extern __shared__ float4 smem[];
  const int lane_id = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nbins = nregions * nzones;
  short* row = out + (long long)lane_id * nbins;
  float R[9], c[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = __ldg(rfinal + lane_id * 9 + k);
#pragma unroll
  for (int j = 0; j < 3; ++j) c[j] = __ldg(coords + lane_id * 3 + j);

  // the 8 corners, one a lane of every warp: the same verdict everywhere
  bool inb = true;
  if (lane < 8) {
    const float lo = lattice_at(0, n, upsampled),
                hi_l = lattice_at(n - 1, n, upsampled);
    const float l[3] = {(lane & 4) ? hi_l : lo, (lane & 2) ? hi_l : lo,
                        (lane & 1) ? hi_l : lo};
    const int real[3] = {rx, ry, rz};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float q = place(l, R, c, j);
      inb = inb && (q >= 0.0f) && (q <= (float)(real[j] - 1));
    }
  }
  const bool ok = __all_sync(kFull, inb) && valid_in[lane_id] != 0;
  if (!ok) {
    for (int k = threadIdx.x; k < nbins; k += blockDim.x) row[k] = 0;
    if (threadIdx.x == 0) ok_out[lane_id] = 0;
    return;
  }

  float4* zb = smem;                                       // [nzones]
  float* s_edges = reinterpret_cast<float*>(zb + nzones);  // [nb]
  int* s_start = reinterpret_cast<int*>(s_edges + nb);     // [2 nb + 2]
  int* s_zone = s_start + 2 * nb + 2;                      // [n_cand]
  for (int k = threadIdx.x; k < 4 * nzones; k += blockDim.x)
    reinterpret_cast<float*>(zb)[k] = bounds[k];
  for (int k = threadIdx.x; k < nb; k += blockDim.x) s_edges[k] = edges[k];
  for (int k = threadIdx.x; k < 2 * nb + 2; k += blockDim.x)
    s_start[k] = slot_start[k];
  for (int k = threadIdx.x; k < n_cand; k += blockDim.x)
    s_zone[k] = slot_zone[k];
  __syncthreads();
  const Zones zt{zb, s_edges, s_start, s_zone, nb};

  for (int r = warp; r < nregions; r += kBlockWarps) {
    const int s0 = __ldg(region_start + r), s1 = __ldg(region_start + r + 1);
    int count_lo = 0, count_hi = 0;        // zones lane and lane + 32
    for (int s = s0; s < s1; s += 32) {
      int zone = -1;
      if (s + lane < s1) {
        float g[3];
        sample_gather(grad, X, Y, Z, goff, n, upsampled != 0,
                      __ldg(samples + s + lane), R, c, g);
        zone = zone_of(g, R, zt, cutoff, zero_magn);
      }
      unsigned todo = __ballot_sync(kFull, zone >= 0);
      while (todo) {
        const int z = __shfl_sync(kFull, zone, __ffs(todo) - 1);
        const unsigned same = __ballot_sync(kFull, zone == z);
        const int m = __popc(same);
        count_lo += lane == z ? m : 0;
        count_hi += lane + 32 == z ? m : 0;
        todo &= ~same;
      }
    }
    short* bins = row + r * nzones;
    if (lane < nzones) bins[lane] = (short)count_lo;
    if (lane + 32 < nzones) bins[lane + 32] = (short)count_hi;
  }
  if (threadIdx.x == 0) ok_out[lane_id] = 1;
}

template <typename T>
int launch(const T* grad, int X, int Y, int Z, int rx, int ry, int rz,
           int goff, const float* coords, const float* rfinal,
           const unsigned char* valid_in, int L, int n, int upsampled,
           const int* samples, const int* region_start, int nregions,
           const float* bounds, int nzones, const float* edges, int nb,
           const int* slot_start, const int* slot_zone, int n_cand,
           float cutoff, float zero_magn, short* out, unsigned char* ok_out,
           cudaStream_t stream) {
  const size_t smem = (size_t)(4 * nzones + nb) * sizeof(float) +
                      (size_t)(2 * nb + 2 + n_cand) * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (L < kWideBelow)
    descriptor_hist<T, kWideWarps><<<L, 32 * kWideWarps, smem, stream>>>(
        grad, X, Y, Z, rx, ry, rz, goff, coords, rfinal, valid_in, n,
        upsampled, samples, region_start, nregions, bounds, nzones, edges,
        nb, slot_start, slot_zone, n_cand, cutoff, zero_magn, out, ok_out);
  else
    descriptor_hist<T, kWarps><<<L, 32 * kWarps, smem, stream>>>(
        grad, X, Y, Z, rx, ry, rz, goff, coords, rfinal, valid_in, n,
        upsampled, samples, region_start, nregions, bounds, nzones, edges,
        nb, slot_start, slot_zone, n_cand, cutoff, zero_magn, out, ok_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad_dtype: 0 = float32, 1 = bfloat16 (the (X, Y, Z, 3) field); n the
// lattice's points an axis; samples the lattice indices region by region,
// each (ix | iy << 8 | iz << 16), region r's from region_start[r]; the
// zone table from kernels/orient.zone_table; valid_in / ok_out one byte a
// lane (torch.bool).
MAD_EXPORT int mad_descriptor_hist(
    const void* grad, int grad_dtype, int X, int Y, int Z, int rx, int ry,
    int rz, int goff, const float* coords, const float* rfinal,
    const unsigned char* valid_in, int L, int n, int upsampled,
    const int* samples, const int* region_start, int nregions,
    const float* bounds, int nzones, const float* edges, int nb,
    const int* slot_start, const int* slot_zone, int n_cand, float cutoff,
    float zero_magn, short* out, unsigned char* ok_out,
    cudaStream_t stream) {
  if (L == 0) return 0;
  if (nzones > kMaxZones || n < 1 || n > 255 || nregions < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (grad_dtype == 0)
    return launch(static_cast<const float*>(grad), X, Y, Z, rx, ry, rz, goff,
                  coords, rfinal, valid_in, L, n, upsampled, samples,
                  region_start, nregions, bounds, nzones, edges, nb,
                  slot_start, slot_zone, n_cand, cutoff, zero_magn, out,
                  ok_out, stream);
  return launch(static_cast<const __nv_bfloat16*>(grad), X, Y, Z, rx, ry, rz,
                goff, coords, rfinal, valid_in, L, n, upsampled, samples,
                region_start, nregions, bounds, nzones, edges, nb,
                slot_start, slot_zone, n_cand, cutoff, zero_magn, out,
                ok_out, stream);
}
