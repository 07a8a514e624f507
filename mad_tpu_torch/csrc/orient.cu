// K6: canonical orientation frames, one block per anchor.
//
// Replaces mad_tpu/ops/orient.py:212 (_orient_bodies; its per-anchor
// one_anchor :248-336 with zone_hist_fn, _quantize and _first_k_flagged
// :118-173). Per anchor of one octave (stride 1, or 2 on the upsampled
// octave), as the plain version (kernels/orient.py) computes it:
//   1. border test (the upper bound conservative by one voxel) and the
//      clamped (2r+1)^3 gradient patch; d = g / max(|g|, 1e-30), weight
//      w = sphere mask * (|g| >= cutoff);
//   2. the weighted zone histogram of d with the strict 4-decimal bounds
//      (a direction may fall in several zones or none), quantized to
//      int(c / max(max, 1e-30) * 50);
//   3. up to M main bins with q > 0.8 * max q, the first flagged ones in
//      ascending order (the anchor is rejected with none or more than M);
//   4. per main bin: d @ rot_to_pole[main]^T, its histogram, zones
//      1..Z-2 re-quantized by int(q / max(max, 1) * 50), up to S
//      secondary bins the same way;
//   5. R_final = Rz(-(p_theta - belt_first)[sec]) @ rot_to_pole[main].
// Each product and sum is rounded on its own in the plain version's order;
// atan2f / acosf as core/geometry.spherical_angles calls them.
//
// Offset form (capacity mode, orient.py:356-387 orient_shard, its gathers
// at orient.py:255-263): grad is a shard's x-slab extended by its
// neighbours' rows, its row 0 global row goff. The border test and the
// clamped patch centre stay global; the gathers move into the block (x
// minus goff, clamped to it). The halo of radius * stride * 2 rows covers
// the patch of every anchor inside the border that the shard owns; the
// others are rejected by the border test and written as zeros. The
// single-device call is goff = 0.
//
// Histogram sums: each weight is rounded to a multiple of 2^-40 and summed
// as 64-bit integers, so a sum is exact and independent of the order of
// the adds and of how the patch is split: the kernel is deterministic.
// With the default Gaussian window off every weight is 0 or 1 and the
// counts are the plain version's integer counts. With gw_sig != 0 the
// plain version's float sums round differently (relative 1e-7), which can
// flip a quantized bin that lies within rounding of an integer; the tests
// hold both to the same agreement share as at gw_sig = 0
// (tests/test_torch_orient_refine_cuda.py).
//
// Bound: per anchor the distinct patch voxels (4,913 x 12 B at the default
// patch, overlapping patches counted once) and, per sample of nonzero
// weight and histogram, atan2 / acos, a rotation and the zone tests. It is
// bound by operations, far below the card's rate; the launch's time is
// the latency of one anchor's chain. Design, for that chain:
//   * one thread-block cluster of kCluster CTAs per anchor
//     (cudaLaunchKernelEx with a cluster dimension); each CTA takes a
//     slice of the samples and keeps their unit directions and weights in
//     shared memory for the second pass (no second gather, sqrt or
//     division);
//   * each CTA sums into its own histograms, then adds them into the
//     leader CTA's through distributed shared memory
//     (cluster.map_shared_rank), with cluster.sync() between the passes;
//     the leader selects the main bins and the other CTAs read them from
//     its shared memory;
//   * zone lookup: a host table (kernels/orient.zone_table) lists, for the
//     sorted distinct phi bounds and the open gaps between them, the zones
//     whose closed phi range meets each; a sample tests only the zones of
//     its phi slot (one belt inside a gap), with the same strict
//     4-decimal tests as before, so the zones it lands in are unchanged;
//   * warp-aggregated adds: the lanes of a warp that land in the same zone
//     (__match_any_sync) sum their fixed-point weights (__reduce_add_sync
//     on three 24-bit parts) and one lane adds the sum;
//   * selection by warps: maxima by shuffles, the first k flagged bins by
//     ballots and prefix counts (no per-thread flag arrays), one warp per
//     main bin for the secondary bins and the frames.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMain = 8;
constexpr int kMaxSec = 16;
constexpr int kMaxZones = 256;
constexpr int kMaxPatch = 1 << 23;  // P weights of 2^40 sum within 64 bits
constexpr int kCluster = 8;         // CTAs an anchor (portable cluster size)
constexpr size_t kMaxSmem = 232448; // shared memory a CTA may use (sm_90)
constexpr float kFixedScale = 1099511627776.0f;  // 2^40
constexpr double kFixedInv = 1.0 / 1099511627776.0;

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

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

// Patch sample p of the anchor at ``safe``: its direction and weight.
template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ grad, int X,
                                        int Y, int Z, const int safe[3],
                                        int radius, int stride, int p,
                                        const float* __restrict__ mask,
                                        float cutoff, float d[3]) {
  const int D = 2 * radius + 1;
  const int o[3] = {p / (D * D), (p / D) % D, p % D};
  const int dims[3] = {X, Y, Z};
  int q[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int t = safe[j] + (o[j] - radius) * stride;
    q[j] = t < 0 ? 0 : (t > dims[j] - 1 ? dims[j] - 1 : t);
  }
  const T* gp = grad + (((long long)q[0] * Y + q[1]) * Z + q[2]) * 3;
  const float g0 = load_f(gp), g1 = load_f(gp + 1), g2 = load_f(gp + 2);
  const float magn = sqrtf(add_rn(add_rn(mul_rn(g0, g0), mul_rn(g1, g1)),
                                  mul_rn(g2, g2)));
  const float m = magn < 1e-30f ? 1e-30f : magn;
  d[0] = __fdiv_rn(g0, m);
  d[1] = __fdiv_rn(g1, m);
  d[2] = __fdiv_rn(g2, m);
  return mul_rn(__ldg(mask + p), magn >= cutoff ? 1.0f : 0.0f);
}

__device__ __forceinline__ unsigned long long fixed(float w) {
  return __float2ull_rn(w * kFixedScale);  // exact: a power-of-two scale
}

__device__ __forceinline__ float count(unsigned long long h) {
  return __double2float_rn(__ull2double_rn(h) * kFixedInv);
}

// int(c / m * 50) of every bin, m = max(max bin, lo)
// (kernels/orient._quantize with lo = 1e-30; the secondary
// re-quantization with lo = 1 on ints).
__device__ __forceinline__ int quantize(float c, float m) {
  return (int)mul_rn(__fdiv_rn(c, m), 50.0f);
}

// core/geometry.rotation_about_z: axis_angle_mat((0, 0, 1), angle).
__device__ __forceinline__ void rot_z(float angle, float R[9]) {
  const float h = mul_rn(angle, 0.5f);
  const float a = cosf(h), s = sinf(h);
  const float b = mul_rn(-0.0f, s), c = mul_rn(-0.0f, s), d = mul_rn(-1.0f, s);
  const float aa = mul_rn(a, a), bb = mul_rn(b, b), cc = mul_rn(c, c),
              dd = mul_rn(d, d);
  const float bc = mul_rn(b, c), ad = mul_rn(a, d), ac = mul_rn(a, c),
              ab = mul_rn(a, b), bd = mul_rn(b, d), cd = mul_rn(c, d);
  R[0] = sub_rn(sub_rn(add_rn(aa, bb), cc), dd);
  R[1] = mul_rn(2.0f, add_rn(bc, ad));
  R[2] = mul_rn(2.0f, sub_rn(bd, ac));
  R[3] = mul_rn(2.0f, sub_rn(bc, ad));
  R[4] = sub_rn(sub_rn(add_rn(aa, cc), bb), dd);
  R[5] = mul_rn(2.0f, add_rn(cd, ab));
  R[6] = mul_rn(2.0f, add_rn(bd, ac));
  R[7] = mul_rn(2.0f, sub_rn(cd, ab));
  R[8] = sub_rn(sub_rn(add_rn(aa, dd), bb), cc);
}

// Zone tables in shared memory: the strict bounds, the sorted distinct phi
// bounds and each phi slot's candidate zones (kernels/orient.zone_table).
struct Zones {
  const float* zb;      // [nz][4]
  const float* edges;   // [nb]
  const int* start;     // [2 nb + 2]
  const int* zone;      // candidates of slot s: zone[start[s] .. start[s+1])
  int nb;
};

// Slot of phi: 0 below the first bound (or NaN), 2j + 1 on bound j, 2j + 2
// in the gap above it.
__device__ __forceinline__ int phi_slot(const Zones& t, float phi) {
  int lo = 0, hi = t.nb;                  // count of bounds <= phi
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.edges[mid] <= phi) lo = mid + 1;
    else hi = mid;
  }
  return lo == 0 ? 0 : (phi == t.edges[lo - 1] ? 2 * lo - 1 : 2 * lo);
}

// Add the fixed-point weight fw of each lane's direction d (if ``active``)
// to every zone whose strict bounds hold for it. Called by all 32 lanes of
// the warp together: lanes that land in the same zone sum their weights
// first and one of them adds the sum.
__device__ __forceinline__ void add_to_zones(const float d[3],
                                             unsigned long long fw,
                                             bool active, const Zones& t,
                                             unsigned long long* hist) {
  unsigned hits = 0;                      // up to 4 zones, 8 bits each
  int nh = 0;
  if (active) {
    float theta = atan2f(d[1], d[0]);
    if (theta < 0.0f) theta = add_rn(theta, MAD_TWO_PI_F);
    const float sth = add_rn(theta, MAD_TWO_PI_F);
    const float c = d[2] < -1.0f ? -1.0f : (d[2] > 1.0f ? 1.0f : d[2]);
    const float phi = acosf(c);
    const int s = phi_slot(t, phi);
    for (int i = t.start[s]; i < t.start[s + 1]; ++i) {
      const int z = t.zone[i];
      const float* b = t.zb + 4 * z;
      if (!(phi > b[1] && phi < b[3])) continue;
      if ((theta > b[0] && theta < b[2]) || (sth > b[0] && sth < b[2])) {
        if (nh < 4) hits |= static_cast<unsigned>(z) << (8 * nh++);
        else atomicAdd(hist + z, fw);     // a fifth zone: rare, exact
      }
    }
  }
  const unsigned lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int z = h < nh ? static_cast<int>((hits >> (8 * h)) & 0xffu) : -1;
    const unsigned act = __ballot_sync(0xffffffffu, z >= 0);
    if (act == 0) break;
    if (z >= 0) {
      const unsigned grp = __match_any_sync(act, z);
      const unsigned long long p0 = __reduce_add_sync(
          grp, static_cast<unsigned>(fw & 0xffffffull));
      const unsigned long long p1 = __reduce_add_sync(
          grp, static_cast<unsigned>((fw >> 24) & 0xffffffull));
      const unsigned long long p2 = __reduce_add_sync(
          grp, static_cast<unsigned>(fw >> 48));
      if (lane == static_cast<unsigned>(__ffs(grp) - 1))
        atomicAdd(hist + z, p0 + (p1 << 24) + (p2 << 48));
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kPerLane = kMaxZones / 32;  // bins a lane holds

// kernels/orient._first_k_flagged by one warp: bins b = lane + 32 i (i <
// kPerLane, b < n) with flag[i]; out[0..k) gets the first k flagged bins
// in ascending order, then the unflagged ones; returns the flagged count.
__device__ __forceinline__ int warp_first_k(const bool (&flag)[kPerLane],
                                            int n, int k, int* out) {
  const unsigned lane = threadIdx.x & 31, lt = (1u << lane) - 1u;
  int n_flag = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    n_flag += __popc(__ballot_sync(0xffffffffu,
                                   lane + 32 * i < n && flag[i]));
  int f_before = 0, u_before = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int b = lane + 32 * i;
    const bool in = b < n;
    const unsigned fm = __ballot_sync(0xffffffffu, in && flag[i]);
    const unsigned um = __ballot_sync(0xffffffffu, in && !flag[i]);
    if (in) {
      const int r = flag[i] ? f_before + __popc(fm & lt)
                            : n_flag + u_before + __popc(um & lt);
      if (r < k) out[r] = b;
    }
    f_before += __popc(fm);
    u_before += __popc(um);
  }
  return n_flag;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) orient_kernel(
    const T* __restrict__ grad, int X, int Y, int Z, int rx, int ry, int rz,
    int goff, const int* __restrict__ coords,
    const unsigned char* __restrict__ valid, int radius, int stride,
    const float* __restrict__ mask,
    const float* __restrict__ bounds, int nz,
    const float* __restrict__ edges, int nb,
    const int* __restrict__ slot_start, const int* __restrict__ slot_zone,
    int n_cand, int n_local,
    const float* __restrict__ rot_to_pole, const float* __restrict__ p_theta,
    const float* __restrict__ belt_first, int M, int S, float cutoff,
    int* __restrict__ mains_out, int* __restrict__ secs_out,
    float* __restrict__ rfin_out, unsigned char* __restrict__ ok_out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 samples[];                    // [n_local]
  unsigned long long* hist =
      reinterpret_cast<unsigned long long*>(samples + n_local);
  float* zb = reinterpret_cast<float*>(hist + (1 + M) * nz);
  float* s_edges = zb + 4 * nz;
  int* s_start = reinterpret_cast<int*>(s_edges + nb);
  int* s_zone = s_start + 2 * nb + 2;
  __shared__ int safe[3], s_ok, s_nmain, s_main[kMaxMain];
  __shared__ int s_sec[kMaxMain][kMaxSec];
  __shared__ float s_R[kMaxMain * 9];
  const unsigned rank = cluster.block_rank();
  const int k = blockIdx.x / cluster.num_blocks(), tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < 4 * nz; i += blockDim.x) zb[i] = bounds[i];
  for (int i = tid; i < nb; i += blockDim.x) s_edges[i] = edges[i];
  for (int i = tid; i < 2 * nb + 2; i += blockDim.x)
    s_start[i] = slot_start[i];
  for (int i = tid; i < n_cand; i += blockDim.x) s_zone[i] = slot_zone[i];
  for (int i = tid; i < (1 + M) * nz; i += blockDim.x) hist[i] = 0ull;
  if (tid == 0) {
    const int rs[3] = {rx, ry, rz};
    const int half = radius * stride;
    bool ok = valid[k] != 0;
    for (int j = 0; j < 3; ++j) {
      const int c = coords[3 * k + j];
      ok = ok && (c - half >= 0) && (c + half + 1 <= rs[j] - 1);
      const int lo = c < half ? half : c;
      const int hi = rs[j] - half - 1 < half ? half : rs[j] - half - 1;
      safe[j] = lo < hi ? lo : hi;
    }
    s_ok = ok;
    s_nmain = 0;
    for (int m = 0; m < kMaxMain; ++m) s_main[m] = 0;
  }
  // every CTA's histograms are zeroed before any is added to
  cluster.sync();
  const Zones zt{zb, s_edges, s_start, s_zone, nb};
  const int at[3] = {safe[0] - goff, safe[1], safe[2]};  // in the block
  const int D = 2 * radius + 1, P = D * D * D;
  const int p0 = static_cast<int>(rank) * n_local;
  const int iters = (n_local + kThreads - 1) / kThreads;
  const bool ok = s_ok;                  // the same in every CTA

  // Pass 1: the CTA's samples, kept, and their zone histogram.
  if (ok) {
    for (int it = 0; it < iters; ++it) {
      const int i = it * kThreads + tid, p = p0 + i;
      float d[3] = {0.0f, 0.0f, 0.0f};
      float w = 0.0f;
      if (i < n_local && p < P) {
        w = sample(grad, X, Y, Z, at, radius, stride, p, mask, cutoff, d);
        samples[i] = make_float4(d[0], d[1], d[2], w);
      }
      add_to_zones(d, fixed(w), w != 0.0f, zt, hist);
    }
  }
  __syncthreads();
  if (ok && rank != 0) {
    unsigned long long* lead = cluster.map_shared_rank(hist, 0);
    for (int z = tid; z < nz; z += blockDim.x)
      if (hist[z]) atomicAdd(lead + z, hist[z]);
  }
  cluster.sync();

  // The leader's first warp: quantize, the main bins.
  if (ok && rank == 0 && warp == 0) {
    float c[kPerLane];
    int q[kPerLane];
    bool flag[kPerLane];
    float mx = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int z = lane + 32 * i;
      c[i] = z < nz ? count(hist[z]) : 0.0f;
      mx = fmaxf(mx, c[i]);
    }
    mx = warp_max(mx);
    mx = mx < 1e-30f ? 1e-30f : mx;
    int qmax = 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      q[i] = lane + 32 * i < nz ? quantize(c[i], mx) : 0;
      qmax = max(qmax, q[i]);
    }
    qmax = warp_max(qmax);
    const float thr = mul_rn(static_cast<float>(qmax), 0.8f);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      flag[i] = static_cast<float>(q[i]) > thr;
    const int n_main = warp_first_k(flag, nz, M, s_main);
    if (lane == 0) {
      s_nmain = n_main;
      s_ok = n_main >= 1 && n_main <= M && qmax > 0;
    }
  }
  cluster.sync();
  // every CTA takes the leader's main bins
  int n_main = 0;
  bool ok2 = false;
  if (ok) {
    n_main = *cluster.map_shared_rank(&s_nmain, 0);
    ok2 = *cluster.map_shared_rank(&s_ok, 0) != 0;
    const int* lead_main = cluster.map_shared_rank(s_main, 0);
    for (int i = tid; i < kMaxMain * 9; i += blockDim.x)
      s_R[i] = i / 9 < n_main ? rot_to_pole[lead_main[i / 9] * 9 + i % 9]
                              : 0.0f;
  }
  __syncthreads();

  // Pass 2: the kept samples rotated by each main bin, their histograms.
  if (ok2) {
    for (int it = 0; it < iters; ++it) {
      const int i = it * kThreads + tid;
      const bool have = i < n_local && p0 + i < P;
      const float4 v = have ? samples[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const unsigned long long fw = fixed(v.w);
      for (int m = 0; m < n_main; ++m) {
        const float* R = s_R + 9 * m;
        float d[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          d[j] = add_rn(add_rn(mul_rn(v.x, R[3 * j]),
                               mul_rn(v.y, R[3 * j + 1])),
                        mul_rn(v.z, R[3 * j + 2]));
        add_to_zones(d, fw, have && v.w != 0.0f, zt, hist + (1 + m) * nz);
      }
    }
  }
  __syncthreads();
  if (ok2 && rank != 0) {
    unsigned long long* lead = cluster.map_shared_rank(hist, 0);
    for (int i = tid; i < n_main * nz; i += blockDim.x)
      if (hist[nz + i]) atomicAdd(lead + nz + i, hist[nz + i]);
  }
  cluster.sync();
  if (rank != 0) return;                 // no CTA reads another's memory now

  // The leader: one warp per main slot, its secondary bins and lanes.
  if (warp < M) {
    const int m = warp;
    const bool active = ok2 && m < n_main;
    int m1 = 0, n_sec = 0;
    if (active) {
      const unsigned long long* h = hist + (1 + m) * nz;
      float c[kPerLane];
      bool flag[kPerLane];
      float mx = 0.0f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int z = lane + 32 * i;
        c[i] = z < nz ? count(h[z]) : 0.0f;
        mx = fmaxf(mx, c[i]);
      }
      mx = warp_max(mx);
      mx = mx < 1e-30f ? 1e-30f : mx;
      // bins b = z - 1 of the zones 1 .. nz - 2
      int q[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int z = lane + 32 * i + 1;
        q[i] = z < nz - 1 ? quantize(count(h[z]), mx) : 0;
        m1 = max(m1, q[i]);
      }
      m1 = warp_max(m1);
      const float den = static_cast<float>(m1 < 1 ? 1 : m1);
      int nqmax = 0;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        q[i] = quantize(static_cast<float>(q[i]), den);
        nqmax = max(nqmax, q[i]);
      }
      nqmax = warp_max(nqmax);
      const float thr = mul_rn(static_cast<float>(nqmax), 0.8f);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        flag[i] = static_cast<float>(q[i]) > thr && m1 > 0;
      if (lane < kMaxSec) s_sec[m][lane] = 0;
      __syncwarp();
      n_sec = warp_first_k(flag, nz - 2, S, s_sec[m]);
      __syncwarp();
    }
    const bool main_ok = active && m1 > 0 && n_sec >= 1 && n_sec <= S;
    if (lane == 0) mains_out[k * M + m] = s_main[m];
    for (int s = lane; s < S; s += 32) {
      const long long ln = (static_cast<long long>(k) * M + m) * S + s;
      float* out = rfin_out + ln * 9;
      if (active) {
        const int sb = s_sec[m][s] + 1;
        float Rz[9];
        rot_z(-sub_rn(p_theta[sb], belt_first[sb]), Rz);
        const float* Rm = s_R + 9 * m;
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j)
            out[3 * i + j] = add_rn(add_rn(mul_rn(Rz[3 * i], Rm[j]),
                                           mul_rn(Rz[3 * i + 1], Rm[3 + j])),
                                    mul_rn(Rz[3 * i + 2], Rm[6 + j]));
        secs_out[ln] = sb;
      } else {
        for (int i = 0; i < 9; ++i) out[i] = 0.0f;
        secs_out[ln] = 0;
      }
      ok_out[ln] = (main_ok && s < n_sec) ? 1 : 0;
    }
  }
}

template <typename T>
int launch(const T* grad, int X, int Y, int Z, int rx, int ry, int rz,
           int goff, const int* coords, const unsigned char* valid, int K,
           int radius, int stride, const float* mask, const float* bounds,
           int nz, const float* edges, int nb, const int* slot_start,
           const int* slot_zone, int n_cand, const float* rot_to_pole,
           const float* p_theta, const float* belt_first, int M, int S,
           float cutoff, int* mains, int* secs, float* rfin,
           unsigned char* ok, cudaStream_t stream) {
  const int D = 2 * radius + 1, P = D * D * D;
  const int n_local = (P + kCluster - 1) / kCluster;
  const size_t smem = (size_t)n_local * sizeof(float4)
                      + (size_t)(1 + M) * nz * sizeof(unsigned long long)
                      + (size_t)(4 * nz + nb) * sizeof(float)
                      + (size_t)(2 * nb + 2 + n_cand) * sizeof(int);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      orient_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(K) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, orient_kernel<T>, grad, X, Y, Z, rx, ry, rz,
                           goff, coords, valid, radius, stride, mask, bounds,
                           nz, edges, nb, slot_start, slot_zone, n_cand,
                           n_local, rot_to_pole, p_theta, belt_first, M, S,
                           cutoff, mains, secs, rfin, ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad_dtype: 0 = float32, 1 = bfloat16 (the (X, Y, Z, 3) field); coords
// (K, 3) int32 voxel coords; tables as ops/orient._OrientTables builds them
// (the zone table from kernels/orient.zone_table).
MAD_EXPORT int mad_orient(const void* grad, int grad_dtype, int X, int Y,
                          int Z, int rx, int ry, int rz, int goff,
                          const int* coords,
                          const unsigned char* valid, int K, int radius,
                          int stride, const float* mask, const float* bounds,
                          int nz, const float* edges, int nb,
                          const int* slot_start, const int* slot_zone,
                          int n_cand, const float* rot_to_pole,
                          const float* p_theta, const float* belt_first,
                          int M, int S, float cutoff, int* mains, int* secs,
                          float* rfin, unsigned char* ok,
                          cudaStream_t stream) {
  if (K == 0) return 0;
  const long long D = 2LL * radius + 1;
  if (M < 1 || M > kMaxMain || S < 1 || S > kMaxSec || nz < 3 ||
      nz > kMaxZones || radius < 0 || D * D * D > kMaxPatch || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (grad_dtype == 0)
    return launch(static_cast<const float*>(grad), X, Y, Z, rx, ry, rz,
                  goff, coords, valid, K, radius, stride, mask, bounds, nz,
                  edges, nb, slot_start, slot_zone, n_cand, rot_to_pole,
                  p_theta, belt_first, M, S, cutoff, mains, secs, rfin, ok,
                  stream);
  return launch(static_cast<const __nv_bfloat16*>(grad), X, Y, Z, rx, ry, rz,
                goff, coords, valid, K, radius, stride, mask, bounds, nz,
                edges, nb, slot_start, slot_zone, n_cand, rot_to_pole,
                p_theta, belt_first, M, S, cutoff, mains, secs, rfin, ok,
                stream);
}
