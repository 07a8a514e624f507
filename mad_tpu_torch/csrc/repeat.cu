// K13: exact pose repeatability, a warp for each (pair, group of 32
// subunit anchors).
//
// Replaces mad_tpu/engine/match.py:176-200 (_exact_repeat_body). For pair
// k with rotation R_k, subunit anchor h_k and map anchor l_k, every unique
// subunit anchor x moves to y = (x - h_k) @ R_k^T + l_k (the pose of
// engine/docking.py's start coordinates); the pair's score is
// 100 * #{x : min_b |y - b|^2 < thresh2} / A_hi over the map cloud b.
// Distances are taken directly as (y - b)^2 summed over x, y, z instead
// of the |y|^2 + |b|^2 - 2 y.b expansion of the JAX body; the two differ
// only for anchors within float rounding of the threshold radius.
//
// Bound: arithmetic, P * A_hi * A_lo distances of ~7 instructions each
// (1.4e7 distances, 1.2e8 operations at the bench's 1,024 pairs x 32 x 414
// anchors: 1.8 us at the card's float32 rate), with no reuse problem: the
// map cloud is a few KB to a few tens of KB. What bounds this kernel at
// the bench is instruction issue: the 1,024 warps' ~8 instructions a point
// (a shared load and seven float32 operations) over 132 SMs' four
// schedulers, about 4 us, plus a launch and one staged tile.
//
// Design: the work is sized to the real anchor counts. Lane i of the warp
// that owns item (pair k, group g) moves anchor 32 g + i; only the idle
// lanes of a pair's last partial group compute for no anchor. A block of
// kWarps warps takes kWarps consecutive items and streams the map cloud
// through shared memory in tiles of kTile points (one float4 a point, read
// as a broadcast), padded to a multiple of kMinima with +inf points. Each
// lane keeps kMinima independent running minima, so the fminf chain does
// not serialise the loop; the minimum is exact in any order, and fminf
// drops a NaN distance in any order, so the result equals one running
// minimum over the points in turn. Hits are counted by a ballot: where a
// pair has one group (A_hi <= 32, the bench) its warp writes the score;
// otherwise each warp adds its count to the pair's counter and the last
// warp of the pair (a ticket) writes the quotient. y, the distance
// expression, the strict compare and the quotient are those of the
// one-block-a-pair form before it, so the scores are the same bits.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;          // (pair, group) items a block
constexpr int kTile = 1024;        // map-cloud points a shared tile
constexpr int kMinima = 2;         // independent running minima a lane

__global__ void __launch_bounds__(kWarps * 32)
exact_repeat(const float* __restrict__ hi_cloud, int A_hi,
             const float* __restrict__ lo_cloud, int A_lo,
             const float* __restrict__ rot, const float* __restrict__ hi,
             const float* __restrict__ lo, int P, int G, float thresh2,
             int* __restrict__ counts, float* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps
                         + (threadIdx.x >> 5);
  const bool active = item < static_cast<long long>(P) * G;  // warp-uniform
  const int k = active ? static_cast<int>(item / G) : 0;
  const int a = active ? static_cast<int>(item % G) * 32 + lane : A_hi;
  float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f;
  if (a < A_hi) {
    const float* R = rot + 9 * k;
    const float x0 = hi_cloud[3 * a] - hi[3 * k];
    const float x1 = hi_cloud[3 * a + 1] - hi[3 * k + 1];
    const float x2 = hi_cloud[3 * a + 2] - hi[3 * k + 2];
    y0 = add_rn(add_rn(add_rn(mul_rn(x0, R[0]), mul_rn(x1, R[1])),
                       mul_rn(x2, R[2])), lo[3 * k]);
    y1 = add_rn(add_rn(add_rn(mul_rn(x0, R[3]), mul_rn(x1, R[4])),
                       mul_rn(x2, R[5])), lo[3 * k + 1]);
    y2 = add_rn(add_rn(add_rn(mul_rn(x0, R[6]), mul_rn(x1, R[7])),
                       mul_rn(x2, R[8])), lo[3 * k + 2]);
  }
  float m[kMinima];
#pragma unroll
  for (int s = 0; s < kMinima; ++s) m[s] = INFINITY;
  float* flat = reinterpret_cast<float*>(tile);
  for (int t0 = 0; t0 < A_lo; t0 += kTile) {
    const int nt = min(kTile, A_lo - t0);
    const int padded = (nt + kMinima - 1) / kMinima * kMinima;
    __syncthreads();                       // the last tile is read
    for (int j = threadIdx.x; j < nt * 3; j += blockDim.x)
      flat[4 * (j / 3) + j % 3] = lo_cloud[3 * t0 + j];
    for (int j = nt + threadIdx.x; j < padded; j += blockDim.x)
      tile[j] = make_float4(INFINITY, INFINITY, INFINITY, 0.0f);
    __syncthreads();
    if (!active) continue;
    for (int b = 0; b < padded; b += kMinima) {
#pragma unroll
      for (int s = 0; s < kMinima; ++s) {
        const float4 p = tile[b + s];
        const float e0 = y0 - p.x, e1 = y1 - p.y, e2 = y2 - p.z;
        m[s] = fminf(m[s], e0 * e0 + e1 * e1 + e2 * e2);
      }
    }
  }
  if (!active) return;
  float dmin = m[0];
#pragma unroll
  for (int s = 1; s < kMinima; ++s) dmin = fminf(dmin, m[s]);
  const int hits = __popc(__ballot_sync(0xffffffffu,
                                        a < A_hi && dmin < thresh2));
  if (lane != 0) return;
  int count = hits;
  if (G > 1) {
    atomicAdd(&counts[k], hits);
    __threadfence();
    if (atomicAdd(&counts[P + k], 1) != G - 1) return;
    count = atomicAdd(&counts[k], 0);
  }
  const int denom = A_hi > 1 ? A_hi : 1;
  out[k] = __fdiv_rn(__fmul_rn(100.0f, static_cast<float>(count)),
                     static_cast<float>(denom));
}

}  // namespace

// counts: 2 P ints of scratch (each pair's hits and its warps' ticket),
// cleared here, when a pair has more than one group of 32 anchors; else
// unread (it may be null).
MAD_EXPORT int mad_exact_repeat(const float* hi_cloud, int A_hi,
                                const float* lo_cloud, int A_lo,
                                const float* rot, const float* hi,
                                const float* lo, int P, float thresh2,
                                int* counts, float* out,
                                cudaStream_t stream) {
  if (P == 0) return 0;
  if (A_hi == 0)                           // 100 * 0 / 1: +0.0, all bits 0
    return static_cast<int>(cudaMemsetAsync(out, 0, P * sizeof(float),
                                            stream));
  const int G = (A_hi + 31) / 32;
  if (G > 1) {
    const cudaError_t err = cudaMemsetAsync(counts, 0,
                                            2ll * P * sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long items = static_cast<long long>(P) * G;
  exact_repeat<<<static_cast<unsigned>((items + kWarps - 1) / kWarps),
                 kWarps * 32, 0, stream>>>(hi_cloud, A_hi, lo_cloud, A_lo,
                                           rot, hi, lo, P, G, thresh2,
                                           counts, out);
  return static_cast<int>(cudaGetLastError());
}
