// K20b: the symmetrized, trimmed overlap that the enumeration heads read.
//
// Replaces mad_tpu/engine/assemble.py:316-333 (_compiled_embed_sym),
// without its static frame: out[i][j] = ov[i][j] + ov[j][i] for i, j < t,
// from the (n, n) float32 overlap that K18 leaves on the card, into the
// (t, t) float32 matrix that K19 / K20 take. One IEEE float32 addition an
// element (__fadd_rn, as the plain version's ``block + block.T``); one of
// each off-diagonal pair is 0, so it also equals the float64 sum rounded.
//
// Bound: bytes (t^2 floats read twice, written once: a few KB on the bench,
// so the launch's latency is all that shows). Design: one thread an
// element, a 2-D grid of 16 x 16 tiles; nothing to share between threads.
#include "common.cuh"

namespace {

constexpr int kTile = 16;

__global__ void sym_trim(const float* __restrict__ ov, int n, int t,
                         float* __restrict__ out) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int i = blockIdx.y * kTile + threadIdx.y;
  if (i >= t || j >= t) return;
  out[i * t + j] = add_rn(ov[static_cast<long long>(i) * n + j],
                          ov[static_cast<long long>(j) * n + i]);
}

}  // namespace

// ov (n, n) f32; out (t, t) f32, 0 < t <= n.
MAD_EXPORT int mad_sym_trim(const float* ov, int n, int t, float* out,
                            cudaStream_t stream) {
  if (t <= 0) return 0;
  const dim3 grid((t + kTile - 1) / kTile, (t + kTile - 1) / kTile);
  sym_trim<<<grid, dim3(kTile, kTile), 0, stream>>>(ov, n, t, out);
  return static_cast<int>(cudaGetLastError());
}
