#!/usr/bin/env python3
"""What holds K3 (the gradient field) back on one NVIDIA card: its stores
or its loads.

    python3 scripts/torch_k3_probe.py

Runs chip_smoke.py's bench fit once, takes the upsampled octave's Gaussian
volume (the input of K3's first call in describe_grid, 581x587x559 on the
bench map) and times with CUDA events (mean of ten after a warm call),
each writing the float32 field (X, Y, Z, 3):
  * "per voxel": K3 as it was before the plane-marching stencil, one
    thread a voxel (a 32-bit div / mod chain, seven loads), each
    component stored at a 12-byte stride as soon as it is computed (a
    warp store spans 384 B for 128 B of data);
  * "per voxel, loads first": the same, its three components computed
    before the first store;
  * "per voxel, staged": that, each block's records assembled in shared
    memory and stored as contiguous 4-byte runs;
  * "streaming copy": out[i] = v[i / 3], V floats read and 3V contiguous
    floats written, one thread an output float; and PyTorch's zero_() of
    the field (its bytes written) and copy_() of the volume (V floats in,
    V out), the rates this card gives for plain streams;
  * K3 itself (csrc/gradient.cu, through kernels/gradient.py), float32 and
    bfloat16;
  * K3 without its stores (each store behind a test of X < 0, which
    keeps the arithmetic) and K3 without its loads (each copy into
    shared memory replaced by a constant), float32: builds of
    csrc/gradient.cu with those two lines changed, which split its time
    between the march of its loads and its stores;
beside the bound (the volume read once, the field written once, over
3.35 TB/s). The probe kernels are compiled here from the source below
and from the changed copies of csrc/gradient.cu (nvcc, the port's
flags) into mad_tpu_torch/_build/; the per-voxel forms are checked
equal to gradient_plain. Prints the card's name and power limit first. Needs a
card.
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

PROBE = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ float diff(const float* v, unsigned t,
                                      unsigned i, unsigned n,
                                      unsigned stride) {
  if (i == 0) return __fsub_rn(v[t + stride], v[t]);
  if (i == n - 1) return __fsub_rn(v[t], v[t - stride]);
  return __fmul_rn(__fsub_rn(v[t + stride], v[t - stride]), 0.5f);
}

__global__ void per_voxel_in_turn(const float* __restrict__ v, unsigned X,
                                  unsigned Y, unsigned Z,
                                  float* __restrict__ out) {
  const unsigned t = blockIdx.x * 256 + threadIdx.x;
  if (t >= X * Y * Z) return;
  const unsigned z = t % Z, r = t / Z, y = r % Y, x = r / Y;
  float* rec = out + 3 * t;
  *rec = diff(v, t, x, X, Y * Z);
  rec[1] = diff(v, t, y, Y, Z);
  rec[2] = diff(v, t, z, Z, 1);
}

template <bool kStaged>
__global__ void per_voxel(const float* __restrict__ v, unsigned X,
                          unsigned Y, unsigned Z, float* __restrict__ out) {
  __shared__ float rec[3 * 256];
  const unsigned n = X * Y * Z;
  const unsigned t = blockIdx.x * 256 + threadIdx.x;
  float g[3] = {0.f, 0.f, 0.f};
  if (t < n) {
    const unsigned z = t % Z, r = t / Z, y = r % Y, x = r / Y;
    g[0] = diff(v, t, x, X, Y * Z);
    g[1] = diff(v, t, y, Y, Z);
    g[2] = diff(v, t, z, Z, 1);
  }
  if (!kStaged) {
    if (t < n)
      for (int c = 0; c < 3; ++c) out[3 * t + c] = g[c];
    return;
  }
  for (int c = 0; c < 3; ++c) rec[3 * threadIdx.x + c] = g[c];
  __syncthreads();
  const unsigned first = blockIdx.x * 256;
  const unsigned count = 3 * min(256u, n - first);
  for (unsigned j = threadIdx.x; j < count; j += 256)
    out[3 * first + j] = rec[j];
}

__global__ void stream3(const float* __restrict__ v, unsigned n3,
                        float* __restrict__ out) {
  const unsigned i = blockIdx.x * 256 + threadIdx.x;
  if (i < n3) out[i] = v[i / 3];
}

extern "C" int probe_gradient(int mode, const float* v, int X, int Y,
                              int Z, float* out, cudaStream_t s) {
  const unsigned n = unsigned(X) * Y * Z, blocks = (n + 255) / 256;
  if (mode == 3) {
    stream3<<<(3 * n + 255) / 256, 256, 0, s>>>(v, 3 * n, out);
  } else if (mode == 2) {
    per_voxel<true><<<blocks, 256, 0, s>>>(v, X, Y, Z, out);
  } else if (mode == 1) {
    per_voxel<false><<<blocks, 256, 0, s>>>(v, X, Y, Z, out);
  } else {
    per_voxel_in_turn<<<blocks, 256, 0, s>>>(v, X, Y, Z, out);
  }
  return int(cudaGetLastError());
}
"""


# csrc/gradient.cu's lines that the two split builds change
STORE = "dst[j] = rec[ty][j];"
LOAD = "cp_async4(s + i, src + static_cast<Idx>(y) * Z + z, true);"
SPLITS = {"without its stores": (STORE, "if (X < 0) " + STORE),
          "without its loads": (LOAD, "s[i] = 1.f;")}


def compiled(name, source):
    """ctypes library of one source, built with the port's nvcc flags."""
    from mad_tpu_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"{name}.cu"
    so = build.BUILD_DIR / f"lib{name}.so"
    src.write_text(source)
    subprocess.run([build._nvcc()] + build.ARCH_FLAGS + build.NVCC_FLAGS
                   + ["-I", str(build.CSRC), "-shared", "-o", str(so),
                      str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def probe_libraries():
    """The probe kernels' library and the two split builds of K3 (name ->
    library exporting mad_gradient)."""
    from mad_tpu_torch.kernels import build
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = compiled("k3_probe", PROBE)
    lib.probe_gradient.argtypes = [i, p, i, i, i, p, p]
    lib.probe_gradient.restype = i
    k3_src = (build.CSRC / "gradient.cu").read_text()
    splits = {}
    for n, (name, (old, new)) in enumerate(SPLITS.items()):
        if k3_src.count(old) != 1:
            raise RuntimeError(f"csrc/gradient.cu no longer has {old!r}")
        split = compiled(f"k3_split{n}", k3_src.replace(old, new))
        split.mad_gradient.argtypes = build.SIGNATURES["mad_gradient"]
        split.mad_gradient.restype = i
        splits[name] = split
    return lib, splits


def main():
    import torch
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.kernels import gradient as k3
    from mad_tpu_torch.testing import recording

    device, _smi = cs.device_phase()
    cs.build_phase()
    lib, splits = probe_libraries()
    cfg = cs.bench_config()
    fit = cs.run_fit(device, None, cfg)
    with recording(pipeline, "gradient") as grads:
        pipeline.describe_grid(fit["dmap"], cfg, device=device)
    del fit
    vol = grads[0][0]
    del grads
    X, Y, Z = vol.shape
    V = vol.numel()
    out = torch.empty((X, Y, Z, 3), dtype=torch.float32, device=device)

    def probe(mode):
        code = lib.probe_gradient(mode, vol.data_ptr(), X, Y, Z,
                                  out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"probe_gradient({mode}) failed: {code}")

    def split(name):
        code = splits[name].mad_gradient(
            vol.data_ptr(), X, Y, Z, 0, out.data_ptr(), k3.WIDE_FROM,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"K3 {name} failed: {code}")

    ref = k3.gradient_plain(vol)
    forms = ("per voxel", "per voxel, loads first", "per voxel, staged")
    for mode, name in enumerate(forms):
        probe(mode)
        cs.check(torch.equal(out, ref), f"{name} differs from the plain "
                 "version")
    del ref
    ms = lambda fn: cs.cuda_ms(fn, reps=10)
    flat = out.view(-1)[:V]
    rows = [(name, ms(lambda mode=mode: probe(mode)))
            for mode, name in enumerate(forms)]
    rows += [("streaming copy", ms(lambda: probe(3))),
             ("zero_() of the field", ms(out.zero_)),
             ("copy_() of the volume", ms(lambda: flat.copy_(vol.view(-1)))),
             ("K3 float32", ms(lambda: k3.gradient(vol))),
             ("K3 bfloat16", ms(lambda: k3.gradient(vol, torch.bfloat16)))]
    rows += [(f"K3 {name}", ms(lambda name=name: split(name)))
             for name in SPLITS]
    for dtype, size in (("float32", 4), ("bfloat16", 2)):
        b = cs.bound(4 * V + 3 * V * size, 6 * V)
        cs.say(f"bound {dtype}: {b['bound_ms']:.4f} ms ({b['bound_by']})")
    cs.say(f"K3 probe on {tuple(vol.shape)}: " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in rows))


if __name__ == "__main__":
    main()
