#!/usr/bin/env python3
"""K5 (csrc/localize.cu) at the bench fit's four octaves and K22
(csrc/crop_pad.cu's axis_flags) on the unreduced bench map, alone, beside
variants of their sources built from edited copies; K5's phases timed by
%globaltimer. Needs a card.

    python3 scripts/torch_localize_flags_probe.py [--kernels k5,k22]
        [--variants all] [--reps 3]

K5: records the flat-form calls (``ops/detect.localize_peaks``) of one
``describe_grid`` of chip_smoke's bench map and one ``describe_structure``
of its subunit, then for each octave times the kernel alone
(``chip_smoke.kernel_ms`` of the recorded launch) and each variant's
launch on the same arguments, the outputs of those that compute the same
function held bit for bit with the kernel's. Variants (regex edits of the
source, each built by one ``nvcc`` into ``mad_tpu_torch/_build/``, all at
once):

* ``empty``: the kernel returns at once (the launch's own cost);
* ``seeds only``: returns after the seeds (the flat index's load and its
  divisions);
* ``edge N``: a window of N^3 voxels (``kEdge``; 3 reloads the patch
  every step, a gather from device memory each, as one thread a peak did);
* ``every lane divides``: each lane computes all nine quotients adj / det
  and the row sums itself (no shuffles);
* ``clock``: lane 1 of each peak records %globaltimer at entry, after its
  seed, after its first window, after its walk and at exit; the script
  prints the medians of the phases and the slowest peak's.

K22: the kernel alone (its memset and launch) on the unreduced map and on
a view of it one value off 16-byte alignment, ``torch.amax`` of the map
(one PyTorch read of the same bytes), and the variants ``k22 no memset``,
``k22 slots S``, ``k22 blocks B`` (a streaming multiprocessor's),
``k22 threads T``, ``k22 ldg`` (``__ldg`` in place of the streaming
``__ldcs``), ``k22 no prefetch`` (without the L2 prefetch of the next
iteration's chunks), ``k22 prefetch D`` (D iterations ahead),
``k22 pipelined`` (the next
iteration's loads issued before this one's flags) and ``k22 stream`` (the loads with an OR of the values' bits
in place of the flags: the stream's own cost), the flags of all but the
last held equal to the kernel's.

``--host``: the host's microseconds a call of K5's wrapper (both forms),
of its parts (the bare launch, the outputs as one buffer and views or as
three ``torch.empty``, the card and stream context, the checks) and of
``detect_anchors`` at the map's upsampled octave, and a profile of the
wrapper's Python.

Prints the card's name and power limit first.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

EMPTY = [(r"(  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;)",
          r"  return;\n\1")]
SEEDS_ONLY = [(r"(  int w0\[3\] = )",
               r"  if (pos[0] + pos[1] + pos[2] >= 0) return;\n\1")]
CLOCK = [(r"(namespace \{\n)",
          r"\1__device__ unsigned long long probe_clock[4096 * 5];\n"
          r"__device__ __forceinline__ unsigned long long gtime() {\n"
          r"  unsigned long long t;\n"
          r'  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
          r"  return t;\n}\n"),
         (r"(  if \(k >= K\) return;[^\n]*\n)",
          r"\1  const unsigned long long t_in = gtime();\n"
          r"  bool first = true;\n"),
         (r"(  int w0\[3\] = )",
          r"  const unsigned long long t_seed = gtime();\n"
          r"  unsigned long long t_win = t_seed;\n\1"),
         (r"(      __syncwarp\(\);\n    \}\n)",
          r"\1    if (first) { t_win = gtime(); first = false; }\n"),
         (r"(  if \(lane == 0\) \{\n    for)",
          r"  const unsigned long long t_walk = gtime();\n\1"),
         (r"(    good\[k\] = g;\n  \}\n)",
          r"\1  if (lane == 1 && k < 4096) {\n"
          r"    unsigned long long* c = probe_clock + 5 * k;\n"
          r"    c[0] = t_in; c[1] = t_seed; c[2] = t_win; c[3] = t_walk;\n"
          r"    c[4] = gtime();\n  }\n"),
         (r"\Z",
          r"\nMAD_EXPORT int probe_clocks(unsigned long long* host, int n) {\n"
          r"  return static_cast<int>(cudaMemcpyFromSymbol(\n"
          r"      host, probe_clock, sizeof(unsigned long long) * 5 * n));\n"
          r"}\n")]


EVERY_LANE_DIV = [(
    r"    \{\n      float a = adj\[0\];.*?\n      \}\n    \}\n",
    """    for (int r = 0; r < 3; ++r) {
      const float sr = add_rn(add_rn(mul_rn(__fdiv_rn(adj[3 * r], den), G[0]),
                                     mul_rn(__fdiv_rn(adj[3 * r + 1], den),
                                            G[1])),
                              mul_rn(__fdiv_rn(adj[3 * r + 2], den), G[2]));
      o[r] = -sr;
      acc_now = acc_now && fabsf(o[r]) < max_offset;
    }
""")]


def edge(n):
    return [(r"constexpr int kEdge = \d+;", f"constexpr int kEdge = {n};")]


VARIANTS = {"empty": EMPTY, "seeds only": SEEDS_ONLY,
            **{f"edge {n}": edge(n) for n in (3, 5, 7, 9)},
            "every lane divides": EVERY_LANE_DIV, "clock": CLOCK}
SAME_OUTPUTS = {"edge 3", "edge 5", "edge 7", "edge 9", "every lane divides",
                "clock"}


def constant(name, value):
    return [(rf"constexpr int {name} = \d+;",
             f"constexpr int {name} = {value};")]


K22_VARIANTS = {
    "k22 no memset": [(r"  cudaError_t err = cudaMemsetAsync\(flags, 0, F, "
                       r"stream\);\n  if \(err != cudaSuccess\) return "
                       r"static_cast<int>\(err\);\n",
                       "  cudaError_t err = cudaSuccess;\n")],
    **{f"k22 slots {n}": constant("kFlagSlots", n) for n in (2, 8)},
    **{f"k22 blocks {n}": constant("kFlagBlocksPerSm", n) for n in (2, 8)},
    "k22 threads 512": constant("kFlagThreads", 512),
    "k22 ldg": [(r"__ldcs\(chunk \+ cj\)", "__ldg(chunk + cj)")],
    "k22 no prefetch": [(r"#pragma unroll\n    for \(int j = 0; j < kFlagSlots; "
                         r"\+\+j\) \{\n      const long long cj = c \+ \(j \+ "
                         r"kFlagAhead.*?\n    \}\n", "")],
    **{f"k22 prefetch {d}": constant("kFlagAhead", d) for d in (2, 4)},
    "k22 pipelined": [(
        r"  for \(long long c = c0 \+ threadIdx.x; c < c1;\n.*?"
        r"make_float4\(0.f, 0.f, 0.f, 0.f\);\n    \}\n",
        "  float4 v[kFlagSlots];\n#pragma unroll\n"
        "  for (int j = 0; j < kFlagSlots; ++j) {\n"
        "    const long long cj = c0 + threadIdx.x + j * kFlagThreads;\n"
        "    v[j] = cj < c1 ? __ldcs(chunk + cj) : make_float4(0.f, 0.f, "
        "0.f, 0.f);\n  }\n"
        "  for (long long c = c0 + threadIdx.x; c < c1;\n"
        "       c += kFlagSlots * kFlagThreads) {\n"
        "    float4 w[kFlagSlots];\n#pragma unroll\n"
        "    for (int j = 0; j < kFlagSlots; ++j) {\n"
        "      const long long cj = c + (j + kFlagSlots) * kFlagThreads;\n"
        "      w[j] = cj < c1 ? __ldcs(chunk + cj) : make_float4(0.f, 0.f, "
        "0.f, 0.f);\n    }\n"),
        (r"(      mark_chunk\(v\[j\], at\[j\], Y, Z, sx, sy, sz\);\n"
         r"      advance\(at\[j\], step, Y, Z\);\n    \}\n)",
         "\\1#pragma unroll\n    for (int j = 0; j < kFlagSlots; ++j) "
         "v[j] = w[j];\n")],
    "k22 stream": [(r"      mark_chunk\(v\[j\], at\[j\], Y, Z, sx, sy, sz\);",
                    "      if (__float_as_uint(v[j].x) == 0x7f800001u"
                    " && __float_as_uint(v[j].w) == 0x7f800001u) sx[0] = 1;")],
}


def build_variants(names):
    """Edited copies of csrc/localize.cu and csrc/crop_pad.cu, one nvcc
    each, all at once; {name: CDLL}."""
    import chip_smoke as cs
    from mad_tpu_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        k22 = name in K22_VARIANTS
        text = (build.CSRC / ("crop_pad.cu" if k22 else "localize.cu")
                ).read_text()
        for old, new in (K22_VARIANTS if k22 else VARIANTS)[name]:
            cs.check(len(re.findall(old, text, re.S)) == 1,
                     f"variant {name}: no single {old!r}")
            text = re.sub(old, new, text, flags=re.S)
        stem = "probe_" + re.sub(r"\W", "_", name)
        cu = build.BUILD_DIR / f"{stem}.cu"
        so = build.BUILD_DIR / f"{stem}.so"
        cu.write_text(text)
        procs.append((name, so, subprocess.Popen(
            [build._nvcc()] + build.ARCH_FLAGS + build.NVCC_FLAGS
            + ["-I", str(build.CSRC), "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"variant {name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        fn = "mad_axis_flags" if name in K22_VARIANTS else "mad_localize"
        getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def k5_rows(cs, libs, device, reps):
    import torch
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.kernels import build, localize as k5
    from mad_tpu_torch.ops import detect
    from mad_tpu_torch.testing import recording
    cfg = cs.bench_config()
    fit = cs.run_fit(device, {}, cfg)
    with recording(detect, "localize_peaks") as calls:
        pipeline.describe_grid(fit["dmap"], cfg, name="m", device=device)
    with recording(detect, "localize_peaks") as sub:
        pipeline.describe_structure(fit["moved"], cs.RES, fit["dmap"].voxsp,
                                    cfg, device=device)
    torch.cuda.synchronize()
    res = {}
    for label, a in zip(cs.K4_SHAPES, calls + sub):
        launch = cs.bare(lambda: k5.localize_peaks(*a))
        _fn, dev, *largs = launch.call
        buf = next(t for t in launch.kept if t.data_ptr() == largs[-3]
                   and t.dtype == torch.uint8)
        launch()
        want = buf.clone()
        walk = (a[0], k5.flat_seeds(a[1], a[0].shape, a[3], a[5]), a[3],
                a[6], a[7])
        steps, _voxels, most = cs.newton_work(*walk)
        moved = (want[:24 * len(a[1])].view(torch.int64).view(-1, 3)
                 - walk[1]).abs().amax(dim=1)
        print(f"{label}: {a[1].shape[0]} peaks, {steps} steps, at most "
              f"{most} a peak; final voxel moves from the seed "
              f"{torch.bincount(moved).tolist()}", flush=True)
        for rep in range(reps):
            res.setdefault((label, "kernel"), []).append(cs.kernel_ms(launch))
            for name, lib in libs.items():
                var = lambda: build.launch(lib.mad_localize, dev, *largs)
                res.setdefault((label, name), []).append(cs.kernel_ms(var))
                if name in SAME_OUTPUTS and rep == 0:
                    buf.zero_()
                    var()
                    cs.check(torch.equal(buf, want),
                             f"variant {name} differs on {label}")
        if "clock" in libs:
            build.launch(libs["clock"].mad_localize, dev, *largs)
            torch.cuda.synchronize()
            K = min(a[1].shape[0], 4096)
            host = (ctypes.c_ulonglong * (5 * K))()
            cs.check(libs["clock"].probe_clocks(host, K) == 0, "clock copy")
            t = np.array(host, dtype=np.float64).reshape(K, 5)
            t -= t[:, :1].min()
            ph = np.diff(t, axis=1)
            slow = int(np.argmax(t[:, 4]))
            print(f"  clock {label} (ns): start spread "
                  f"{t[:, 0].max():.0f}; median seed {np.median(ph[:, 0]):.0f}, "
                  f"first window {np.median(ph[:, 1]):.0f}, walk "
                  f"{np.median(ph[:, 2]):.0f}, outputs "
                  f"{np.median(ph[:, 3]):.0f}; slowest peak ends at "
                  f"{t[slow, 4]:.0f} (started {t[slow, 0]:.0f}, phases "
                  f"{', '.join(f'{x:.0f}' for x in ph[slow])})", flush=True)
    print(f"K5 alone, ms (mean of {reps}):")
    for label in cs.K4_SHAPES:
        print(f"  {label}: " + ", ".join(
            f"{name} {np.mean(res[(label, name)]):.4f}"
            for name in ["kernel"] + list(libs)), flush=True)


def k5_host(cs, device):
    """The host's microseconds a call of K5's wrapper and of its parts, at
    the map's upsampled octave (no sync between calls), and a profile of
    the wrapper's Python."""
    import cProfile
    import pstats
    import time
    import torch
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.kernels import build, localize as k5
    from mad_tpu_torch.ops import detect
    from mad_tpu_torch.testing import recording
    cfg = cs.bench_config()
    fit = cs.run_fit(device, {}, cfg)
    with recording(detect, "localize_peaks") as calls:
        pipeline.describe_grid(fit["dmap"], cfg, name="m", device=device)
    a = calls[0]
    K = a[1].shape[0]
    seeds = k5.flat_seeds(a[1], a[0].shape, a[3], a[5])
    walk = (a[0], seeds, a[3], a[6], a[7])
    launch = cs.bare(lambda: k5.localize_peaks(*a))
    dev = a[0].device

    def one_buffer():
        out = torch.empty(37 * K, dtype=torch.uint8, device=dev)
        p, s, g = out.split((24 * K, 12 * K, K))
        return (p.view(torch.int64).view(K, 3),
                s.view(torch.float32).view(K, 3), g.view(torch.bool))

    def three():
        return (torch.empty((K, 3), dtype=torch.int64, device=dev),
                torch.empty((K, 3), dtype=torch.float32, device=dev),
                torch.empty(K, dtype=torch.bool, device=dev))

    def device_ctx():
        with torch.cuda.device(dev):
            torch.cuda.current_stream(dev).cuda_stream

    parts = {"localize_peaks": lambda: k5.localize_peaks(*a),
             "localize (seeds)": lambda: k5.localize(*walk),
             "bare launch": launch, "one buffer and views": one_buffer,
             "three torch.empty": three,
             "torch.cuda.device and the stream": device_ctx,
             "require_cuda": lambda: build.require_cuda("x", *a[:3]),
             "detect_anchors": None}
    with recording(pipeline, "detect_anchors") as dets:
        pipeline.describe_grid(fit["dmap"], cfg, name="m", device=device)
    parts["detect_anchors"] = lambda: detect.detect_anchors(*dets[0])
    for name, fn in parts.items():
        n = 20 if name == "detect_anchors" else 300
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"  host {name}: {(t1 - t0) / n * 1e6:.1f} us a call "
              f"(with the sync {(time.perf_counter() - t0) / n * 1e6:.1f})",
              flush=True)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(300):
        k5.localize_peaks(*a)
    prof.disable()
    torch.cuda.synchronize()
    pstats.Stats(prof).sort_stats("tottime").print_stats(12)


def k22_rows(cs, libs, device, reps):
    import torch
    from mad_tpu_torch.kernels import build, crop_pad as k22
    raw = cs.unreduced_map(device).data
    X, Y, Z = raw.shape
    view = raw.reshape(-1)[1:1 + (X - 1) * Y * Z].view(X - 1, Y, Z)
    res = {}
    for label, v in (("map", raw), ("view off alignment", view)):
        launch = cs.bare(lambda: k22.axis_flags(v))
        _fn, dev, *largs = launch.call
        flags = next(t for t in launch.kept if t.data_ptr() == largs[-1])
        launch()
        want = flags.clone()
        for rep in range(reps):
            res.setdefault((label, "kernel"), []).append(cs.kernel_ms(launch))
            res.setdefault((label, "wrapper"), []).append(
                cs.cuda_ms(lambda: k22.axis_flags(v), reps=10))
            res.setdefault((label, "torch.amax"), []).append(
                cs.cuda_ms(lambda: torch.amax(v), reps=10))
            for name, lib in libs.items():
                var = lambda: build.launch(lib.mad_axis_flags, dev, *largs)
                res.setdefault((label, name), []).append(cs.kernel_ms(var))
                if name != "k22 stream" and rep == 0:
                    var()
                    cs.check(torch.equal(flags, want),
                             f"variant {name} differs on {label}")
    bound = (raw.numel() * 4 + X + Y + Z) / cs.PEAK_BYTES_S * 1e3
    print(f"K22 alone, ms (mean of {reps}; bound {bound:.5f} ms):")
    for label in ("map", "view off alignment"):
        print(f"  {label}: " + ", ".join(
            f"{name} {np.mean(res[(label, name)]):.4f}"
            for name in ["kernel", "wrapper", "torch.amax"] + list(libs)),
            flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="k5,k22")
    ap.add_argument("--variants", default="all")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()
    import chip_smoke as cs
    device, smi = cs.device_phase()
    print(smi, flush=True)
    cs.build_phase()
    kernels = args.kernels.split(",")
    every = ([n for n in VARIANTS] if "k5" in kernels else []) + (
        [n for n in K22_VARIANTS] if "k22" in kernels else [])
    names = every if args.variants == "all" else [
        n for n in args.variants.split(",") if n]
    libs = build_variants(names)
    if "k5" in kernels:
        k5_rows(cs, {n: libs[n] for n in names if n in VARIANTS}, device,
                args.reps)
    if args.host:
        k5_host(cs, device)
    if "k22" in kernels:
        k22_rows(cs, {n: libs[n] for n in names if n in K22_VARIANTS},
                 device, args.reps)


if __name__ == "__main__":
    main()
