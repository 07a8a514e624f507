#!/usr/bin/env python3
"""K12 (approximate repeatability) and K16's lane stage (with the dedup it
is folded into on one device) on one NVIDIA card: where their time goes,
and two checkouts' kernels held bit for bit and timed in turns.

    python3 scripts/torch_approx_lanes_probe.py [--parent DIR]
        [--order ABBA] [--variants parent,gather,approx,lanes]

Runs chip_smoke.py's bench fit once in this checkout and records the
inputs of K12 (engine/match.approx_repeat, with K11's anchor voxels and
radius from engine/match.anchor_field), of every K16 round
(engine/docking.post) and of the match stage (match_descriptors at the
fit's min_exact), saved under mad_tpu_torch/_build/. Prints, on the
bench's moved subunit anchors (every pair's, numpy), the share in the
grid, the share whose coarse cell of edge 8 and of edge 4 is set (a cell
is set when the box [u - r, u + r] of a map anchor voxel u, clipped to
the grid, overlaps it: the superset of K11's field that K12's coarse map
holds) and the share whose voxel is set in the field.

Then, for every letter of ``--order`` (A the checkout ``--parent``, B this
one; this one alone, once, without ``--parent``), one process in that
checkout loads the inputs, runs its own kernels on them and times each
alone (chip_smoke.bare / kernel_ms: the wrapper's one launcher call
repeated on the same buffers) and its wrapper (chip_smoke.cuda_ms, mean
of ten): K12 (called with the anchor voxels where the checkout's wrapper
takes them), K16's lane entry and its dedup entry on each round's stage
inputs (chip_smoke.stage_inputs), the fold of the two where the checkout
has it (``post_lanes_dedup``), the two entries called in turn, the round
(``post``, the lane, dedup, point, row and compaction stages) and the
match stage (host clock, synchronized, median of 7). The two checkouts'
outputs are held equal bit for bit. Variants (alone, on the same recorded
launcher calls, every build compiled at once):
  * parent (in A's first process, or this checkout's without
    ``--parent``; K12's form before the coarse map, a warp a pair): K12
    returning at once (the launch), and with each gather replaced by a
    bit of its index (the poses and arithmetic alone);
  * gather (the same process): a kernel of this script that reads an
    int32 voxel index a (pair, anchor), -1 off the grid, precomputed on
    the card, and gathers the field there, a warp a pair as that form;
    and the same kernel with the gather replaced by a bit of the index
    (the index read alone);
  * approx (in B's first process): this checkout's K12 with its coarse
    map at cells of edge 16 (a 6 KB budget), without the map's test (every
    in-grid anchor gathers), without the map (neither built nor tested),
    without its anchors (the launch, the map and the poses), returning at
    once, with %globaltimer read by its first block at its phases
    (``clock``, printed as "K12 clock"), with each gather replaced by a
    bit of its index, at 8, 16 and 23 warps a block, and with its anchors
    4 and 16 at a time;
  * lanes (the same process): K16's lane entry returning at once, without
    the center's atom sums and without the distances to the map anchors.
Prints the card's name and power limit first. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A warp a pair over precomputed voxel indices (``gather``): the field
# gathered at each (GATHER 1) or a bit of the index counted (GATHER 0).
GATHER_SRC = r"""
#include "common.cuh"
namespace {
__global__ void gather_only(const signed char* __restrict__ field,
                            const int* __restrict__ idx, int A, int P,
                            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (k >= P) return;
  int cnt = 0;
  for (int a = lane; a < A; a += 32) {
    const int v = idx[static_cast<long long>(k) * A + a];
#if GATHER
    if (v >= 0) cnt += field[v] > 0 ? 1 : 0;
#else
    if (v >= 0) cnt += v & 1;
#endif
  }
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if (lane == 0) out[k] = static_cast<float>(cnt);
}
}  // namespace
MAD_EXPORT int mad_gather_only(const signed char* field, const int* idx,
                               int A, int P, float* out,
                               cudaStream_t stream) {
  gather_only<<<(P + 3) / 4, 128, 0, stream>>>(field, idx, A, P, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# Run in a checkout (cwd), its mad_tpu_torch; the helpers (bare,
# kernel_ms, stage_inputs, ...) from this checkout's chip_smoke, loaded by
# path.
CHILD = r"""
import ctypes, importlib.util, inspect, json, re, subprocess, sys, time
import torch
from mad_tpu_torch.kernels import build, approx as k12, post as k16
smoke, inputs, out_path, variants, gather_src = (
    sys.argv[1], sys.argv[2], sys.argv[3], json.loads(sys.argv[4]),
    sys.argv[5])
CLOCK_PHASES = json.loads(sys.argv[6])
spec = importlib.util.spec_from_file_location("smoke_helpers", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
device, _smi = cs.device_phase()
cs.build_phase()
# the variants' builds, all at once: (name, source, edits) of a csrc file,
# or (name, None, defines) of the gather kernel
procs = []
for name, src, edits in variants:
    if src is None:
        text = gather_src
        flags = [f"-D{d}" for d in edits]
    else:
        text, flags = (build.CSRC / src).read_text(), []
        for old, new in edits:
            cs.check(len(re.findall(old, text, re.S)) == 1,
                     f"csrc/{src} has no single {old!r}")
            text = re.sub(old, new, text, flags=re.S)
    stem = "probe_" + "".join(c if c.isalnum() else "_" for c in name)
    cu, so = build.BUILD_DIR / f"{stem}.cu", build.BUILD_DIR / f"{stem}.so"
    cu.write_text(text)
    procs.append((name, src, so, subprocess.Popen(
        [build._nvcc()] + build.ARCH_FLAGS + build.NVCC_FLAGS + flags
        + ["-I", str(build.CSRC), "-shared", "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
built = []
for name, src, so, proc in procs:
    log, _ = proc.communicate()
    cs.check(proc.returncode == 0, f"variant {name}: nvcc failed\n{log}")
    built.append((name, src, ctypes.CDLL(str(so))))
inp = torch.load(inputs, weights_only=False, map_location=device)
res, outs, bares = {}, {}, {}
ms = lambda fn: cs.cuda_ms(fn, reps=10)

def timed(key, fn):
    got = fn()
    outs[key] = [t.cpu() for t in (got if isinstance(got, tuple)
                                   else (got,))]
    r = cs.bare(fn)
    bares[key] = r
    res[key + " alone"] = cs.kernel_ms(r)
    res[key + " wrapper"] = ms(fn)

# K12, with the anchor voxels where this checkout's wrapper takes them
a = inp["K12"]
pose = (a["hi_cloud"], a["origin"], a["inv"], a["rot"], a["hi"], a["lo"])
if "vox" in inspect.signature(k12.approx_repeat).parameters:
    args12 = (a["field"], a["vox"], a["r_vox"]) + pose
else:
    args12 = (a["field"],) + pose
timed("K12", lambda: k12.approx_repeat(*args12))
# K16: the lane and dedup entries on each round's stage inputs, the two in
# turn, the fold where this checkout has it, the whole round
for label, a17 in inp["K16"]:
    st = cs.stage_inputs(a17)
    la, da = st["post_lanes"], st["post_dedup"]
    timed(f"K16 {label} lanes", lambda: k16.post_lanes(*la))
    timed(f"K16 {label} dedup", lambda: k16.post_dedup(*da))
    res[f"K16 {label} lanes then dedup wrapper"] = ms(
        lambda: k16.post_dedup(*da[:2], k16.post_lanes(*la)[2], *da[3:]))
    if hasattr(k16, "post_lanes_dedup"):
        timed(f"K16 {label} fold", lambda: k16.post_lanes_dedup(*a17[:14]))
    outs[f"K16 {label} round"] = [k16.post(*a17).cpu()]
    res[f"K16 {label} round wrapper"] = ms(lambda: k16.post(*a17))
# the match stage, host clock
from mad_tpu_torch.engine import match as em
m, s, shape, origin, voxsp, mc, min_exact = inp["match"]
stage = lambda: em.match_descriptors(m, s, shape, origin, voxsp, mc,
                                     min_exact=min_exact, device=device)
table = stage()
outs["match table"] = [torch.as_tensor(x) for x in (
    table.repeat, table.hi_idx, table.lo_idx, table.rot)]
walls = []
for _ in range(7):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stage()
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
res["match stage, host clock"] = sorted(walls)[3]
# the variants, on the recorded launcher calls
gidx = None
for name, src, lib in built:
    if src is None:
        if gidx is None:         # every (pair, anchor)'s voxel, -1 off grid
            gidx = inp["K12 voxels"].to(device)
            gout = torch.empty(gidx.shape[0], dtype=torch.float32,
                               device=device)
        fn = lib.mad_gather_only
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        call = (device, a["field"].data_ptr(), gidx.data_ptr(),
                gidx.shape[1], gidx.shape[0], gout.data_ptr())
        res[f"K12 alone, {name}"] = cs.kernel_ms(
            lambda: build.launch(fn, *call))
        continue
    for key, r in bares.items():
        export = r.call[0].__name__
        if hasattr(lib, export):
            fn = getattr(lib, export)
            fn.argtypes = build.SIGNATURES[export]
            fn.restype = ctypes.c_int
            res[f"{key} alone, {name}"] = cs.kernel_ms(
                lambda: build.launch(fn, *r.call[1:]))
            if name == "clock" and key == "K12":
                # the first block's phases (ns, %globaltimer) in out[0:4]
                torch.cuda.synchronize()
                out = next(t for t in r.kept if isinstance(t, torch.Tensor)
                           and t.data_ptr() == r.call[-1])
                for i, d in enumerate(out[:4].tolist()):
                    res[f"K12 clock {i} ({CLOCK_PHASES[i]}), us"] = d / 1e3
torch.save(outs, out_path)
print("RESULT " + json.dumps(res))
"""

# Builds with lines changed: (name, source, [(regex, replacement), ...]),
# or (name, None, [defines]) of GATHER_SRC. K12 before the coarse map:
PARENT = (
    ("launch alone", "approx.cu",
     [(r"(\n  const int lane = threadIdx\.x & 31;)",
       r"\n  if (P >= 0) return;\g<1>")]),
    ("gathers a bit of the index", "approx.cu",
     [(r"cnt \+= field\[idx\] > 0 \? 1 : 0;",
       "cnt += static_cast<int>(idx & 1);")]),
)
GATHER = (
    ("gather only", None, ["GATHER=1"]),
    ("index read only", None, ["GATHER=0"]),
)
# %globaltimer at the phases of K12's first block (ns, into out[0:4]):
# the poses', cloud's and voxels' reads with the map cleared; the map
# marked; the first tile's poses in registers; its anchors and the rest
K12_CLOCK_PHASES = ("reads and clear", "map marked", "first poses",
                    "anchors and the rest")
K12_CLOCK = [
    (r"(namespace \{\n)",
     "\\1\n__device__ __forceinline__ unsigned long long mad_clock() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    (r"(  const int stride = gridDim\.x \* kWarps;\n)",
     "\\1  unsigned long long mc[4];\n  mc[0] = mad_clock();\n"),
    (r"(    __syncthreads\(\);\n)(    for \(int it = threadIdx\.x; "
     r"it < nv \* cube;)",
     "\\1    if (v0 == 0) mc[1] = mad_clock();\n\\2"),
    (r"(  __syncthreads\(\);\n)(\n  const float org\[3\])",
     "\\1  mc[2] = mad_clock();\n\\2"),
    (r"(    __syncwarp\(\);\n)(    buf \^= 1;)",
     "\\1    if (t0 == static_cast<int>(blockIdx.x) * kWarps) "
     "mc[3] = mad_clock();\n\\2"),
    (r"(\n  cp_async_wait<0>\(\);\n)\}",
     "\\1  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    const unsigned long long e = mad_clock();\n"
     "    for (int i = 0; i < 3; ++i) out[i] = float(mc[i + 1] - mc[i]);\n"
     "    out[3] = float(e - mc[3]);\n  }\n}"),
]

# ... and the redesigned K12:
APPROX = (
    ("cells of edge 16", "approx.cu",
     [(r"constexpr int kMapBytes = \d+;", "constexpr int kMapBytes = 6144;")]),
    ("no map test", "approx.cu",
     [(r"const bool near = [^;]+;", "const bool near = true;")]),
    ("no map", "approx.cu",
     [(r"const bool near = [^;]+;", "const bool near = true;"),
      (r"map\[\(cx \* CY \+ cy\) \* CZ \+ cz\] = 1;", ";")]),
    ("no anchors", "approx.cu",
     [(r"if \(n == 0\) continue;", "continue;")]),
    ("launch alone", "approx.cu",
     [(r"(\n  extern __shared__ float4 smem\[\];)",
       r"\n  if (P >= 0) return;\g<1>")]),
    ("clock", "approx.cu", K12_CLOCK),
    ("gathers a bit of the index", "approx.cu",
     [(r"hit\[u\] = field\[idx\[u\]\];",
       "hit[u] = static_cast<signed char>(idx[u] & 1);")]),
    ("8 warps a block", "approx.cu",
     [(r"constexpr int kWarps = \d+;", "constexpr int kWarps = 8;")]),
    ("16 warps a block", "approx.cu",
     [(r"constexpr int kWarps = \d+;", "constexpr int kWarps = 16;")]),
    ("23 warps a block", "approx.cu",
     [(r"constexpr int kWarps = \d+;", "constexpr int kWarps = 23;")]),
    ("anchors 4 at a time", "approx.cu",
     [(r"constexpr int kBatch = \d+;", "constexpr int kBatch = 4;")]),
    ("anchors 16 at a time", "approx.cu",
     [(r"constexpr int kBatch = \d+;", "constexpr int kBatch = 16;")]),
)


# ... and K16's lane blocks (the lane entry alone):
LANES = (
    ("lanes without the center's atoms", "post.cu",
     [(r"(  double acc\[3\] = \{0\.0, 0\.0, 0\.0\};\n).*?"
       r"(  for \(int e = 0; e < 3; \+\+e\) \{\n    acc\[e\] = warp_sum)",
       r"\g<1>\g<2>")]),
    ("lanes launch alone", "post.cu",
     [(r"(\n  __shared__ double cloud\[3 \* kStage\];\n  lane_group<true>)",
       r"\n  if (N >= 0) return;\g<1>")]),
    ("lanes without the distances", "post.cu",
     [(r"if \(a < A\) \{\s*int j = lane;",
       "if (a < 0) {\n      int j = lane;")]),
)


def coarse_cells(shape, vox, r, edge):
    """numpy bool (ceil(X / edge), ceil(Y / edge), ceil(Z / edge)): the
    cells of the given edge that the clipped box [u - r, u + r] of some
    anchor voxel u overlaps."""
    import numpy as np
    dims = np.asarray(shape)
    cells = np.zeros(tuple(-(-dims // edge)), dtype=bool)
    lo = np.maximum(vox - r, 0) // edge
    hi = np.minimum(vox + r, dims - 1) // edge
    for a, b in zip(lo, hi):
        if (a <= b).all():
            cells[a[0]:b[0] + 1, a[1]:b[1] + 1, a[2]:b[2] + 1] = True
    return cells


def record(cs, path):
    """Run the bench fit with K11, K12 and K16's call sites recorded; save
    their inputs, every moved anchor's voxel index and the match stage's
    inputs to ``path``; print the coarse cells' shares."""
    import numpy as np
    import torch
    from mad_tpu_torch.core.geometry import rows_times
    from mad_tpu_torch.engine import docking, match as em
    from mad_tpu_torch.testing import recording
    device, _smi = cs.device_phase()
    cs.build_phase()
    cfg = cs.bench_config()
    with recording(em, "anchor_field") as fields, \
            recording(em, "approx_repeat") as c12, \
            recording(docking, "post") as posts:
        fit = cs.run_fit(device, None, cfg)
        torch.cuda.synchronize()
    shape, vox, r_vox = fields[0]
    call = c12[0]
    if len(call) == 7:           # (field, hi_cloud, origin, inv, rot, hi, lo)
        call = (call[0], vox, r_vox) + tuple(call[1:])
    names = ("field", "vox", "r_vox", "hi_cloud", "origin", "inv", "rot",
             "hi", "lo")
    k12 = dict(zip(names, call))
    field, cloud, origin, inv = (k12["field"], k12["hi_cloud"],
                                 k12["origin"], k12["inv"])
    dims = torch.as_tensor(field.shape, device=device)
    flat, inb_all = [], []
    for s0 in range(0, k12["rot"].shape[0], 1024):
        R, h, l = (k12[n][s0:s0 + 1024] for n in ("rot", "hi", "lo"))
        pts = rows_times(cloud[None] - h[:, None], R.transpose(1, 2)) \
            + l[:, None]
        v = torch.round((pts - origin) * inv).to(torch.int64)
        inb = ((v >= 0) & (v < dims)).all(dim=-1)
        idx = (v[..., 0] * dims[1] + v[..., 1]) * dims[2] + v[..., 2]
        flat.append(torch.where(inb, idx, -1).to(torch.int32))
        inb_all.append(inb)
    gidx = torch.cat(flat)
    P, A = gidx.shape
    ok = gidx >= 0
    vn = vox.cpu().numpy().astype(np.int64)
    at = gidx[ok].long().cpu().numpy()
    X, Y, Z = (int(d) for d in field.shape)
    set_f = field.reshape(-1)[gidx[ok].long()].cpu().numpy() > 0
    cs.say(f"K12: {P} pairs x {A} anchors = {P * A} moved anchors, "
           f"{int(ok.sum())} in the grid ({float(ok.float().mean()):.4f}); "
           f"field {X}x{Y}x{Z}, {int((field > 0).sum())} voxels set, "
           f"{int(set_f.sum())} in-grid anchors on a set voxel; "
           f"{vn.shape[0]} map anchors, r {r_vox}")
    for edge in (8, 4):
        cells = coarse_cells((X, Y, Z), vn, int(r_vox), edge)
        ix, iy, iz = at // (Y * Z), (at // Z) % Y, at % Z
        hit = cells[ix // edge, iy // edge, iz // edge]
        cs.say(f"  cells of edge {edge}: {cells.shape}, {cells.size / 8:.0f} "
               f"B as bits, {int(cells.sum())} set "
               f"({cells.mean():.4f}); {int(hit.sum())} in-grid anchors in "
               f"a set cell ({hit.mean():.4f} of those in the grid, "
               f"{hit.sum() / (P * A):.4f} of all)")
        cs.check(hit[set_f].all(), f"a set voxel lies in a clear cell of "
                 f"edge {edge}")
    k16_in = []
    for r, c in enumerate(posts):
        a = c[:17]
        cs.say(f"K16 round {r}: {a[2].shape[0]} lanes x {a[7].shape[0]} "
               f"atoms, {a[8].shape[0]} anchors x {a[9].shape[0]} map "
               f"anchors, {a[10].shape[0]} earlier solutions")
        k16_in.append((f"round {r}", a))
    mc = cfg.match
    match = (fit["map_set"], fit["sub_set"], fit["dmap"].shape,
             fit["dmap"].origin, fit["dmap"].voxsp, mc,
             cfg.filter.n_samples * cs.N_COPIES)
    torch.save({"K12": k12, "K12 voxels": gidx.cpu(), "K16": k16_in,
                "match": match}, path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    groups = set(args.variants.split(",")) - {""}
    first = ((PARENT if "parent" in groups else ())
             + (GATHER if "gather" in groups else ()))
    here = ((APPROX if "approx" in groups else ())
            + (LANES if "lanes" in groups else ()))
    variants = {"A": first + (() if args.parent else here), "B": here}
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from mad_tpu_torch.kernels import build
    from torch_refine_describe_probe import same_bits
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = str(build.BUILD_DIR / "probe_approx_lanes_inputs.pt")
    record(cs, path)
    torch.cuda.empty_cache()
    dirs = {"A": args.parent or ROOT, "B": ROOT}
    order = args.order if args.parent else "A"
    outs, times = {}, {"A": [], "B": []}
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    for i, side in enumerate(order):
        root = os.path.abspath(dirs[side])
        out = str(build.BUILD_DIR / f"probe_approx_lanes_out_{side}.pt")
        proc = subprocess.run(
            [sys.executable, "-c", CHILD,
             os.path.join(ROOT, "chip_smoke.py"), path, out, json.dumps(
                 variants[side] if order.index(side) == i else ()),
             GATHER_SRC, json.dumps(K12_CLOCK_PHASES)], cwd=root, env=env,
            capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            raise SystemExit(f"run {i} ({side}, {root}) failed")
        res = json.loads(line[0][7:])
        times[side].append(res)
        print(f"run {i} {side} ({root}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items()), flush=True)
        outs.setdefault(side, torch.load(out, weights_only=False))
    if len(outs) == 2:
        for key, a in outs["A"].items():
            if key not in outs["B"]:
                continue
            same = all(same_bits(x, y) for x, y in zip(a, outs["B"][key]))
            print(f"{key}: A and B " + ("equal bit for bit" if same
                                         else "DIFFER"), flush=True)
            cs.check(same, f"{key} differs between the checkouts")
        # the fold's outputs against A's lane and dedup entries
        for key, got in outs["B"].items():
            if key.endswith(" fold"):
                base = key[:-len(" fold")]
                want = outs["A"][base + " lanes"] + outs["A"][base + " dedup"]
                same = all(same_bits(x, y) for x, y in zip(got, want))
                print(f"{key}: B's fold and A's two entries "
                      + ("equal bit for bit" if same else "DIFFER"),
                      flush=True)
                cs.check(same, f"{key} differs from A's two entries")
    for side in "AB":
        runs = times[side]
        if runs:
            print(f"mean {side} over {len(runs)} runs: " + ", ".join(
                f"{k} {sum(r[k] for r in runs) / len(runs):.4f}"
                for k in runs[0] if k in runs[-1]), flush=True)


if __name__ == "__main__":
    main()
