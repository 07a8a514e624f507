#!/usr/bin/env python3
"""K15 (the refinement loop) and K7 (the descriptor histograms) on one
NVIDIA card: where their time goes, and two checkouts' kernels held bit
for bit and timed in turns.

    python3 scripts/torch_refine_describe_probe.py [--parent DIR]
        [--order ABBA] [--variants parent,refine,describe]
        [--clusters 2,8]

Runs chip_smoke.py's bench fit once in this checkout and records the
inputs of K15 (the bench's first-round candidates, as
chip_smoke.refine_check takes them) and of K7 (its four calls of one
describe_grid of the bench map and one describe_structure of the
subunit), saved under mad_tpu_torch/_build/. Prints K15's steps (min,
max, sum) and, per octave, the lanes that K7's bounds test puts out of
bounds. Then, for every letter of ``--order`` (A the checkout ``--parent``,
B this one; this one alone, once, without ``--parent``), one process in
that checkout
loads the inputs, runs its own K15 and K7 on them and times, with CUDA
events, each kernel alone (``bare``: the wrapper's one launch repeated on
the same buffers, chip_smoke.kernel_ms) and each wrapper
(chip_smoke.cuda_ms, mean of ten); K15 also at min_step 0, where every
candidate that does not fail runs all n_steps steps (its time a step).
The two checkouts' outputs (K15's rot, trans, coords, frozen, steps and
failed; K7's rows and ok flags at each octave) are held equal bit for
bit. Each of ``--variants`` times, on the same recorded launches
(kernel alone), builds of a checkout's csrc/refine.cu or
csrc/describe.cu with lines changed:
  * parent (in A's first process; the forms before the H100 redesign):
    K15 at min_step 0 without its second pass over the atoms (the moved
    coordinates' finiteness and displacement test); K7 with its
    shared-memory atomic replaced by a register sum, with its zone scan
    replaced by zone 0 (atan2 / acos then unused), and with only its
    gathers (each sample's loads kept by a test);
  * refine (in B's first process, or A's without ``--parent``): K15
    without its field loads (a constant in their place) and with the
    cluster barrier replaced by the CTA's own (each CTA's warps write their
    partials only into its own shared memory, zeroed first; sums then
    wrong, at min_step 0 the same step count), and at each
    cluster size of ``--clusters`` (kCluster);
  * describe (the same process): K7 with its gathers alone (each
    sample's zone replaced by a test that keeps its loads), without
    atan2 / acos (the zone table still walked), and with its narrow or
    its wide block at every lane count (kWarps, kWideWarps, kWideBelow).
Prints the card's name and power limit first. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K7_LABELS = ("map upsampled", "map base", "subunit upsampled",
             "subunit base")

# Run in a checkout (cwd), its mad_tpu_torch; the helpers (bare,
# kernel_ms, ...) from this checkout's chip_smoke, loaded by path.
CHILD = r"""
import dataclasses, importlib.util, json, re, sys, torch
from mad_tpu_torch.core.config import RefineConfig
from mad_tpu_torch.kernels import build, describe as k7, refine as k15
smoke, inputs, out_path, variants, labels = (
    sys.argv[1], sys.argv[2], sys.argv[3], json.loads(sys.argv[4]),
    sys.argv[5:])
spec = importlib.util.spec_from_file_location("smoke_helpers", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
device, _smi = cs.device_phase()
cs.build_phase()
inp = torch.load(inputs, weights_only=False, map_location=device)
rc = RefineConfig(**inp["rc"])
rc0 = dataclasses.replace(rc, min_step=0.0)
a15 = inp["a15"]
res, outs = {}, {}
ms = lambda fn: cs.cuda_ms(fn, reps=10)
outs["K15"] = [t.cpu() for t in k15.refine_loop(*a15, rc)]
r15 = cs.bare(lambda: k15.refine_loop(*a15, rc))
res["K15 alone"] = cs.kernel_ms(r15)
res["K15 wrapper"] = ms(lambda: k15.refine_loop(*a15, rc))
steps0 = k15.refine_loop(*a15, rc0)[4]
res["K15 min_step 0 steps max"] = int(steps0.max())
r15z = cs.bare(lambda: k15.refine_loop(*a15, rc0))
res["K15 min_step 0 alone"] = cs.kernel_ms(r15z, reps=5)
l7 = []
for label, a in zip(labels, inp["a7"]):
    outs["K7 " + label] = [t.cpu() for t in k7.descriptor_hist(*a)]
    r7 = cs.bare(lambda: k7.descriptor_hist(*a))
    l7.append(r7)
    res[f"K7 {label} alone"] = cs.kernel_ms(r7)
    res[f"K7 {label} wrapper"] = ms(lambda: k7.descriptor_hist(*a))
for name, src, fn_name, edits in variants:
    text = (build.CSRC / src).read_text()
    for old, new in edits:
        cs.check(len(re.findall(old, text, re.S)) == 1,
                 f"csrc/{src} has no single {old!r}")
        text = re.sub(old, new, text, flags=re.S)
    import torch_refine_describe_probe as probe
    fn = probe.compiled(build, name, text, fn_name)
    if src == "refine.cu":
        res[f"K15 alone, {name}"] = cs.kernel_ms(
            lambda: build.launch(fn, *r15.call[1:]))
        res[f"K15 min_step 0 alone, {name}"] = cs.kernel_ms(
            lambda: build.launch(fn, *r15z.call[1:]), reps=5)
    else:
        for label, r7 in zip(labels, l7):
            res[f"K7 {label} alone, {name}"] = cs.kernel_ms(
                lambda: build.launch(fn, *r7.call[1:]))
torch.save(outs, out_path)
print("RESULT " + json.dumps(res))
"""

# Builds with lines changed: (name, source, export, [(regex, replacement),
# ...]). The forms before the H100 redesign:
PARENT = (
    ("without the second pass", "refine.cu", "mad_refine",
     [(r"(float dmax = 0\.0f;\s*bool bad = false;\s*for \(int i = tid; "
       r"i < )N(; i \+= kThreads\))", r"\g<1>0\g<2>")]),
    ("register sum for the atomic", "describe.cu", "mad_descriptor_hist",
     [(r"(\n  for \(int p = threadIdx\.x; p < P;)",
       r"\n  int regsum = 0;\g<1>"),
      (r"atomicAdd\(&hist\[region\[p\] \* nzones \+ zone\], 1\);",
       "regsum += region[p] * nzones + zone;"),
      (r"(\n  __syncthreads\(\);\n  const bool ok)",
       r"\n  if (regsum == -7) hist[0] = 1;\g<1>")]),
    ("zone 0 for the scan", "describe.cu", "mad_descriptor_hist",
     [(r"for \(int z = 0; z < nzones; \+\+z\)",
       "for (int z = 0; z < 0; ++z)")]),
    ("gathers alone", "describe.cu", "mad_descriptor_hist",
     [(r"const float magn = .*?atomicAdd\([^;]*;",
       "if (g[0] + g[1] + g[2] == 12345.f) hist[0] = 1;")]),
)


# ... and the redesigned K15 and K7:
REFINE = (
    ("without field loads", "refine.cu", "mad_refine",
     [(r"\(live && gather\) \? load_field\(v \+ j\) : 0\.0f",
       "(live && gather) ? 0.25f : 0.0f")]),
    ("CTA barrier for the cluster's", "refine.cu", "mad_refine",
     [(r"cg::this_cluster\(\)\.sync\(\);", "__syncthreads();"),
      (r"dst = cg::this_cluster\(\)\.map_shared_rank\(dst, r\);", ";"),
      (r"(__shared__ float part\[2\]\[kWarps\]\[kParts\];)",
       r"\g<1>\n  for (int q = threadIdx.x; q < 2 * kWarps * kParts; "
       r"q += blockDim.x) (&part[0][0][0])[q] = 0.0f;\n  __syncthreads();")]),
)
DESCRIBE = (
    ("gathers alone", "describe.cu", "mad_descriptor_hist",
     [(r"zone = zone_of\(g, R, zt, cutoff, zero_magn\);",
       "zone = (g[0] + g[1] + g[2] == 12345.f) ? 0 : -1;")]),
    ("without atan2 / acos", "describe.cu", "mad_descriptor_hist",
     [(r"atan2f\(d\[1\], d\[0\]\)", "(d[1] - d[0])"),
      (r"acosf\((fminf\(fmaxf\(d\[2\], -1\.0f\), 1\.0f\))\)",
       r"\g<1>")]),
    ("kWarps always", "describe.cu", "mad_descriptor_hist",
     [(r"kWideBelow = [^;]+;", "kWideBelow = 0;")]),
    ("kWideWarps always", "describe.cu", "mad_descriptor_hist",
     [(r"kWideBelow = [^;]+;", "kWideBelow = 1 << 30;")]),
    ("kWideWarps 32 below kWideBelow", "describe.cu", "mad_descriptor_hist",
     [(r"kWideWarps = \d+;", "kWideWarps = 32;")]),
)


def compiled(build, name, source, fn_name):
    """The export ``fn_name`` of ``source`` built with the port's nvcc
    flags into mad_tpu_torch/_build/, its ctypes signature set."""
    import ctypes
    stem = "probe_" + "".join(c if c.isalnum() else "_" for c in name)
    src, so = build.BUILD_DIR / f"{stem}.cu", build.BUILD_DIR / f"{stem}.so"
    src.write_text(source)
    subprocess.run([build._nvcc()] + build.ARCH_FLAGS + build.NVCC_FLAGS
                   + ["-I", str(build.CSRC), "-shared", "-o", str(so),
                      str(src)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(so)), fn_name)
    fn.argtypes = build.SIGNATURES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def record(cs, path):
    """Run the bench fit, save K15's and K7's inputs to ``path``; print
    K15's steps and K7's out-of-bounds lanes."""
    import dataclasses
    import torch
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.engine.cluster import filter_pairs
    from mad_tpu_torch.engine.docking import start_poses
    from mad_tpu_torch.engine.match import match_descriptors
    from mad_tpu_torch.engine.refine import refine_inputs
    from mad_tpu_torch.kernels import describe as k7, refine as k15
    from mad_tpu_torch.ops import describe
    from mad_tpu_torch.testing import recording
    device, _smi = cs.device_phase()
    cs.build_phase()
    cfg = cs.bench_config()
    fit = cs.run_fit(device, None, cfg)
    m, s, dmap, moved = (fit["map_set"], fit["sub_set"], fit["dmap"],
                         fit["moved"])
    n_samples = cfg.filter.n_samples * cs.N_COPIES
    table = match_descriptors(m, s, dmap.shape, dmap.origin, dmap.voxsp,
                              cfg.match, min_exact=n_samples, device=device)
    cands = filter_pairs(table, s.main_bin[table.hi_idx],
                         m.main_bin[table.lo_idx], cfg.filter, n_samples)
    a15 = refine_inputs(dmap, start_poses(cands, moved), device)
    steps = k15.refine_loop(*a15, cfg.refine)[4].cpu().numpy()
    C, N = a15[1].shape[:2]
    cs.say(f"K15: {C} candidates x {N} atoms, steps {steps.min()}-"
           f"{steps.max()} (sum {steps.sum()})")
    with recording(describe, "descriptor_hist") as a7:
        pipeline.describe_grid(dmap, cfg, device=device)
        pipeline.describe_structure(moved, cs.RES, dmap.voxsp, cfg,
                                    device=device)
    cs.check(len(a7) == len(K7_LABELS), f"K7 ran {len(a7)} times")
    for label, a in zip(K7_LABELS, a7):
        ok = k7.descriptor_hist(*a)[1]
        valid = a[3]
        oob = int((valid & ~ok).sum())
        cs.say(f"K7 {label}: grad {tuple(a[0].shape)} {a[0].dtype}, "
               f"{len(ok)} lanes, {int(valid.sum())} valid, {oob} out of "
               f"bounds ({oob / max(1, int(valid.sum())):.2%})")
    torch.save(dict(a15=a15, rc=dataclasses.asdict(cfg.refine),
                    a7=[tuple(a) for a in a7]), path)


def same_bits(a, b):
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--variants", default="")
    ap.add_argument("--clusters", default="")
    args = ap.parse_args()
    groups = set(args.variants.split(",")) - {""}
    clusters = tuple((f"kCluster {k}", "refine.cu", "mad_refine",
                      [(r"constexpr int kCluster = \d+;",
                        f"constexpr int kCluster = {k};")])
                     for k in args.clusters.split(",") if k)
    here = ((DESCRIBE if "describe" in groups else ())
            + (REFINE + clusters if "refine" in groups else ()))
    variants = {"A": (PARENT if "parent" in groups else ())
                + (() if args.parent else here), "B": here}
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from mad_tpu_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = str(build.BUILD_DIR / "probe_inputs.pt")
    record(cs, path)
    torch.cuda.empty_cache()
    dirs = {"A": args.parent, "B": ROOT}
    order = args.order if args.parent else "A"
    dirs["A"] = dirs["A"] or ROOT
    outs, times = {}, {"A": [], "B": []}
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    for i, side in enumerate(order):
        root = os.path.abspath(dirs[side])
        out = str(build.BUILD_DIR / f"probe_out_{side}.pt")
        proc = subprocess.run(
            [sys.executable, "-c", CHILD,
             os.path.join(ROOT, "chip_smoke.py"), path, out, json.dumps(
                variants[side] if order.index(side) == i else ()),
             *K7_LABELS],
            cwd=root, env=env, capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            raise SystemExit(f"run {i} ({side}, {root}) failed")
        res = json.loads(line[0][7:])
        times[side].append(res)
        print(f"run {i} {side} ({root}): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in res.items()), flush=True)
        outs.setdefault(side, torch.load(out, weights_only=False))
    if len(outs) == 2:
        for key, a in outs["A"].items():
            b = outs["B"][key]
            same = all(same_bits(x, y) for x, y in zip(a, b))
            print(f"{key}: A and B " + ("equal bit for bit" if same
                                         else "DIFFER"), flush=True)
            cs.check(same, f"{key} differs between the checkouts")
    for side in "AB":
        runs = times[side]
        if runs:
            print(f"mean {side} over {len(runs)} runs: " + ", ".join(
                f"{k} {sum(r[k] for r in runs) / len(runs):.4f}"
                for k in runs[0] if k in runs[-1] and ("alone" in k or
                                                       "wrapper" in k)),
                flush=True)


if __name__ == "__main__":
    main()
