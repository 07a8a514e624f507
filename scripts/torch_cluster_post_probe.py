#!/usr/bin/env python3
"""K14 (pose clustering) and K16's five stage entries (the post-refine
merge) on one NVIDIA card: where their time goes, and two checkouts'
kernels held bit for bit and timed in turns.

    python3 scripts/torch_cluster_post_probe.py [--parent DIR]
        [--order ABBA] [--variants parent,cluster,post]

Runs chip_smoke.py's bench fit once in this checkout and records the
inputs of every K14 call and every K16 round (``docking.post``) of its dock
(one each on the bench: the first round's, 600 rows to cluster), saved
under mad_tpu_torch/_build/. K14 also runs on
chip_smoke's 4,000-row stress table at three rmsd_cloud values (the
default, every row its own cluster, one cluster). K16's stage inputs are
chip_smoke.stage_inputs' (each stage's inputs from the plain versions of
the stages before it), so both checkouts see the same bytes; the lane,
point and row stages also run on a ragged range.
Prints, per recorded input, its clusters and the founders ahead of each
row (K14) and the rows off the map-anchor cloud (K16's row stage).

Then, for every letter of ``--order`` (A the checkout ``--parent``, B this
one; this one alone, once, without ``--parent``), one process in that
checkout loads the inputs, runs its own kernels on them and times each
entry alone (``bare``: the wrapper's one launcher call repeated on the
same buffers, chip_smoke.kernel_ms) and its wrapper (chip_smoke.cuda_ms,
mean of ten). The two checkouts' outputs (K14's selection vectors, K16's
stage outputs) are held equal bit for bit. Each of ``--variants`` times,
on the same recorded launcher calls (alone), builds of a checkout's
csrc/cluster.cu or csrc/post.cu with lines changed (built by
torch_refine_describe_probe.compiled):
  * parent (in A's first process; the forms before the H100 redesign):
    K14 with no cloud RMSD (its row loop, barriers and founding alone:
    every row founds); K16's dedup with its RMSD launch alone and its
    scan launch alone; K16's points with every atom's coordinates a
    constant (its L2 traffic gone, the arithmetic kept);
  * cluster (in B's first process, or A's without ``--parent``): K14's
    near-pair launch alone, with the founder scan, and its assignment
    alone (its ticket then never elects a last block: no ranking);
  * post (the same process): K16's points at tiles of 64 points (two a
    lane), its dedup without the scan, and its compaction without its
    row writes.
Prints the card's name and power limit first. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

from torch_refine_describe_probe import same_bits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run in a checkout (cwd), its mad_tpu_torch; the helpers (bare,
# kernel_ms, ...) from this checkout's chip_smoke, loaded by path.
CHILD = r"""
import importlib.util, json, re, sys, torch
from mad_tpu_torch.kernels import build, cluster as k14, post as k16
smoke, inputs, out_path, variants = (sys.argv[1], sys.argv[2], sys.argv[3],
                                     json.loads(sys.argv[4]))
spec = importlib.util.spec_from_file_location("smoke_helpers", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
device, _smi = cs.device_phase()
cs.build_phase()
inp = torch.load(inputs, weights_only=False, map_location=device)
res, outs, bares = {}, {}, {}
ms = lambda fn: cs.cuda_ms(fn, reps=10)
for label, a in inp["k14"]:
    outs["K14 " + label] = [k14.cluster_select(*a).cpu()]
    if label in inp["k14_timed"]:
        r = cs.bare(lambda: k14.cluster_select(*a))
        bares["K14 " + label] = r
        res[f"K14 {label} alone"] = cs.kernel_ms(r)
        res[f"K14 {label} wrapper"] = ms(lambda: k14.cluster_select(*a))
for label, stages in inp["k16"]:
    for name, a in stages:
        fn = getattr(k16, name)
        got = fn(*a)
        outs[f"K16 {label} {name}"] = [
            t.cpu() for t in (got if isinstance(got, tuple) else (got,))]
        if label in inp["k16_timed"]:
            r = cs.bare(lambda: fn(*a))
            bares[f"K16 {label} {name}"] = r
            res[f"K16 {label} {name} alone"] = cs.kernel_ms(r)
            res[f"K16 {label} {name} wrapper"] = ms(lambda: fn(*a))
for name, src, fn_name, edits in variants:
    text = (build.CSRC / src).read_text()
    for old, new in edits:
        cs.check(len(re.findall(old, text, re.S)) == 1,
                 f"csrc/{src} has no single {old!r}")
        text = re.sub(old, new, text, flags=re.S)
    import torch_refine_describe_probe as probe
    fn = probe.compiled(build, name, text, fn_name)
    for key, r in bares.items():
        if r.call[0].__name__ == fn_name:
            res[f"{key} alone, {name}"] = cs.kernel_ms(
                lambda: build.launch(fn, *r.call[1:]))
torch.save(outs, out_path)
print("RESULT " + json.dumps(res))
"""

# Builds with lines changed: (name, source, export, [(regex, replacement),
# ...]). The forms before the H100 redesign:
PARENT = (
    ("no cloud RMSD", "cluster.cu", "mad_cluster_select",
     [(r"(int bj = INT_MAX;\s*for \(int c = threadIdx\.x; c < )ncl;",
       r"\g<1>0;")]),
    ("RMSD launch alone", "post.cu", "mad_post_dedup",
     [(r"post_scan<<<1, 32, 0, stream>>>\(failed, S, C, rmat, dedup, "
       r"lane_of,\s*counts, out_acc, out_slot\);", "")]),
    ("scan launch alone", "post.cu", "mad_post_dedup",
     [(r"post_rmsd<<<C, kThreads, 0, stream>>>\(coords, prev, S, C, N, "
       r"idx, n,\s*rmat\);", "")]),
    ("atoms not loaded", "post.cu", "mad_post_points",
     [(r"dist2\(p, prev\[3 \* t\], prev\[3 \* t \+ 1\],\s*"
       r"prev\[3 \* t \+ 2\]\)", "dist2(p, 1.0 * t, 2.0, 3.0)"),
      (r"dist2\(p, static_cast<double>\(coords\[3 \* k\]\),\s*"
       r"static_cast<double>\(coords\[3 \* k \+ 1\]\),\s*"
       r"static_cast<double>\(coords\[3 \* k \+ 2\]\)\)",
       "dist2(p, 1.0 * k, 2.0, 3.0)")]),
)

# ... and the redesigned K14 and K16:
CLUSTER = (
    ("near pairs alone", "cluster.cu", "mad_cluster_select",
     [(r"\n  cluster_scan<<<.*?\n  return", "\n  return")]),
    ("near pairs and scan", "cluster.cu", "mad_cluster_select",
     [(r"\n  cluster_assign<<<.*?\n  return", "\n  return")]),
    ("assignment alone, no ranking", "cluster.cu", "mad_cluster_select",
     [(r"\n  cluster_near<<<.*?cluster_assign<<<", "\n  cluster_assign<<<")]),
)
POST = (
    ("points, tiles of 64", "post.cu", "mad_post_points",
     [(r"constexpr int kPointTile = \d+;", "constexpr int kPointTile = 64;")]),
    ("dedup without the scan", "post.cu", "mad_post_dedup",
     [(r"if \(!last_block\(reinterpret_cast<unsigned\*>\(lane_of \+ C\)\)\)"
       r" return;", "return;")]),
    ("compaction without its row writes", "post.cu", "mad_post_compact",
     [(r"out_rows\[pos\+\+\] = static_cast<double>\(r \+ __ffs\(m\) - 1\);",
       "++pos;")]),
)


def record(cs, path):
    """Run the bench fit with K14's and K16's call sites recorded; save
    their inputs (and the stress tables') to ``path``; print their
    shapes."""
    import numpy as np
    import torch
    from mad_tpu_torch.engine import docking
    from mad_tpu_torch.kernels import cluster as k14
    from mad_tpu_torch.testing import recording
    device, _smi = cs.device_phase()
    cs.build_phase()
    cfg = cs.bench_config()
    with recording(docking, "cluster_select") as k14_calls, \
            recording(docking, "post") as posts:
        cs.run_fit(device, None, cfg)
    k14_in = []
    for r, a in enumerate(k14_calls):
        n = a[0].shape[0]
        _assign, found, _w, _c, n_cands = k14.split_selection(
            k14.cluster_select_plain(*a).cpu().numpy(), n)
        ahead = np.searchsorted(found, np.arange(n)).sum()
        cs.say(f"K14 round {r}: {n} rows, {len(found)} clusters, {n_cands} "
               f"candidates, {ahead} (row, earlier founder) pairs")
        k14_in.append((f"round {r}", a))
    for label, rmsd in cs.K14_STRESS_RMSD:
        a = cs.k14_stress_args(device, rmsd)
        _assign, found, _w, _c, n_cands = k14.split_selection(
            k14.cluster_select(*a).cpu().numpy(), a[0].shape[0])
        cs.say(f"K14 stress {label}: {a[0].shape[0]} rows, {len(found)} "
               f"clusters, {n_cands} candidates")
        k14_in.append((f"stress {label}", a))
    k16_in = []
    for r, call in enumerate(posts):
        a = call[:17]
        C, N = a[2].shape[:2]
        lo_cloud, lo_rows = a[9], a[14]
        on = int((lo_rows[:, None] == lo_cloud[None]).all(dim=2).any(dim=1)
                 .sum()) if lo_rows.shape[0] else 0
        cs.say(f"K16 round {r}: {C} lanes x {N} atoms, {a[10].shape[0]} "
               f"earlier solutions, {lo_cloud.shape[0]} cloud points, "
               f"{lo_rows.shape[0]} table rows ({lo_rows.shape[0] - on} off "
               f"the cloud), n_top {a[16]}")
        B, P = lo_cloud.shape[0], lo_rows.shape[0]
        k16_in.append((f"round {r}", list(cs.stage_inputs(a).items())))
        ragged = cs.stage_inputs(a, [(min(3, m), max(0, m - 5))
                                     for m in (C, B, P)])
        k16_in.append((f"round {r} ragged", [
            (k, ragged[k]) for k in ("post_lanes", "post_points",
                                     "post_rows")]))
    torch.save(dict(k14=k14_in, k16=k16_in,
                    k14_timed=["round 0", "stress default", "stress own",
                               "stress one"],
                    k16_timed=[f"round {r}" for r in range(len(posts))]),
               path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    groups = set(args.variants.split(",")) - {""}
    here = ((CLUSTER if "cluster" in groups else ())
            + (POST if "post" in groups else ()))
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
    path = str(build.BUILD_DIR / "probe_cluster_post_inputs.pt")
    record(cs, path)
    torch.cuda.empty_cache()
    dirs = {"A": args.parent or ROOT, "B": ROOT}
    order = args.order if args.parent else "A"
    outs, times = {}, {"A": [], "B": []}
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    for i, side in enumerate(order):
        root = os.path.abspath(dirs[side])
        out = str(build.BUILD_DIR / f"probe_cluster_post_out_{side}.pt")
        proc = subprocess.run(
            [sys.executable, "-c", CHILD,
             os.path.join(ROOT, "chip_smoke.py"), path, out, json.dumps(
                 variants[side] if order.index(side) == i else ())],
            cwd=root, env=env, capture_output=True, text=True)
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
                for k in runs[0] if k in runs[-1]), flush=True)


if __name__ == "__main__":
    main()
