#!/usr/bin/env python3
"""Kernel rows and fit stages of chip_smoke.py for two checkouts of the
port, timed in interleaved order on one NVIDIA card.

    python3 scripts/torch_kernel_abba.py DIR_A DIR_B [--order ABBA]
        [--kernels peak_mask_compact,localize,orient,descriptor_hist,
                   axis_flags,approx_repeat,post_lanes,post_dedup]
        [--fits 0] [--bodies] [--echo "  K9 ,  K19"]

Each DIR holds a checkout (its chip_smoke.py and mad_tpu_torch/). For
every letter of ``--order`` (A the first directory, B the second), one
process in that directory builds the checkout's kernels, runs
chip_smoke's bench fit once (warm), then ``--fits`` timed fits (stage
seconds, peak device memory, K1's launches: ``conv1d`` plus ``log_gauss``
where the checkout has it, all kernel launches, and the copies recovered,
best CA-RMSD below chip_smoke.RECOVER_RMSD), then its
kernel_checks (each kernel at the bench fit's inputs against its plain
version, CUDA events, mean of three after a warm call), and prints the
chosen rows' kernel and plain ms, and the kernel alone where the row has
it (``kernel_ms``: K4's, K5's, K7's, K8's, K14's, K15's, K16's and K18's
rows; K8's also at the subunit's call where the checkout reports it;
a row the checkout lacks is skipped; rows all of K2, K3 and K8
(``upsample2``, ``gradient``, ``gather_norm``) run chip_smoke's
describe_checks alone; ``localize`` (K5, one row a launch at the fit's
four octaves, its wrapper over 20 calls, and the host's time a call over
200 with no sync; ``detect_anchors`` at the map's two, the span from K4
to the anchor table) and ``axis_flags`` (K22 on the unreduced bench map
and on a view of it off 16-byte alignment) are recorded and timed by the
child itself, so they take no other phase, as are ``approx_repeat``,
``post_lanes`` and ``post_dedup`` (K12 and K16's lane and dedup entries at
the inputs of one more bench fit, with the fold of the two where the
checkout has it, ``post_dedup[fold]``, the round, ``post_dedup[round]``,
and the match stage, ``approx_repeat[match]``, in events);
the parent's ``upsample_axis``, K2's three per-axis launches, stands for
``upsample2``, the same work in one launch).
``--bodies``: the simulation body (``ops/simulate._simulate_batch``) at
each of the fit's simulate calls, recorded in one more fit, timed (CUDA
events, mean of three after a warm call) with the device memory it holds
at its peak. ``--echo``: the child's output lines that start with one of
the comma-separated prefixes (kernel_checks' per-shape lines). Then, per
checkout, each row's mean and each stage's median over its fits. Prints
the card's name and power limit first. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

CHILD = r"""
import json, sys, time, torch
import chip_smoke as cs
from mad_tpu_torch import kernels
from mad_tpu_torch.ops import simulate
from mad_tpu_torch.testing import recording
names, fits, bodies = sys.argv[1].split(","), int(sys.argv[2]), sys.argv[3]
DESCRIBE_ROWS = {"upsample2", "gradient", "gather_norm"}
device, _smi = cs.device_phase()
cs.build_phase()
cfg = cs.bench_config()
fit = cs.run_fit(device, {}, cfg)
torch.cuda.synchronize()
passes = []
for _ in range(fits):
    del fit
    t = {}
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = cs.run_fit(device, t, cfg)
    torch.cuda.synchronize()
    t["fit"] = time.perf_counter() - t0
    t["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = kernels.launch_counts()
    t["k1_launches"] = counts["conv1d"] + counts.get("log_gauss", 0)
    t["launches"] = sum(counts.values())
    t["recovered"] = sum(r < cs.RECOVER_RMSD for r in cs.best_rmsds(
        [s.structure for s in fit["sols"]], fit["copies"]))
    passes.append(t)
print("FITS " + json.dumps(passes))
body = {}
if bodies == "1":
    with recording(simulate, "_simulate_batch") as sims:
        cs.run_fit(device, None, cfg)
    for label, args in zip(("map", "subunit", "score", "overlap",
                            "score_models"), sims):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        simulate._simulate_batch(*args)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        body[label] = [cs.cuda_ms(lambda: simulate._simulate_batch(*args)),
                       peak]
    del sims
print("BODY " + json.dumps(body))
RECORDED = {"localize", "detect_anchors", "axis_flags", "approx_repeat",
            "post_lanes", "post_dedup"}
rows = {}
if {"localize", "detect_anchors"} & set(names):
    # K5 per launch at the fit's four octaves and detect_anchors at each map
    # octave, recorded at their call sites in this checkout (the flat form
    # where it has one, else the seed form) and timed here
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.kernels import localize as k5
    from mad_tpu_torch.ops import detect
    site = "localize_peaks" if hasattr(detect, "localize_peaks") \
        else "localize"
    fn, plain = getattr(k5, site), getattr(k5, site + "_plain")
    with recording(detect, site) as k5_calls, \
            recording(pipeline, "detect_anchors") as detects:
        pipeline.describe_grid(fit["dmap"], cfg, name="m", device=device)
    with recording(detect, site) as sub_calls:
        pipeline.describe_structure(fit["moved"], cs.RES, fit["dmap"].voxsp,
                                    cfg, device=device)
    for label, args in zip(cs.K4_SHAPES, k5_calls + sub_calls):
        rows[f"localize[{label}]"] = dict(
            ms=cs.cuda_ms(lambda: fn(*args), reps=20),
            plain_ms=cs.cuda_ms(lambda: plain(*args)),
            kernel_ms=cs.alone_ms(lambda: fn(*args)))
        # the host's time a call, 200 calls with no sync between them
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(*args)
        rows[f"localize host[{label}]"] = dict(
            ms=(time.perf_counter() - t0) / 200 * 1e3, plain_ms=None)
        torch.cuda.synchronize()
    for label, args in zip(cs.K4_SHAPES, detects):
        rows[f"detect_anchors[{label}]"] = dict(
            ms=cs.cuda_ms(lambda: detect.detect_anchors(*args), reps=10),
            plain_ms=None)
    del k5_calls, sub_calls, detects
if "axis_flags" in names:
    # K22 on the unreduced bench map and on its view off 16-byte alignment
    from mad_tpu_torch.kernels import crop_pad as k22
    raw = cs.unreduced_map(device).data
    X, Y, Z = raw.shape
    view = raw.reshape(-1)[1:1 + (X - 1) * Y * Z].view(X - 1, Y, Z)
    for label, v in (("map", raw), ("view off alignment", view)):
        rows[f"axis_flags[{label}]"] = dict(
            ms=cs.cuda_ms(lambda: k22.axis_flags(v), reps=10),
            plain_ms=cs.cuda_ms(lambda: k22.axis_flags_plain(v)),
            kernel_ms=cs.alone_ms(lambda: k22.axis_flags(v)))
    del raw, view
if {"approx_repeat", "post_lanes", "post_dedup"} & set(names):
    # K12, K16's lane and dedup entries (the round's first, on stage inputs
    # from the plain stages before each) and the fold of the two where this
    # checkout has it, recorded at their call sites in one more fit of this
    # checkout and timed here; the round (docking.post) and the match stage
    # whole, in events
    from mad_tpu_torch.engine import docking, match as em
    from mad_tpu_torch.kernels import approx as k12, post as k16
    with recording(em, "approx_repeat") as c12, \
            recording(docking, "post") as posts:
        cs.run_fit(device, None, cfg)
    timed = lambda fn, plain: dict(
        ms=cs.cuda_ms(fn, reps=20),
        plain_ms=None if plain is None else cs.cuda_ms(plain),
        kernel_ms=cs.alone_ms(fn))
    a12, a17 = c12[0], posts[0][:17]
    st = cs.stage_inputs(a17)
    la, da = st["post_lanes"], st["post_dedup"]
    rows["approx_repeat"] = timed(lambda: k12.approx_repeat(*a12),
                                  lambda: k12.approx_repeat_plain(*a12))
    rows["post_lanes"] = timed(lambda: k16.post_lanes(*la),
                               lambda: k16.post_lanes_plain(*la))
    rows["post_dedup"] = timed(lambda: k16.post_dedup(*da),
                               lambda: k16.post_dedup_plain(*da))
    if hasattr(k16, "post_lanes_dedup"):
        rows["post_dedup[fold]"] = timed(
            lambda: k16.post_lanes_dedup(*a17[:14]),
            lambda: k16.post_lanes_dedup_plain(*a17[:14]))
    rows["post_dedup[round]"] = dict(ms=cs.cuda_ms(lambda: k16.post(*a17),
                                                   reps=20), plain_ms=None)
    m, s, dm, mc = fit["map_set"], fit["sub_set"], fit["dmap"], cfg.match
    rows["approx_repeat[match]"] = dict(ms=cs.cuda_ms(
        lambda: em.match_descriptors(
            m, s, dm.shape, dm.origin, dm.voxsp, mc,
            min_exact=cfg.filter.n_samples * cs.N_COPIES, device=device),
        reps=7), plain_ms=None)
    del c12, posts, st, la, da
rest = [n for n in names if n and n not in RECORDED]
# rows all of describe_checks (K2, K3, K5, K8): that phase alone
if rest and set(rest) <= DESCRIBE_ROWS:
    rows.update(cs.describe_checks(fit, cfg, device))
elif rest:
    rows.update(cs.kernel_checks(fit, cfg, device))
# a row under its older name: K2's three per-axis launches (upsample_axis)
# are the same work on the same input as its one launch (upsample2)
for new, old in (("upsample2", "upsample_axis"),):
    if new not in rows and old in rows:
        rows[new] = rows[old]
print("ROWS " + json.dumps({n: [rows[n]["ms"], rows[n]["plain_ms"],
                                rows[n].get("kernel_ms"),
                                rows[n].get("sub_kernel_ms")]
                            for n in rows
                            if n.split("[")[0] in names or "[" in n}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs=2)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--kernels",
                    default="peak_mask_compact,localize,orient,"
                            "descriptor_hist,axis_flags")
    ap.add_argument("--fits", type=int, default=0)
    ap.add_argument("--bodies", action="store_true")
    ap.add_argument("--echo", default="")
    args = ap.parse_args()
    echo = tuple(p for p in args.echo.split(",") if p)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    got = {"A": [], "B": []}
    fits = {"A": [], "B": []}
    for i, side in enumerate(args.order):
        root = os.path.abspath(args.dirs["AB".index(side)])
        proc = subprocess.run([sys.executable, "-c", CHILD, args.kernels,
                               str(args.fits), str(int(args.bodies))],
                              cwd=root, capture_output=True, text=True)
        lines = {x[:5]: x[5:].strip() for x in proc.stdout.splitlines()
                 if x.startswith(("ROWS ", "FITS ", "BODY "))}
        if proc.returncode != 0 or len(lines) != 3:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            raise SystemExit(f"run {i} ({side}, {root}) failed")
        rows, passes = json.loads(lines["ROWS "]), json.loads(lines["FITS "])
        got[side].append(rows)
        fits[side] += passes
        print(f"run {i} {side} ({root}): " + ", ".join(
            f"{n} {k:.4f} ms ("
            + ("no plain" if p is None else f"plain {p:.4f}")
            + ("" if a is None else f", kernel alone {a:.4f}")
            + ("" if b is None else f", the subunit's alone {b:.4f}") + ")"
            for n, (k, p, a, b) in rows.items()), flush=True)
        for label, (ms, mib) in json.loads(lines["BODY "]).items():
            print(f"  body {side} {label}: {ms:.4f} ms, peak {mib:.1f} MiB",
                  flush=True)
        for x in proc.stdout.splitlines():
            if echo and x.startswith(echo):
                print(f"  {side}|{x}", flush=True)
        for t in passes:
            print(f"  fit {side}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    for side in "AB":
        runs = got[side]
        if runs and runs[0]:
            print(f"mean {side} over {len(runs)} runs: " + ", ".join(
                f"{n} {sum(r[n][0] for r in runs) / len(runs):.4f} ms"
                + ("" if runs[0][n][2] is None else
                   f" (kernel alone "
                   f"{sum(r[n][2] for r in runs) / len(runs):.4f})")
                + ("" if runs[0][n][3] is None else
                   f" (the subunit's alone "
                   f"{sum(r[n][3] for r in runs) / len(runs):.4f})")
                for n in runs[0]))
        if fits[side]:
            keys = fits[side][0].keys()
            print(f"fits {side}, median (min, max) of {len(fits[side])}: "
                  + ", ".join(
                      f"{k} {np.median([t[k] for t in fits[side]]):.4f} "
                      f"({min(t[k] for t in fits[side]):.4f}, "
                      f"{max(t[k] for t in fits[side]):.4f})"
                      for k in keys), flush=True)


if __name__ == "__main__":
    main()
