#!/usr/bin/env python3
"""Kernel rows and fit stages of chip_smoke.py for two checkouts of the
port, timed in interleaved order on one NVIDIA card.

    python3 scripts/torch_kernel_abba.py DIR_A DIR_B [--order ABBA]
        [--kernels peak_mask_compact,localize,orient,descriptor_hist]
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
a row the checkout lacks is skipped; rows all of K2, K3, K5 and K8
(``upsample2``, ``gradient``, ``localize``, ``gather_norm``) run
chip_smoke's describe_checks alone;
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
DESCRIBE_ROWS = {"upsample2", "gradient", "localize", "gather_norm"}
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
# rows all of describe_checks (K2, K3, K5, K8): that phase alone
if set(names) <= DESCRIBE_ROWS:
    rows = cs.describe_checks(fit, cfg, device)
else:
    rows = cs.kernel_checks(fit, cfg, device) if names != [""] else {}
# a row under its older name: K2's three per-axis launches (upsample_axis)
# are the same work on the same input as its one launch (upsample2)
for new, old in (("upsample2", "upsample_axis"),):
    if new not in rows and old in rows:
        rows[new] = rows[old]
print("ROWS " + json.dumps({n: [rows[n]["ms"], rows[n]["plain_ms"],
                                rows[n].get("kernel_ms"),
                                rows[n].get("sub_kernel_ms")]
                            for n in names if n in rows}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs=2)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--kernels",
                    default="peak_mask_compact,localize,orient,"
                            "descriptor_hist")
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
            f"{n} {k:.4f} ms (plain {p:.4f}"
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
