#!/usr/bin/env python3
"""Kernel rows of chip_smoke.py for two checkouts of the port, timed in
interleaved order on one NVIDIA card.

    python3 scripts/torch_kernel_abba.py DIR_A DIR_B [--order ABBA]
        [--kernels peak_mask_compact,localize,orient,descriptor_hist]

Each DIR holds a checkout (its chip_smoke.py and mad_tpu_torch/). For
every letter of ``--order`` (A the first directory, B the second), one
process in that directory builds the checkout's kernels, runs
chip_smoke's bench fit once and its kernel_checks (each kernel at the
bench fit's inputs against its plain version, CUDA events, mean of three
after a warm call), and prints the chosen rows' kernel and plain ms. Then
each row's mean per checkout. Prints the card's name and power limit
first. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, torch
import chip_smoke as cs
names = sys.argv[1].split(",")
device, _smi = cs.device_phase()
cs.build_phase()
cfg = cs.bench_config()
fit = cs.run_fit(device, {}, cfg)
torch.cuda.synchronize()
rows = cs.kernel_checks(fit, cfg, device)
print("ROWS " + json.dumps({n: [rows[n]["ms"], rows[n]["plain_ms"]]
                            for n in names}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs=2)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--kernels",
                    default="peak_mask_compact,localize,orient,"
                            "descriptor_hist")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    got = {"A": [], "B": []}
    for i, side in enumerate(args.order):
        root = os.path.abspath(args.dirs["AB".index(side)])
        proc = subprocess.run([sys.executable, "-c", CHILD, args.kernels],
                              cwd=root, capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines() if x.startswith("ROWS ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            raise SystemExit(f"run {i} ({side}, {root}) failed")
        rows = json.loads(line[0][5:])
        got[side].append(rows)
        print(f"run {i} {side} ({root}): " + ", ".join(
            f"{n} {k:.4f} ms (plain {p:.4f})" for n, (k, p) in rows.items()),
            flush=True)
    for side in "AB":
        runs = got[side]
        if runs:
            print(f"mean {side} over {len(runs)} runs: " + ", ".join(
                f"{n} {sum(r[n][0] for r in runs) / len(runs):.4f} ms"
                for n in runs[0]))


if __name__ == "__main__":
    main()
