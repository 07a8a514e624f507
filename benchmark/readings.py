"""Readings of the numbers that decide ``correct``, for setting limits.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out readings.jsonl]

builds the cell once (its pool of maps is the same for every seed), then
for each seed of ``--seeds`` runs the cell's jobs up to its last checked
job (a short window at the cell's own load) and prints the numbers the
judge compares and the parts of each of the job's layers, one JSON line
a seed; for each seed of ``--control-seeds`` the same numbers of the
control (the reference in bfloat16 in the program's place), which has to
fail a limit. Needs the card, as ``run.py`` does; it is not one of the
benchmark's runs.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BENCH / "_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / "_cache" / "triton"))
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def log(msg):
    sys.stderr.write(f"readings> {msg}\n")
    sys.stderr.flush()


def readings(cell, seeds, control: bool, sink):
    from harness import check
    for seed in seeds:
        cell.reseed(seed)
        t = time.perf_counter()
        for j in range(max(cell.checked) + 1):
            cell.outs.append(cell.run_job(j))
        nums = check.numbers(cell, control=control, log=log)
        parts = nums.pop("_parts")
        checked = nums.pop("_checked")
        ok, _rows = check.verdict(nums, cell.config["limits"],
                                  check.required(cell))
        line = dict(seed=seed, control=control, jobs=len(cell.outs),
                    checked=checked, seconds=time.perf_counter() - t,
                    passes=ok, **nums, parts=parts)
        sink(json.dumps(line))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch
    from harness import registry
    from harness.cell import Cell
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 3
    spec = registry.benchmark()
    w = registry.workload(spec, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    cell = Cell(registry.config(w["config"]), registry.traffic(w["traffic"]),
                (seeds or cseeds)[0], "cuda:0")
    cell.setup()
    out = open(args.out, "a") if args.out else None

    def sink(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    readings(cell, seeds, False, sink)
    readings(cell, cseeds, True, sink)
    return 0


if __name__ == "__main__":
    sys.exit(main())
