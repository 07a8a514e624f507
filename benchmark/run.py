"""The benchmark of mad_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json (at the root of the checkout) once, from
the root of the checkout, and prints one JSON object as the last line of
its standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device`` and, traced, ``breakdown``; the numbers compared
with the reference come last, under ``check``, and again as the last
lines of standard error. Without a CUDA card (or with fewer than the
cell asks for) it prints no result and exits with 3; with JAX, flax or
mad_tpu loaded once the window has closed, with 4.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# build and kernel caches of the program, at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BENCH / "_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / "_cache" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(BENCH), str(ROOT)]


def since_start() -> float:
    """Seconds since this process started (its start time in /proc),
    else since this file's first line."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T0


def log(msg: str) -> None:
    sys.stderr.write(f"bench> {msg}\n")
    sys.stderr.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import registry
    spec = registry.benchmark()
    chips = int(registry.workload(spec, args.workload)["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA card(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 3

    import contextlib
    from harness import runner
    try:
        # the program's own prints go to standard error: the result is the
        # last line of standard output
        with contextlib.redirect_stdout(sys.stderr):
            out = runner.run_cell(spec, args.workload, args.seed,
                                  args.seconds, bool(args.trace), "cuda:0",
                                  since_start, log)
    except runner.ForbiddenImport as e:
        log(f"no result: {e}")
        return 4
    found = runner.forbidden_modules()
    if found:
        log(f"no result: modules of {', '.join(found)} are loaded")
        return 4
    log(f"correct: {out['correct']}")
    for name, c in out["check"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
