#!/usr/bin/env python3
"""The card's idle time of a traced benchmark run, split by the program's
spans, and the tracer's own cost.

    python3 scripts/torch_trace_split.py --workload bench10.fit \
        --seed 2147483659 [--seconds 51] [--out split.json]
    python3 scripts/torch_trace_split.py --cost

The first form runs one cell of BENCHMARK.json traced, as
``benchmark/run.py --trace 1`` does, and prints, a job: the window's
seconds, the device's idle seconds, the idle seconds inside each layer's
spans (the ``*_idle_s`` metrics), outside every span, and inside spans of
no layer; the idle seconds inside each span name (nested names overlap);
the counters (``launches``, ``pulls``, ``pull_bytes``) and the spans
logged. With a checkout whose
program has no tracer it prints the window and the idle share alone.

``--cost`` times the tracer on the card's host: microseconds a span and a
counter with no profiler running and under ``torch.profiler`` (CPU and
CUDA activities), and the same loop of bare ``record_function`` ranges.
Needs a card; prints its name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except Exception:
        return "no nvidia-smi"


def cost(n: int = 20000) -> dict:
    import torch
    from mad_tpu_torch.utils import profiling

    def per_call(fn):
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t) / n)
        return best * 1e6

    def spans():
        for _ in range(n):
            with profiling.span("match.pose_data"):
                pass

    def counts():
        for _ in range(n):
            profiling.count("launches")

    def ranges():
        for _ in range(n):
            with torch.profiler.record_function("mad.bare"):
                pass

    out = {"span_off_us": per_call(spans), "count_off_us": per_call(counts)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["span_on_us"] = per_call(spans)
        out["count_on_us"] = per_call(counts)
        out["record_function_on_us"] = per_call(ranges)
    profiling.clear_spans()
    return out


def split(workload: str, seed: int, seconds: float) -> dict:
    from harness import program_spans, registry, runner
    from harness.trace import intersect, total

    traces = []
    real = runner.from_profiler

    def keep(prof, *a, **k):
        traces.append(real(prof, *a, **k))
        return traces[-1]

    runner.from_profiler = keep
    spec = registry.benchmark()
    t0 = time.perf_counter()
    out = runner.run_cell(spec, workload, seed, seconds, True, "cuda:0",
                          lambda: time.perf_counter() - t0,
                          lambda m: sys.stderr.write(f"bench> {m}\n"))
    tr = traces[0]
    jobs = out["jobs"]
    w = tr.window[1] - tr.window[0]
    idle = program_spans.idle_intervals(tr)
    res = {"workload": workload, "seed": seed, "card": card(),
           "correct": out["correct"], "jobs": jobs,
           "window_s": w, "job_s": w / jobs,
           "idle_pct": 100.0 * total(idle) / w,
           "idle_s": total(idle) / jobs, "metrics": out["metrics"]}
    got = program_spans.program_log()
    if got is None:
        return res
    log, counters = got
    res["layers_idle_s"] = {
        k: total(intersect(idle, program_spans.span_intervals(
            log, v, tr.window))) / jobs
        for k, v in program_spans.LAYERS.items()}
    everywhere = program_spans.span_intervals(log, None, tr.window)
    res["outside_idle_s"] = (total(idle) - total(intersect(idle, everywhere))
                             ) / jobs
    in_layers = sum(res["layers_idle_s"].values())
    res["no_layer_idle_s"] = res["idle_s"] - in_layers - res["outside_idle_s"]
    res["sum_error_pct"] = 100.0 * (
        in_layers + res["outside_idle_s"] - res["idle_s"]) / res["idle_s"]
    names = sorted({r.name for r in log})
    res["idle_by_span_s"] = {
        n: total(intersect(idle, program_spans.span_intervals(
            log, (n,), tr.window))) / jobs for n in names}
    res["wall_by_span_s"] = {
        n: total(program_spans.span_intervals(log, (n,), tr.window)) / jobs
        for n in names}
    res["counters_per_job"] = {k: v / jobs for k, v in counters.items()}
    res["spans_per_job"] = len(log) / jobs
    dock = [r for r in log if r.name == "dock_structure"]
    res["dock_counts_mean"] = {
        k: sum(r.counts.get(k, 0) for r in dock) / max(len(dock), 1)
        for k in ("pairs", "candidates", "solutions", "rescue_rounds")}
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=2 ** 31 + 11)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--cost", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    print(card(), flush=True)
    res = cost() if args.cost else split(args.workload, args.seed,
                                         args.seconds)
    text = json.dumps(res, indent=1, sort_keys=True)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
