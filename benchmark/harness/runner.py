"""One run of one cell: set-up, warm-up, the measured window, the traced
window's reading, the check against the reference, the result line.

Every metric, end-to-end or per-layer, is read by its own reader
(``benchmark/metrics/<name>.py``) from a :class:`RunData`; a reader that
finds nothing returns None and the metric is left out of the line.
"""

from __future__ import annotations

import gc
import resource
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from . import check, registry
from .cell import Cell, JobOut
from .stats import Window, closed_loop
from .trace import SPAN_PREFIX, Trace, from_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "mad_tpu")


@dataclass
class RunData:
    """What the readers read."""

    setup_s: float
    window: Window
    jobs: List[JobOut]
    cell: Cell
    peak_bytes: int
    trace: Optional[Trace] = None


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``mad_tpu_torch`` is not ``mad_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def _sync(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except Exception:   # no tool or no reading: the key is left out
        return None


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device, since_start, log, config=None,
             traffic=None) -> dict:
    """The result object of one run (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, optionally ``breakdown``, then
    ``check``). ``since_start()`` gives the seconds since the process
    started."""
    device = torch.device(device)
    w = registry.workload(spec, cell_name)
    config = config or registry.config(w["config"])
    traffic = traffic or registry.traffic(w["traffic"])
    cell = Cell(config, traffic, seed, device, traced=traced)
    cell.setup()
    sync = _sync(device)
    # warm-up: ``warmup_jobs`` jobs of their own stream, one of each
    # group in turn (a map, a conformer)
    for j in range(int(traffic["warmup_jobs"])):
        cell.run_job(-1 - j, keep=False)
    sync()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = since_start()
    log(f"set-up {setup_s:.3f} s; checked jobs {cell.checked}")

    prof = None
    if traced:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()

    def job(i):
        cell.outs.append(cell.run_job(i))

    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    if traced:
        with torch.profiler.record_function(SPAN_PREFIX + "window"):
            window = closed_loop(job, seconds, sync=sync)
    else:
        window = closed_loop(job, seconds, sync=sync)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trace = None
    if traced:
        prof.stop()
        t = time.perf_counter()
        trace = from_profiler(prof)
        del prof
        log(f"trace read in {time.perf_counter() - t:.2f} s: "
            f"{len(trace.device)} device operations, {len(trace.spans)} "
            "spans")
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    log(f"window {window.seconds:.3f} s, {window.n} jobs; host: user "
        f"{ru1.ru_utime - ru0.ru_utime:.3f} s, system "
        f"{ru1.ru_stime - ru0.ru_stime:.3f} s, minor faults "
        f"{ru1.ru_minflt - ru0.ru_minflt}, context switches voluntary "
        f"{ru1.ru_nvcsw - ru0.ru_nvcsw}, involuntary "
        f"{ru1.ru_nivcsw - ru0.ru_nivcsw}; threads {torch.get_num_threads()}")
    if window.n >= 4:
        q = statistics.quantiles(window.job_s, n=10)
        half = window.n // 2
        log("job s: mean %.4f, p10 %.4f, p50 %.4f, p90 %.4f; first half "
            "%.4f, second half %.4f" % (
                statistics.fmean(window.job_s), q[0], q[4], q[8],
                statistics.fmean(window.job_s[:half]),
                statistics.fmean(window.job_s[half:])))

    run = RunData(setup_s=setup_s, window=window, jobs=list(cell.outs),
                  cell=cell, peak_bytes=int(peak), trace=trace)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(spec, cell_name, kind):
        v = registry.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    cell.free_program()
    nums = check.numbers(cell, log=log)
    checked = nums.pop("_checked")
    parts = nums.pop("_parts")
    for name, entries in parts.items():
        log_parts(name, entries, log)
    correct, rows = check.verdict(nums, config["limits"],
                                  check.required(cell))
    if checked != len(cell.checked):
        log(f"checked jobs run: {checked} of {len(cell.checked)}")
        correct = False
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        pl = power_limit()
        if pl is not None:
            dev["power_limit_w"] = pl
    out = {"correct": bool(correct), "attempted": window.n,
           "failed": sum(1 for o in cell.outs if o.n_solutions == 0),
           "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window[1] - trace.window[0]
        out["breakdown"] = {"device_ops": trace.top_ops(10),
                            "idle_gaps": trace.idle_by_span(10)}
    out["jobs"] = window.n
    out["checked_jobs"] = checked
    out["check"] = {name: {"value": v, "limit": lim}
                    for name, v, lim in rows}
    return out


def log_parts(name: str, entries: list, log):
    """One line of a layer's part: the keys of its entries, then each
    entry's values of those keys (lists left out)."""
    keys = [k for k, v in entries[0].items()
            if not isinstance(v, list)] if entries else []
    log(f"{name} ({', '.join(keys)}): " + ", ".join(
        "/".join(str(e[k]) for k in keys) for e in entries))


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of " + ", ".join(names) + " are loaded")
        self.names = names
