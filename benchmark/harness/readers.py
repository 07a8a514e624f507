"""Helpers of the metric readers in ``benchmark/metrics/``."""

from __future__ import annotations

from .stats import percentile

DOCK_TAIL = ("cluster", "refine", "post", "score")


def stage_mean(run, names):
    """Mean seconds a job of the stages ``names`` (the port's dock stages,
    through ``dock_structure(timings=...)``, or the benchmark's spans), in
    a traced run; None where no job has any of them."""
    if run.trace is None or not run.jobs:
        return None
    per_job = [sum(o.stages.get(n, 0.0) for n in names) for o in run.jobs]
    if not any(any(n in o.stages for n in names) for o in run.jobs):
        return None
    return sum(per_job) / len(per_job)


def per_job(run):
    """The window's wall seconds over the jobs completed in it."""
    return run.window.per_job() if run.window.n else None


def job_p95(run):
    """The 95th percentile (nearest rank) of the traced window's job
    seconds."""
    if run.trace is None:
        return None
    value, _n = percentile(run.window.job_s, 95)
    return value


def idle_pct(run):
    if run.trace is None:
        return None
    w = run.trace.window[1] - run.trace.window[0]
    if w <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / w)


def peak_gib(run):
    if run.trace is None or not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
