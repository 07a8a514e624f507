"""The program's device-to-host copies (``profiling.pull``: each one a
synchronization) a job, counted while the profiler records."""

from harness.program_spans import per_job


def read(run):
    return per_job(run, "pulls")
