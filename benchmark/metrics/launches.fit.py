"""The program's kernel launches (``kernels/build.launch``) a job, counted
while the profiler records."""

from harness.program_spans import per_job


def read(run):
    return per_job(run, "launches")
