"""fit_s: the window's wall seconds over the fits completed in it (the
cells that report it are BENCHMARK.json's to say)."""

from harness.readers import per_job


def read(run):
    return per_job(run)
