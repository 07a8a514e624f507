"""The 95th percentile (nearest rank) of the fits' seconds in the traced
window; its sample count is the result's ``jobs``."""

from harness.readers import job_p95


def read(run):
    return job_p95(run)
