"""The port's own ``match`` stage (engine/match), seconds a job, through
``dock_structure(timings=...)``."""

from harness.readers import stage_mean


def read(run):
    return stage_mean(run, ["match"])
