"""The benchmark's span around ``describe_grid`` of the map (ended by a
synchronize), seconds a fit."""

from harness.readers import stage_mean


def read(run):
    return stage_mean(run, ["describe_map"])
