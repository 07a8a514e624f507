"""The benchmark's span around ``describe_structure`` of the conformer
(its simulation and scale space), seconds a docked conformer."""

from harness.readers import stage_mean


def read(run):
    return stage_mean(run, ["describe_subunit"])
