"""The benchmark's span around the assembly (overlap,
``enumerate_homomultimer``, ``score_models``), seconds a fit."""

from harness.readers import stage_mean


def read(run):
    return stage_mean(run, ["assembly"])
