"""The port's ``cluster``, ``refine``, ``post`` and ``score`` stages
(engine/docking, cluster, refine, score), seconds a job."""

from harness.readers import DOCK_TAIL, stage_mean


def read(run):
    return stage_mean(run, DOCK_TAIL)
