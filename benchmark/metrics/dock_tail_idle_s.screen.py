"""Device-idle time (no operation on the card) inside the program's
``cluster``, ``refine.starts`` (the refinement's start poses), ``refine``,
``post`` and ``score`` spans, seconds a job."""

from harness.program_spans import DOCK_TAIL, idle_in


def read(run):
    return idle_in(run, DOCK_TAIL)
