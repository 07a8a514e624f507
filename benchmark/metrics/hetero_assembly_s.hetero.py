"""Seconds a job inside the program's heteromer assembly spans,
``assembly.subcomplexes`` (each kind's subcomplexes) and
``assembly.enumerate_hetero`` (the ranking of the kinds' cartesian
product): the union of their intervals in the traced window over the
window's jobs; nothing where the program logs neither."""

from harness.program_spans import program_log, span_intervals
from harness.trace import total

HETERO = ("assembly.subcomplexes", "assembly.enumerate_hetero")


def read(run):
    got = program_log()
    if got is None or run.trace is None or not run.jobs:
        return None
    if not any(r.name in HETERO for r in got[0]):
        return None
    return total(span_intervals(got[0], HETERO, run.trace.window)) / len(
        run.jobs)
