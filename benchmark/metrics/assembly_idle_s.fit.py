"""Device-idle time (no operation on the card) inside the program's
``assembly.*`` spans (overlap, its host copy, the enumeration, the
models' scores), seconds a job."""

from harness.program_spans import ASSEMBLY, idle_in


def read(run):
    return idle_in(run, ASSEMBLY)
