"""Device-idle time (no operation on the card) inside the program's
``describe_grid`` and ``describe_structure`` spans (the outermost, so
nested ones count once), seconds a job."""

from harness.program_spans import DESCRIBE, idle_in


def read(run):
    return idle_in(run, DESCRIBE)
