"""Device-idle time (no operation on the card) inside the program's
``match`` spans (``match_descriptors``; a rescue round's exact re-score)
and ``match.order`` spans (the ordering of the table, a rescue round's
included), seconds a job."""

from harness.program_spans import MATCH, idle_in


def read(run):
    return idle_in(run, MATCH)
