"""Device-idle time (no operation on the card) inside the program's
``assembly.subcomplexes`` and ``assembly.enumerate_hetero`` spans,
seconds a job; nothing where the program logs neither."""

from harness.program_spans import idle_in, program_log

HETERO = ("assembly.subcomplexes", "assembly.enumerate_hetero")


def read(run):
    got = program_log()
    if got is None or not any(r.name in HETERO for r in got[0]):
        return None
    return idle_in(run, HETERO)
