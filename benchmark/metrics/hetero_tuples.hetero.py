"""The tuples of the kinds' cartesian products that the program ranked
(its counter ``hetero_tuples``, ``enumerate_heteromer``) a job; fixed by
the seed's data, it moves only where the dock's solutions do. Nothing
where the program keeps no such counter."""

from harness.program_spans import per_job, program_log


def read(run):
    got = program_log()
    if got is None or "hetero_tuples" not in got[1]:
        return None
    return per_job(run, "hetero_tuples")
