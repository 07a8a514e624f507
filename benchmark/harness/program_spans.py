"""The program's own spans and counters in a traced run.

``mad_tpu_torch.utils.profiling`` logs a span (``mad.<name>`` in the
profiler's trace) and its counters while a ``torch.profiler`` records, so
in a traced run the log holds the window's work and nothing else. Its
times are ``time.time_ns()``, the clock of the profiler's host events, so
the spans sit on :class:`harness.trace.Trace`'s seconds as they are.

A reader of this module returns None where the program keeps no log (a
version without the tracer, or an untraced run). The counters are the
process's totals, not clipped to the window: they hold one traced window's
work because a process makes one traced run (``run.py`` runs one cell),
and a caller that makes more empties the log between them
(``profiling.clear_spans()``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from .trace import Interval, gaps, intersect, total, union

# the program's spans that make up each layer (a name that ends in "."
# names every span under it)
MATCH = ("match", "match.order")
DOCK_TAIL = ("cluster", "refine.starts", "refine", "post", "score")
DESCRIBE = ("describe_grid", "describe_structure")
ASSEMBLY = ("assembly.",)
LAYERS = {"describe": DESCRIBE, "match": MATCH, "dock_tail": DOCK_TAIL,
          "assembly": ASSEMBLY}


def program_log():
    """(spans, counters) of the program's tracer, or None where it has
    none or logged nothing."""
    try:
        from mad_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    counters = getattr(profiling, "counters", None)
    if spans is None or counters is None:
        return None
    log = spans()
    if not log:
        return None
    return log, counters()


def named(name: str, names: Optional[Iterable[str]]) -> bool:
    """Whether ``names`` (None: every name) holds the span ``name``."""
    return names is None or any(
        name.startswith(n) if n.endswith(".") else name == n for n in names)


def span_intervals(log, names, window: Interval) -> List[Interval]:
    """The union of the spans called ``names`` (None: every span), in
    seconds, clipped to ``window``."""
    return intersect(union([(r.start_ns * 1e-9, r.end_ns * 1e-9)
                            for r in log if named(r.name, names)]),
                     [window])


def idle_intervals(trace) -> List[Interval]:
    return gaps(trace.busy(), trace.window)


def idle_in(run, names) -> Optional[float]:
    """Device-idle seconds a job inside the program's spans ``names``."""
    got = program_log()
    if got is None or run.trace is None or not run.jobs:
        return None
    spans = span_intervals(got[0], names, run.trace.window)
    return total(intersect(idle_intervals(run.trace), spans)) / len(run.jobs)


def idle_outside(run) -> Optional[float]:
    """Device-idle seconds a job outside every span of the program."""
    got = program_log()
    if got is None or run.trace is None or not run.jobs:
        return None
    spans = span_intervals(got[0], None, run.trace.window)
    idle = idle_intervals(run.trace)
    return (total(idle) - total(intersect(idle, spans))) / len(run.jobs)


def per_job(run, counter: str) -> Optional[float]:
    """The program's counter ``counter`` over the window's jobs."""
    got = program_log()
    if got is None or run.trace is None or not run.jobs:
        return None
    return got[1].get(counter, 0.0) / len(run.jobs)
