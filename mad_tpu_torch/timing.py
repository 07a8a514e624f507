"""Per-stage wall-clock seconds for the chip smoke run and callers that
want a breakdown.

``stage(timings, name, device)`` adds the seconds of its block to
``timings[name]``. It times through the process-wide registry of
:mod:`.utils.profiling` (``profiling.stage(name, sync=True)``), so the
dict and ``profiling.show_timing`` read the same clock: on a CUDA device
it synchronizes before and after, so the time is the device work of the
block, not its enqueue. With ``timings=None`` it neither times nor
synchronizes. Either way the block is the tracer's span ``name``
(``profiling.span``), which records only while a ``torch.profiler`` does.
"""

from __future__ import annotations

import contextlib

from .utils import profiling


@contextlib.contextmanager
def stage(timings, name: str, device):
    if timings is None:
        with profiling.span(name):
            yield
        return
    span = {"seconds": 0.0}
    try:
        with profiling.stage(name, sync=True, device=device) as span:
            yield
    finally:
        timings[name] = timings.get(name, 0.0) + span["seconds"]
