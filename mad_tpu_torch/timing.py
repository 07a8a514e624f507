"""Per-stage wall-clock seconds for the chip smoke run and callers that
want a breakdown.

``stage(timings, name, device)`` adds the seconds of its block to
``timings[name]``. On a CUDA device it synchronizes before and after, so
the time is the device work of the block, not its enqueue. With
``timings=None`` it does nothing.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def stage(timings, name: str, device):
    if timings is None:
        yield
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
