"""The window's arithmetic and the percentiles of the traced run."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class Window:
    """A closed loop's window: it starts when the first job starts and
    ends at the end of the first job that finishes ``seconds`` or more
    after that; every job in it counts."""

    t0: float = 0.0
    t_end: float = 0.0
    job_s: List[float] = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.job_s)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0

    def per_job(self) -> float:
        """Wall seconds of the window over the jobs completed in it."""
        return self.seconds / max(self.n, 1)


def closed_loop(job: Callable[[int], None], seconds: float,
                clock: Callable[[], float] = time.perf_counter,
                sync: Callable[[], None] = lambda: None) -> Window:
    """Run ``job(i)`` back to back, one caller, ``sync()`` after each (a
    device synchronize), until a job ends ``seconds`` after the first
    began."""
    w = Window()
    sync()
    w.t0 = t = clock()
    i = 0
    while True:
        job(i)
        sync()
        now = clock()
        w.job_s.append(now - t)
        t = now
        i += 1
        if now - w.t0 >= seconds:
            break
    w.t_end = t
    return w


def percentile(values: List[float], q: float):
    """(nearest-rank q-th percentile, sample count); None without
    samples."""
    if not values:
        return None, 0
    v = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return v[k - 1], len(v)
