"""Per-stage timing, device profiling and the program's spans and
counters (port of mad_tpu/utils/profiling.py, with the tracer added).

A process-wide stage-timer registry (the reference's ad-hoc wall-clock
accumulators, mad/Orientator.py:57-61, 275-288) and ``torch.profiler``
for device traces. ``timing.stage`` (the per-call dict the fit's callers
pass) times its block through :func:`stage`, so the two never disagree.

``MAD_TPU_HBM=1`` also keeps each stage's peak of
``torch.cuda.max_memory_allocated`` (the peak counter is reset as a stage
begins, so a caller measuring its own peak across stages reads it before).

The tracer is on exactly while a ``torch.profiler`` records, and has no
switch of its own. :func:`span` then enters a profiler range named
``"mad." + name``, so the span is in the profiler's trace
(``device_trace``'s file included), and logs a :class:`SpanRecord`
stamped with ``time.time_ns()``, the clock of the profiler's host events;
:func:`spanned` makes each call of a function a span, :func:`tag` sets
counts on the innermost open span, :func:`count` adds to a counter and
:func:`pull` counts the device-to-host copies. Off, each costs one read of
``torch.autograd.profiler._is_profiler_enabled``. Nothing here
synchronizes the card but :func:`stage` with ``sync=True``. Spans nest on
the calling thread: the program opens none on another.

The range is an op-scope one (``_RecordFunctionFast``), not
``torch.profiler.record_function``'s user scope, which costs about three
times as much and which the profiler also copies onto the card's
timeline (a ``gpu_user_annotation`` from the range's first kernel to its
last): a reader that takes the card's events for its work would count the
copy as busy time.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:         # a PyTorch before 2.2
    _Range = torch.profiler.record_function

_STAGES: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)
_HBM_PEAK: Dict[str, int] = defaultdict(int)


@dataclass
class SpanRecord:
    """One span of the log: its name (without the trace's "mad." prefix),
    start and end (``time.time_ns()``, taken inside the profiler's range),
    the index in :func:`spans` of the span it nests in (-1 for an
    outermost one), its request (new for each outermost span, inherited
    by its children) and its counts."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: int
    counts: Dict[str, float] = field(default_factory=dict)


_LOG: List[SpanRecord] = []
_OPEN: List[int] = []           # indices in _LOG of the open spans
_COUNTERS: Dict[str, float] = defaultdict(float)
_REQUESTS = itertools.count()


def tracing() -> bool:
    """Whether a ``torch.profiler`` is recording, so the tracer is on."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The span of a tracer that is off: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, typ, value, tb):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "record", "_range", "_index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _Range("mad." + self.name)
        self._range.__enter__()
        parent = _OPEN[-1] if _OPEN else -1
        request = _LOG[parent].request if parent >= 0 else next(_REQUESTS)
        self.record = SpanRecord(self.name, time.time_ns(), 0, parent,
                                 request)
        self._index = len(_LOG)
        _LOG.append(self.record)
        _OPEN.append(self._index)
        return self

    def __exit__(self, *exc):
        self.record.end_ns = time.time_ns()
        if _OPEN and _OPEN[-1] == self._index:
            _OPEN.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager: the span ``name`` while the tracer is on (its
    counts through :func:`tag`); nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def tag(**counts) -> None:
    """Set ``counts`` on the innermost open span (none while off)."""
    if _autograd_profiler._is_profiler_enabled and _OPEN:
        _LOG[_OPEN[-1]].counts.update(counts)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTERS[name] += n


def pull(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host. From a card that is a copy the host waits for
    (a synchronization, so a bubble on the card): counted as ``pulls``
    and ``pull_bytes`` while the tracer is on."""
    if _autograd_profiler._is_profiler_enabled and t.device.type != "cpu":
        _COUNTERS["pulls"] += 1
        _COUNTERS["pull_bytes"] += t.numel() * t.element_size()
    return t.cpu()


def spans() -> List[SpanRecord]:
    """The span log, in the order the spans opened."""
    return list(_LOG)


def counters() -> Dict[str, float]:
    return dict(_COUNTERS)


def clear_spans() -> None:
    """Empty the span log and the counters."""
    _LOG.clear()
    _OPEN.clear()
    _COUNTERS.clear()


def _hbm_enabled() -> bool:
    return os.environ.get("MAD_TPU_HBM", "") not in ("", "0")


def _on_card(device) -> bool:
    """Whether ``device`` (None: the current one) is a card in use; None
    never initializes CUDA on a machine that has not used it."""
    if device is None:
        return torch.cuda.is_available() and torch.cuda.is_initialized()
    return torch.device(device).type == "cuda"


def device_bytes_in_use() -> int:
    """Bytes the caching allocator holds for tensors on the current card
    (0 when no card is in use)."""
    return int(torch.cuda.memory_allocated()) if _on_card(None) else 0


@contextlib.contextmanager
def stage(name: str, sync: bool = False, device=None):
    """Accumulate wall-clock for a named pipeline stage. With sync=True,
    the card (``device``, or the current one) is synchronized before and
    after, so the time is the block's own device work. Yields a dict whose
    "seconds" holds the block's time once it ends. The block is also the
    span ``name``."""
    card = _on_card(device)
    hbm = card and _hbm_enabled()
    with span(name):
        if sync and card:
            torch.cuda.synchronize(device)
        if hbm:
            torch.cuda.reset_peak_memory_stats(device)
        secs = {"seconds": 0.0}
        t0 = time.perf_counter()
        try:
            yield secs
        finally:
            if sync and card:
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if hbm:
                _HBM_PEAK[name] = max(
                    _HBM_PEAK[name],
                    int(torch.cuda.max_memory_allocated(device)))
            _STAGES[name] += dt
            _COUNTS[name] += 1
            secs["seconds"] = dt


def show_timing(reset: bool = False) -> Dict[str, float]:
    """Print the per-stage table (parity: Orientator.show_timing)."""
    total = sum(_STAGES.values())
    print("MaD> Step timing:")
    for name in sorted(_STAGES, key=_STAGES.get, reverse=True):
        hbm = (" | HBM %6.2f GB" % (_HBM_PEAK[name] / (1 << 30))
               if _HBM_PEAK.get(name) else "")
        print("     %-24s %8.2f s  (%d calls)%s"
              % (name, _STAGES[name], _COUNTS[name], hbm))
    print("     %-24s %8.2f s" % ("Total:", total))
    out = dict(_STAGES)
    if reset:
        _STAGES.clear()
        _COUNTS.clear()
        _HBM_PEAK.clear()
    return out


def hbm_peaks() -> Dict[str, int]:
    """Per-stage device-allocation high-water marks (MAD_TPU_HBM=1)."""
    return dict(_HBM_PEAK)


def get_timings() -> Dict[str, float]:
    return dict(_STAGES)


@contextlib.contextmanager
def device_trace(logdir: str = None):
    """``torch.profiler`` trace of a block (host, and the card when one is
    available), written as a Chrome trace to ``logdir``/trace.json; yields
    ``logdir``."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "mad_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
