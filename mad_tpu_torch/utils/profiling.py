"""Per-stage timing + optional device profiling (port of
mad_tpu/utils/profiling.py).

A process-wide stage-timer registry (the reference's ad-hoc wall-clock
accumulators, mad/Orientator.py:57-61, 275-288) and ``torch.profiler``
for device traces. ``timing.stage`` (the per-call dict the fit's callers
pass) times its block through :func:`stage`, so the two never disagree.

``MAD_TPU_HBM=1`` also keeps each stage's peak of
``torch.cuda.max_memory_allocated`` (the peak counter is reset as a stage
begins, so a caller measuring its own peak across stages reads it before).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

import torch

_STAGES: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)
_HBM_PEAK: Dict[str, int] = defaultdict(int)


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
    "seconds" holds the block's time once it ends."""
    card = _on_card(device)
    hbm = card and _hbm_enabled()
    if sync and card:
        torch.cuda.synchronize(device)
    if hbm:
        torch.cuda.reset_peak_memory_stats(device)
    span = {"seconds": 0.0}
    t0 = time.perf_counter()
    try:
        yield span
    finally:
        if sync and card:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if hbm:
            _HBM_PEAK[name] = max(_HBM_PEAK[name],
                                  int(torch.cuda.max_memory_allocated(device)))
        _STAGES[name] += dt
        _COUNTS[name] += 1
        span["seconds"] = dt


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
