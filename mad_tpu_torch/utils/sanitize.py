"""Stage-level numerical sanitizer (port of mad_tpu/utils/sanitize.py).

``MAD_TPU_NANCHECK=1`` enables STAGE mode: pipeline stages register their
key outputs with ``watch()``, which queues ``torch.isfinite(a).all()`` as
a device tensor (no host sync); ``flush()`` pulls every queued flag in one
copy and raises a FloatingPointError naming, in queue order, the stages
that produced a non-finite value.

``MAD_TPU_NANCHECK=global`` (or ``set_nan_checks(True)``) is GLOBAL mode:
mad_tpu re-runs the JAX primitive there; the port's primitives are its
hand kernels, so ``kernels/build.launch`` synchronizes after each launch,
checks the floating tensors the launch was given and raises naming the
kernel (:func:`check_launch`).

With the variable unset every call here returns at once: no sync and no
reduction on the main path.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

_global = False          # set_nan_checks
_pending: List[Tuple[str, torch.Tensor]] = []


def mode() -> str:
    """"off" | "stage" | "global" (from MAD_TPU_NANCHECK, or global after
    ``set_nan_checks(True)``)."""
    v = os.environ.get("MAD_TPU_NANCHECK", "")
    if _global or v.lower() in ("global", "2"):
        return "global"
    if v in ("", "0"):
        return "off"
    return "stage"


def set_nan_checks(enabled: bool = True) -> None:
    """Global mode on or off, whatever MAD_TPU_NANCHECK says (mad_tpu's
    ``core.config.set_nan_checks``)."""
    global _global
    _global = bool(enabled)


def _tensors(a):
    """The tensors of a watched value: a tensor, a list or tuple of them
    (a mesh's slabs), or halo ``Blocks``."""
    if isinstance(a, torch.Tensor):
        yield a
    elif isinstance(a, (list, tuple)):
        for x in a:
            yield from _tensors(x)
    elif hasattr(a, "blocks"):
        yield from _tensors(a.blocks)


def watch(stage_name: str, *arrays) -> None:
    """Queue an isfinite check of the floating tensors (stage mode only);
    nothing syncs until the next flush()."""
    if mode() != "stage":
        return
    for a in arrays:
        for t in _tensors(a):
            if t.is_floating_point():
                _pending.append((stage_name, torch.isfinite(t).all()))


def watch_flag(stage_name: str, flag) -> None:
    """Queue a precomputed all-finite flag (stage mode only)."""
    if mode() != "stage":
        return
    _pending.append((stage_name, torch.as_tensor(flag)))


def flush() -> None:
    """Pull the queued flags in one copy (one a device) and raise naming
    the stages that produced non-finite values. No-op when nothing is
    queued."""
    if not _pending:
        return
    items, _pending[:] = list(_pending), []
    by_dev = {}
    for i, (_, f) in enumerate(items):
        by_dev.setdefault(f.device, []).append(i)
    ok = [True] * len(items)
    for idx in by_dev.values():
        host = torch.stack([items[i][1].reshape(()) for i in idx]).cpu()
        for i, v in zip(idx, host.tolist()):
            ok[i] = bool(v)
    bad = [name for (name, _), good in zip(items, ok) if not good]
    if bad:
        raise FloatingPointError(
            "MaD> non-finite values produced in stage(s): "
            + ", ".join(dict.fromkeys(bad))
            + " (rerun with MAD_TPU_NANCHECK=global to locate the "
            "kernel)")


def check_host(stage_name: str, *arrays) -> None:
    """Host-side variant for stages whose outputs are already pulled."""
    if mode() != "stage":
        return
    for a in arrays:
        if a is None:
            continue
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
        if not np.issubdtype(a.dtype, np.floating):
            continue
        if not np.all(np.isfinite(a)):
            raise FloatingPointError(
                f"MaD> non-finite values produced in stage {stage_name} "
                "(rerun with MAD_TPU_NANCHECK=global to locate the "
                "kernel)")


def check_launch(name: str, device, tensors) -> None:
    """Global mode, after a kernel launch: synchronize ``device`` and
    raise naming the kernel when one of the floating ``tensors`` the
    launch was given holds a non-finite value."""
    torch.cuda.synchronize(device)
    for t in tensors:
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"MaD> non-finite values after kernel {name} "
                f"({tuple(t.shape)} {t.dtype})")


def clear() -> None:
    _pending.clear()
