"""K21: the exact re-score's selection: the top ``n_use`` pairs by
approximate repeatability, in order, and the gathers of their K13 inputs.

Replaces mad_tpu/engine/match.py:224-248 (``_compiled_select_exact``;
its padding rows and identity fill are bucket padding, left behind):
``top = argsort(-rep, stable)[:n_use]`` and ``rot[top]``, ``hi[top]``,
``lo[top]``. Each row's key (:func:`order_keys`) orders the repeatability
with every NaN below -inf and -0.0 equal to +0.0, then the row index
ascending, and the keys are unique; so the top keys are numpy's and
``jnp.argsort``'s stable descending order bit for bit.

The CUDA kernels are in ``csrc/select_exact.cu``: a radix select of the
n_use-th key on one cluster of 8 CTAs, then a launch that ranks the
selected keys and gathers; ``launches`` counts both. :func:`select_exact_plain` is the plain
PyTorch version (``torch.sort`` of the keys).
"""

from __future__ import annotations

import torch

from . import build

launches = 0            # kernel launches since the last reset (2 a call)


def order_keys(rep: torch.Tensor) -> torch.Tensor:
    """int64 (P,) unique keys, descending in the stable descending order of
    ``rep``: the float's order bits (every NaN lowest, -0.0 as +0.0) above
    the complement of the row index."""
    u = rep.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(rep == 0, torch.zeros_like(u), u)
    u = torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | 1 << 31)
    u = torch.where(torch.isnan(rep), torch.zeros_like(u), u)
    idx = torch.arange(rep.shape[0], device=rep.device)
    return (u - (1 << 31)) * (1 << 32) + (0xFFFFFFFF - idx)


def select_exact_plain(rep, rot, hi, lo, n_use: int):
    top = torch.sort(order_keys(rep), descending=True).indices[:n_use]
    return top, rot[top], hi[top], lo[top]


def select_exact(rep: torch.Tensor, rot: torch.Tensor, hi: torch.Tensor,
                 lo: torch.Tensor, n_use: int):
    """(top, rot[top], hi[top], lo[top]): the rows of the ``n_use``
    largest float32 repeatabilities ``rep`` (P,), ties by row, as int64
    (n_use,) and the rows' (n_use, 3, 3) rotations and (n_use, 3) subunit
    and map coordinates, contiguous."""
    if rep.device.type == "cpu":
        return select_exact_plain(rep, rot, hi, lo, n_use)
    global launches
    P, n_use = rep.shape[0], int(n_use)
    if (rep.dim() != 1 or rot.shape != (P, 3, 3) or hi.shape != (P, 3)
            or lo.shape != (P, 3) or not 0 <= n_use <= P
            or any(t.dtype != torch.float32 for t in (rep, rot, hi, lo))):
        raise ValueError("select_exact: float32 rep (P,), rot (P, 3, 3), "
                         "hi and lo (P, 3), 0 <= n_use <= P")
    rot, hi, lo = rot.contiguous(), hi.contiguous(), lo.contiguous()
    build.require_cuda("select_exact", rep, rot, hi, lo)
    dev = rep.device
    top = torch.empty(n_use, dtype=torch.int64, device=dev)
    outs = (torch.empty((n_use, 3, 3), dtype=torch.float32, device=dev),
            torch.empty((n_use, 3), dtype=torch.float32, device=dev),
            torch.empty((n_use, 3), dtype=torch.float32, device=dev))
    if n_use == 0:
        return (top,) + outs
    sel = torch.empty(n_use + 1, dtype=torch.int64, device=dev)  # + slot
    build.launch(build.library().mad_select_exact, dev, rep.data_ptr(), P,
                 n_use, rot.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                 sel.data_ptr(), top.data_ptr(),
                 *[t.data_ptr() for t in outs])
    launches += 2
    return (top,) + outs
