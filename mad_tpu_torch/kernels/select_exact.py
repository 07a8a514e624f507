"""K21: the exact re-score's selection: the top ``n_use`` pairs by
approximate repeatability, in order, and the gathers of their K13 inputs.

Replaces mad_tpu/engine/match.py:224-248 (``_compiled_select_exact``;
its padding rows and identity fill are bucket padding, left behind):
``top = argsort(-rep, stable)[:n_use]`` and ``rot[top]``, ``hi[top]``,
``lo[top]``. Each row's key (:func:`order_keys`) orders the repeatability
with every NaN below -inf and -0.0 equal to +0.0, then the row index
ascending, and the keys are unique; so the top keys are numpy's and
``jnp.argsort``'s stable descending order bit for bit.

The CUDA kernels are in ``csrc/select_exact.cu``. Up to ``kOneHead``
(2,048) rows taken from up to ``kCluster * kChunk`` (65,536) rows
(:func:`one_launch`; the bench takes 1,024 of 46,848) it is one launch on
one cluster of 8 CTAs: each CTA selects the n_use largest of its chunk
into the first CTA, which selects theirs and sorts them, and every CTA
gathers an eighth of the rows. Above, a radix select on the cluster, a
tile sort and a rank-and-gather launch (the select left out at n_use =
P). ``launches`` counts the launches made. :func:`select_exact_plain` is
the plain PyTorch version (``torch.sort`` of the keys).
"""

from __future__ import annotations

import functools

import torch

from . import build

launches = 0            # kernel launches since the last reset


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


@functools.lru_cache(maxsize=1)
def _limits():
    c = build.constants("select_exact.cu")
    return c["kOneHead"], c["kCluster"] * c["kChunk"]


def one_launch(P: int, n_use: int) -> bool:
    """Whether the kernel takes ``n_use`` of ``P`` rows in one launch (the
    first CTA of the cluster holds the CTAs' heads and sorts them)."""
    heads, rows = _limits()
    return n_use <= heads and P <= rows


def select_exact(rep: torch.Tensor, rot: torch.Tensor, hi: torch.Tensor,
                 lo: torch.Tensor, n_use: int):
    """(top, rot[top], hi[top], lo[top]): the rows of the ``n_use``
    largest float32 repeatabilities ``rep`` (P,), ties by row, as int64
    (n_use,) and the rows' (n_use, 3, 3) rotations and (n_use, 3) subunit
    and map coordinates, contiguous views of one buffer."""
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
    one = one_launch(P, n_use)
    # top, then the 15 floats a row, then (three launches) the scratch
    floats = (15 * n_use + 1) // 2
    buf = torch.empty(n_use + floats + (0 if one else n_use + 1),
                      dtype=torch.int64, device=rep.device)
    top = buf[:n_use]
    f = buf[n_use:n_use + floats].view(torch.float32)
    outs = (f[:9 * n_use].view(n_use, 3, 3),
            f[9 * n_use:12 * n_use].view(n_use, 3),
            f[12 * n_use:15 * n_use].view(n_use, 3))
    if n_use == 0:
        return (top,) + outs
    scratch = None if one else buf[n_use + floats:].data_ptr()
    build.launch(build.library().mad_select_exact, rep.device,
                 rep.data_ptr(), P, n_use, rot.data_ptr(), hi.data_ptr(),
                 lo.data_ptr(), scratch, top.data_ptr(),
                 *[t.data_ptr() for t in outs])
    launches += 1 if one else 2 if n_use == P else 3
    return (top,) + outs
