"""K20: head of the heteromer cartesian-product ranking by summed overlap.

Replaces mad_tpu/engine/assemble.py:498-548 (``_compiled_hetero_head``).
The CUDA source is ``csrc/enumerate.cu`` (``mad_hetero_head``): one rank
per thread decodes in mixed radix, (r / stride_g) % size_g, on demand, so
the group count has no compile-time bound; maps through the padded group
lists; adds sym over the pairs i0 < i1 in ``itertools.combinations`` order,
one f32 add at a time; and keeps the smallest ``head`` (sum, rank) keys
as K19 does (:mod:`.enumerate`). It reads K18's overlap ``ov`` as K19
does: ``sym = ov + ov^T`` is formed as it is staged in shared memory when
it fits in 64 KB (up to 128 solutions), and at each read from device
memory otherwise. :func:`hetero_head_plain` is the plain PyTorch version:
``sym_trim_plain``, then the chunked torch form of the JAX body, with the
same sequential sum.
"""

from __future__ import annotations

from itertools import combinations

import torch

from . import build
from .enumerate import (MAX_RANKS, check_overlap, head_buffers, keys_of,
                        merge_head, plan, sym_trim_plain)

launches = 0            # kernel launches since the last reset

SYM_SMEM = 64 * 1024    # sym goes to shared memory up to this many bytes


def _radix(sizes):
    sizes = [int(s) for s in sizes]
    strides, acc = [], 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    if acc > MAX_RANKS:
        raise ValueError(f"hetero_head: {acc} tuples do not fit int32")
    return sizes, strides[::-1], acc


def hetero_head_plain(ov: torch.Tensor, lists: torch.Tensor, sizes,
                      head: int, chunk: int = 1 << 16) -> torch.Tensor:
    sym = sym_trim_plain(ov, len(ov))
    sizes, strides, total = _radix(sizes)
    lists = lists.to(torch.int64)
    pairs = list(combinations(range(len(sizes)), 2))
    best = torch.empty(0, dtype=torch.int64, device=sym.device)
    for c0 in range(0, total, chunk):
        r = torch.arange(c0, min(c0 + chunk, total), device=sym.device)
        glob = [lists[g][(r // strides[g]) % sizes[g]]
                for g in range(len(sizes))]
        s = torch.zeros(r.shape[0], dtype=torch.float32, device=sym.device)
        for i0, i1 in pairs:
            s = s + sym[glob[i0], glob[i1]]
        best = merge_head(best, keys_of(s, r), head)
    return best


def hetero_head(ov: torch.Tensor, lists: torch.Tensor, sizes,
                head: int) -> torch.Tensor:
    """The ``head`` smallest keys (summed pair overlap, rank) over the
    prod(sizes) tuples, ascending. ov (nsol, nsol) float32 overlap (sym =
    ov + ov^T), lists (G, max_n) int32 global solution indices per group
    (row g holds sizes[g] valid entries), on one device."""
    if ov.device.type == "cpu":
        return hetero_head_plain(ov, lists, sizes, head)
    global launches
    ov = ov.to(torch.float32).contiguous()
    lists = lists.to(torch.int32).contiguous()
    build.require_cuda("hetero_head", ov, lists)
    check_overlap("hetero_head", ov, 0)
    sizes, strides, total = _radix(sizes)
    G, max_n = lists.shape
    nsol = ov.shape[0]
    if G != len(sizes) or max(sizes) > max_n:
        raise ValueError(f"hetero_head: bad shapes {tuple(ov.shape)}, "
                         f"{tuple(lists.shape)}, sizes {sizes}")
    radix = torch.tensor(sizes + strides, dtype=torch.int32,
                         device=ov.device)
    in_smem = 4 * nsol * nsol <= SYM_SMEM
    S, blocks = plan(total, head, 8 * G + (4 * nsol * nsol if in_smem else 0),
                     ov.device)
    partial, out = head_buffers(blocks, head, ov.device)
    lib = build.library()
    build.launch(
        lib.mad_hetero_head, ov.device, ov.data_ptr(), nsol, nsol,
        int(in_smem), lists.data_ptr(), max_n, radix.data_ptr(), G, total,
        head, S, blocks, partial.data_ptr(), out.data_ptr())
    launches += 1
    return out[out != -1]
