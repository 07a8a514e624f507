"""K20: head of the heteromer cartesian-product ranking by summed overlap.

Replaces mad_tpu/engine/assemble.py:498-548 (``_compiled_hetero_head``).
The CUDA source is ``csrc/enumerate.cu`` (``mad_hetero_head``), the
thresholded select of K19 (:mod:`.enumerate`) with another scorer: each
rank decodes in mixed radix, (r / stride_g) % size_g, each division a
multiply and a shift (:func:`radix_table`, put on the card once per sizes
by :func:`device_radix`), so the group count has no compile-time bound;
maps through the group lists (staged in shared memory up to 32 KB); adds
sym over the pairs i0 < i1 in ``itertools.combinations`` order, one f32
add at a time; and keeps a key only below the smaller of its block's
``head``-th kept key and the global threshold word. It reads K18's overlap
``ov`` as K19 does: ``sym = ov + ov^T`` is formed as it is staged in
shared memory when it fits in 64 KB (up to 128 solutions), and at each
read from device memory otherwise. :func:`hetero_head_plain` is the plain
PyTorch version: ``sym_trim_plain``, then the chunked torch form of the
JAX body, with the same sequential sum.
"""

from __future__ import annotations

import functools
from itertools import combinations

import numpy as np
import torch

from . import build
from .enumerate import (MAX_RANKS, card_sms, check_overlap, head_buffers,
                        keys_of, merge_head, plan, sym_trim_plain)

launches = 0            # kernel launches since the last reset


def _radix(sizes):
    sizes = [int(s) for s in sizes]
    strides, acc = [], 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    if acc > MAX_RANKS:
        raise ValueError(f"hetero_head: {acc} tuples do not fit int32")
    return sizes, strides[::-1], acc


def _magic(d: int):
    """(m, s) with x // d == (x * m) >> s for every 0 <= x < 2^31: s = 31 +
    ceil(log2 d), m = ceil(2^s / d) < 2^32 (Granlund and Montgomery)."""
    s = 31 + (d - 1).bit_length()
    return -(-(1 << s) // d), s


def radix_table(sizes, strides) -> np.ndarray:
    """(G, 3) int32 rows of the kernel's Radix: size, and the magic
    multiplier (uint32 bits) and shift of r // stride."""
    rows = [[size, *_magic(stride)] for size, stride in zip(sizes, strides)]
    return np.asarray(rows, np.int64).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=16)
def device_radix(sizes: tuple, device: torch.device) -> torch.Tensor:
    """radix_table(sizes) on the card, made once per sizes and device by
    an asynchronous copy from pinned memory (no synchronisation)."""
    sizes, strides, _total = _radix(sizes)
    host = torch.from_numpy(radix_table(sizes, strides)).pin_memory()
    return host.to(device, non_blocking=True)


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
    """The min(head, prod(sizes)) smallest keys (summed pair overlap, rank)
    over the prod(sizes) tuples, ascending, 1 <= head <= MAX_HEAD. ov
    (nsol, nsol) float32 overlap (sym = ov + ov^T), lists (G, max_n) int32
    global solution indices per group (row g holds sizes[g] valid
    entries), on one device."""
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
    if total == 0:
        return torch.empty(0, dtype=torch.int64, device=ov.device)
    radix = device_radix(tuple(sizes), ov.device)
    blocks = plan(total, head, card_sms(ov.device))
    buf = head_buffers(blocks, head, ov.device)
    lib = build.library()
    build.launch(
        lib.mad_hetero_head, ov.device, ov.data_ptr(), nsol, nsol,
        lists.data_ptr(), max_n, radix.data_ptr(), G, total, head,
        blocks, buf.data_ptr() + 8 * head, buf.data_ptr())
    launches += 1
    return buf[:min(head, total)]
