"""x-sharded volumes (port of mad_tpu/parallel/volume.py:33-123).

A field of X rows is cut into x-slabs, one per shard of a
:class:`~.mesh.Mesh`: :func:`shard_bounds` gives every shard X // n rows
and the first X % n one more (no pad rows; the last shard may be short).
A list of slab tensors, shard ``s``'s on ``mesh.devices[s]``, is the
sharded field.

:func:`halo_block` extends a shard's slab by up to ``halo`` rows of its
neighbours on each side, copied into a buffer on the shard's device.
Where mad_tpu's ``halo_extend`` fills the halo beyond the global ends with
zeros, the port cuts it there: shard 0's block starts at row 0 and the last
shard's ends at the last row, so every kernel applies its own edge rule
where the single-device run does (K1 pads with zeros, K2 replicates the
edge, K3 takes one-sided differences, K5 places its patch on the face).
A halo wider than a slab takes rows from as many neighbours as it needs.
:func:`halo_extend` keeps every shard's block (:class:`Blocks`) for the
kernels that gather around points: :func:`map_owned` runs one on each
shard's block for the points whose x lies in the shard's own rows.

:func:`map_slabs` runs a filter chain per shard on its halo block and keeps
the shard's own rows; with a halo that covers the chain's reach the rows
are those of the whole volume's run, bit for bit (every kernel computes an
output row from the same input rows in the same order). The octave's LoG
and Gaussian are so computed (``ops.scalespace.ShardedOctave.log_gauss``,
mad_tpu's ``sharded_log_gspmd`` / ``sharded_log_shardmap``), and
:func:`sharded_gradient` gives the gradient field as :class:`Blocks`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import torch

from ..kernels.gradient import gradient
from .mesh import Mesh, shard_bounds


def row_bounds(slabs: Sequence[torch.Tensor]) -> List[int]:
    """Global row bounds of a sharded field's slabs (n + 1 ints)."""
    out = [0]
    for part in slabs:
        out.append(out[-1] + int(part.shape[0]))
    return out


def up_bounds(bounds: Sequence[int]) -> List[int]:
    """Row bounds of the x2 upsampled octave of a sharded base field: base
    rows [b0, b1) own up rows [2 b0, 2 b1), the last shard up to 2 X - 1."""
    return [2 * b for b in bounds[:-1]] + [2 * bounds[-1] - 1]


def split_x(vol: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Cut a volume into x-slabs, each copied to its shard's device (a
    copy even on the volume's own device, so the volume can be freed);
    every slab has a row."""
    if vol.shape[0] < len(mesh):
        raise ValueError(f"split_x: {vol.shape[0]} rows cannot make "
                         f"{len(mesh)} slabs")
    b = shard_bounds(vol.shape[0], len(mesh))
    return [torch.empty((b[s + 1] - b[s],) + tuple(vol.shape[1:]),
                        dtype=vol.dtype, device=dev).copy_(vol[b[s]:b[s + 1]])
            for s, dev in enumerate(mesh.devices)]


def halo_block(slabs: Sequence[torch.Tensor], s: int, halo: int,
               mesh: Mesh) -> Tuple[torch.Tensor, int]:
    """Shard ``s``'s slab extended by up to ``halo`` rows of the other
    slabs on each side, cut at the global ends, on the shard's device;
    returns (block, global row of the block's row 0)."""
    b = row_bounds(slabs)
    lo, hi = max(0, b[s] - halo), min(b[-1], b[s + 1] + halo)
    part = slabs[s]
    out = torch.empty((hi - lo,) + tuple(part.shape[1:]), dtype=part.dtype,
                      device=mesh.devices[s])
    for t, src in enumerate(slabs):
        a, e = max(lo, b[t]), min(hi, b[t + 1])
        if a < e:
            out[a - lo:e - lo].copy_(src[a - b[t]:e - b[t]])
    return out, lo


@dataclass
class Blocks:
    """A sharded field kept with its halo: shard ``s``'s block, on its
    device, holds the global rows ``[lo[s], lo[s] + len(blocks[s]))``: its
    own rows ``[bounds[s], bounds[s + 1])`` and up to ``halo`` rows of its
    neighbours on each side, cut at the global ends."""

    blocks: List[torch.Tensor]
    lo: List[int]
    bounds: List[int]
    halo: int


def halo_extend(slabs: Sequence[torch.Tensor], halo: int,
                mesh: Mesh) -> Blocks:
    """Every shard's :func:`halo_block` (mad_tpu's ``halo_extend``)."""
    parts = [halo_block(slabs, s, halo, mesh) for s in range(len(slabs))]
    return Blocks([p[0] for p in parts], [p[1] for p in parts],
                  row_bounds(slabs), halo)


def check_halo(field: Blocks, reach: int, name: str) -> None:
    """Raise unless the blocks' halo covers a gather's ``reach`` rows."""
    if field.halo < reach:
        raise ValueError(f"{name}: blocks with a halo of {field.halo} rows, "
                         f"the gather reaches {reach}")


def map_owned(field: Blocks, fn: Callable, *rows: torch.Tensor):
    """``fn(block, lo, *rows)`` for each shard, on the rows (of K each)
    whose point ``rows[0][:, :3]`` has its x in the shard's own rows, moved
    to the shard's device; the outputs (a tuple of tensors of as many rows)
    are put back in the rows' order on ``rows[0]``'s device. A shard that
    owns no row is skipped (with no row at all, shard 0 runs on none)."""
    home, x = rows[0].device, rows[0][:, 0].contiguous()
    owner = torch.searchsorted(
        torch.as_tensor(field.bounds[1:-1], dtype=x.dtype, device=home), x,
        right=True)
    parts = [(s, torch.nonzero(owner == s).reshape(-1))
             for s in range(len(field.blocks))]
    parts = [p for p in parts if p[1].numel()] or parts[:1]
    outs = None
    for s, idx in parts:
        blk = field.blocks[s]
        res = fn(blk, field.lo[s], *(r[idx].to(blk.device) for r in rows))
        if outs is None:
            outs = tuple(torch.empty((x.shape[0],) + tuple(r.shape[1:]),
                                     dtype=r.dtype, device=home)
                         for r in res)
        for dst, part in zip(outs, res):
            dst[idx] = part.to(home)
    return outs


def map_slabs(slabs: Sequence[torch.Tensor], mesh: Mesh, halo: int,
              fn: Callable, up: bool = False) -> List[List[torch.Tensor]]:
    """Per shard, ``fn`` (returning a tuple of volumes) on the shard's
    halo block, each output cut back to the shard's own rows; with ``up``
    fn maps n rows to 2n - 1 (the x2 octave) and the own rows are those of
    :func:`up_bounds`. One shard's block at a time; returns one sharded
    field (a list of slabs) per output of fn."""
    b = row_bounds(slabs)
    ob = up_bounds(b) if up else b
    outs = None
    for s in range(len(slabs)):
        blk, lo = halo_block(slabs, s, halo, mesh)
        res = fn(blk)
        del blk
        a = ob[s] - (2 * lo if up else lo)
        own = [r[a:a + ob[s + 1] - ob[s]].clone() for r in res]
        del res
        outs = [[] for _ in own] if outs is None else outs
        for field, part in zip(outs, own):
            field.append(part)
    return outs


def filter_radius(sigma: float, truncate: float = 4.0) -> int:
    """Rows a Gaussian filter reaches (ops.convolve.gaussian_kernel1d)."""
    return int(truncate * float(sigma) + 0.5)


def sharded_gradient(slabs: Sequence[torch.Tensor], dtype, mesh: Mesh,
                     halo: int) -> Blocks:
    """The gradient field (kernel K3) of an x-sharded volume as
    :class:`Blocks` of ``halo`` rows, equal to the whole volume's field bit
    for bit: K3 of each shard's block of ``halo + 1`` rows, less its first
    and last row where those are not the volume's (K3 takes one-sided
    differences there). One shard's input block at a time."""
    b = row_bounds(slabs)
    blocks, los = [], []
    for s in range(len(slabs)):
        blk, lo = halo_block(slabs, s, halo + 1, mesh)
        a = max(0, b[s] - halo)
        e = min(b[-1], b[s + 1] + halo)
        blocks.append(gradient(blk, dtype)[a - lo:e - lo])
        los.append(a)
        del blk
    return Blocks(blocks, los, b, halo)
