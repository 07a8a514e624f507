"""K18: pairwise occupancy overlap fractions in a common lattice frame.

Replaces mad_tpu/engine/assemble.py:123-166 (``_compiled_pack_overlap``).
The CUDA source ``csrc/overlap.cu`` takes the frame by tiles in one
launch: each block packs the occupancy (density > 0) of the boxes that
meet its tile into 32-voxel words along z in shared memory, counts
popcount(a & b) for every pair i <= j there and adds the counts into an
(m, m) int32 matrix; the last block divides by the row's own count.
:func:`pack_overlap_plain` is the plain PyTorch version: boolean frames,
``(a & b).sum()`` per pair, the same division. Both are exact integer
counts, so the two agree bit for bit.

The wrapper never reads the offsets back from the card: the caller checks
that every box fits the frame on the host (:func:`check_frame`, which
``engine/assemble.overlap_inputs`` runs on its numpy offsets).
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0            # kernel launches since the last reset


def check_frame(offsets, box, frame) -> None:
    """Raise unless every box of extent ``box`` at its (m, 3) lattice
    offset (numpy, on the host) lies inside ``frame``."""
    off = np.asarray(offsets).reshape(-1, 3)
    if ((off < 0) | (off + np.asarray(box) > np.asarray(frame))).any():
        raise ValueError("pack_overlap: a box does not fit the frame")


def _check_shapes(dens, offsets, frame):
    m = dens.shape[0]
    if dens.dim() != 4 or offsets.shape != (m, 3) or len(frame) != 3:
        raise ValueError(f"pack_overlap: bad shapes {tuple(dens.shape)}, "
                         f"{tuple(offsets.shape)}, {frame}")
    if frame[2] % 32:
        raise ValueError("pack_overlap: the frame's z extent must be a "
                         "multiple of 32")


def _fractions(counts: torch.Tensor) -> torch.Tensor:
    diag = torch.diagonal(counts)
    ov = counts.to(torch.float32) / torch.clamp(diag, min=1)[:, None].to(
        torch.float32)
    ov = torch.where(diag[:, None] == 0, torch.zeros_like(ov), ov)
    return torch.triu(ov, diagonal=1)


def pack_overlap_plain(dens: torch.Tensor, offsets: torch.Tensor,
                       frame) -> torch.Tensor:
    _check_shapes(dens, offsets, frame)
    off = offsets.cpu().numpy()
    check_frame(off, dens.shape[1:], frame)
    m, X, Y, Z = dens.shape
    occ = torch.zeros((m,) + tuple(frame), dtype=torch.bool,
                      device=dens.device)
    for s, (ox, oy, oz) in enumerate(off.tolist()):
        occ[s, ox:ox + X, oy:oy + Y, oz:oz + Z] = dens[s] > 0
    flat = occ.reshape(m, -1)
    counts = torch.stack([(flat[i:i + 1] & flat).sum(dim=1)
                          for i in range(m)])
    return _fractions(counts)


def launch_overlap(dens: torch.Tensor, offsets: torch.Tensor, frame,
                   counts: torch.Tensor, ov: torch.Tensor) -> None:
    """One launch of K18 on contiguous CUDA inputs (float32 ``dens``, int32
    ``offsets``): ``ov`` (m, m) float32 out, ``counts`` (m * m + 1,) int32
    scratch."""
    global launches
    m, X, Y, Z = dens.shape
    FX, FY, FZ = (int(f) for f in frame)
    build.launch(
        build.library().mad_pack_overlap, dens.device, dens.data_ptr(),
        offsets.data_ptr(), m, X, Y, Z, FX, FY, FZ // 32, counts.data_ptr(),
        ov.data_ptr())
    launches += 1


def pack_overlap(dens: torch.Tensor, offsets: torch.Tensor,
                 frame) -> torch.Tensor:
    """(m, m) float32 upper-triangular overlap fractions.

    dens (m, X, Y, Z) float32 occupancy grids (occupied where > 0),
    offsets (m, 3) int32 lattice offsets of the boxes in a common frame of
    ``frame`` = (FX, FY, FZ) voxels, FZ a multiple of 32; on the card every
    box must fit the frame (:func:`check_frame`, the caller's). ov[i, j],
    i < j, is the share of solution i's occupied voxels that j also
    occupies."""
    if dens.device.type == "cpu":
        return pack_overlap_plain(dens, offsets, frame)
    dens = dens.to(torch.float32).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    build.require_cuda("pack_overlap", dens, offsets)
    _check_shapes(dens, offsets, frame)
    m = dens.shape[0]
    ov = torch.empty((m, m), dtype=torch.float32, device=dens.device)
    if m == 0:
        return ov
    counts = torch.empty(m * m + 1, dtype=torch.int32, device=dens.device)
    launch_overlap(dens, offsets, frame, counts, ov)
    return ov
