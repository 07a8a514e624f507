"""K18: pairwise occupancy overlap fractions in a common lattice frame.

Replaces mad_tpu/engine/assemble.py:123-166 (``_compiled_pack_overlap``).
The CUDA source ``csrc/overlap.cu`` packs each solution's occupancy
(density > 0) into 32-voxel words along z at its lattice offset, counts
popcount(a & b) for every pair i <= j and divides by the row's own count;
:func:`pack_overlap_plain` is the plain PyTorch version: boolean frames,
``(a & b).sum()`` per pair, the same division. Both are exact integer
counts, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from . import build

launches = 0            # kernel launches since the last reset


def _check(dens, offsets, frame):
    m = dens.shape[0]
    if dens.dim() != 4 or offsets.shape != (m, 3) or len(frame) != 3:
        raise ValueError(f"pack_overlap: bad shapes {tuple(dens.shape)}, "
                         f"{tuple(offsets.shape)}, {frame}")
    off = offsets.cpu().tolist()
    for a in range(3):
        if any(o[a] < 0 or o[a] + dens.shape[1 + a] > frame[a] for o in off):
            raise ValueError("pack_overlap: a box does not fit the frame")
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
    _check(dens, offsets, frame)
    m, X, Y, Z = dens.shape
    occ = torch.zeros((m,) + tuple(frame), dtype=torch.bool,
                      device=dens.device)
    for s, (ox, oy, oz) in enumerate(offsets.cpu().tolist()):
        occ[s, ox:ox + X, oy:oy + Y, oz:oz + Z] = dens[s] > 0
    flat = occ.reshape(m, -1)
    counts = torch.stack([(flat[i:i + 1] & flat).sum(dim=1)
                          for i in range(m)])
    return _fractions(counts)


def pack_overlap(dens: torch.Tensor, offsets: torch.Tensor,
                 frame) -> torch.Tensor:
    """(m, m) float32 upper-triangular overlap fractions.

    dens (m, X, Y, Z) float32 occupancy grids (occupied where > 0),
    offsets (m, 3) int32 lattice offsets of the boxes in a common frame of
    ``frame`` = (FX, FY, FZ) voxels, FZ a multiple of 32. ov[i, j], i < j,
    is the share of solution i's occupied voxels that j also occupies."""
    if dens.device.type == "cpu":
        return pack_overlap_plain(dens, offsets, frame)
    global launches
    dens = dens.to(torch.float32).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    build.require_cuda("pack_overlap", dens, offsets)
    _check(dens, offsets, frame)
    m, X, Y, Z = dens.shape
    FX, FY, FZ = (int(f) for f in frame)
    W = FZ // 32
    dev = dens.device
    ov = torch.empty((m, m), dtype=torch.float32, device=dev)
    if m == 0:
        return ov
    packed = torch.empty(m * FX * FY * W, dtype=torch.int32, device=dev)
    counts = torch.zeros((m, m), dtype=torch.int32, device=dev)
    lib = build.library()
    build.launch(
        lib.mad_pack_overlap, dev, dens.data_ptr(), offsets.data_ptr(), m, X,
        Y, Z, FX, FY, W, packed.data_ptr(), counts.data_ptr(), ov.data_ptr())
    launches += 1
    return ov
