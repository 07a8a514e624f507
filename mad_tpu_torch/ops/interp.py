"""Gather-based interpolation of 3D (vector) fields (port of
mad_tpu/ops/interp.py: ``trilinear`` and ``nearest``)."""

from __future__ import annotations

import torch


def trilinear(field: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of field (X, Y, Z, C) at voxel-space points
    (..., 3). Out-of-range points are clamped; callers mask them. Matches
    scipy RegularGridInterpolator(method='linear') inside bounds."""
    x, y, z = field.shape[:3]
    flat = field.reshape(-1, field.shape[3])
    shp = torch.as_tensor((x, y, z), device=pts.device)
    p = torch.minimum(torch.clamp(pts, min=0.0), (shp - 1).to(pts.dtype))
    p0 = torch.minimum(torch.clamp(torch.floor(p).to(torch.int64), min=0),
                       shp - 2)
    f = p - p0.to(p.dtype)
    w0, w1 = 1.0 - f, f
    base = (p0[..., 0] * y + p0[..., 1]) * z + p0[..., 2]
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((w1[..., 0] if dx else w0[..., 0])
                     * (w1[..., 1] if dy else w0[..., 1])
                     * (w1[..., 2] if dz else w0[..., 2]))
                v = flat[base + (dx * y + dy) * z + dz]
                term = w[..., None] * v
                out = term if out is None else out + term
    return out


def nearest(field: torch.Tensor, pts: torch.Tensor, goff: int = 0
            ) -> torch.Tensor:
    """Nearest-neighbour gather with .5 ties to the lower index (scipy RGI
    'nearest' parity, the descriptor sampling rule). ``goff``: the field is
    a block whose row 0 is global x ``goff`` (capacity mode); the global
    index moves into it."""
    shp = torch.as_tensor(field.shape[:3], device=pts.device)
    ids = torch.ceil(pts - 0.5).to(torch.int64)
    ids[..., 0] -= int(goff)
    ids = torch.minimum(torch.clamp(ids, min=0), shp - 1)
    return field[ids[..., 0], ids[..., 1], ids[..., 2]]
