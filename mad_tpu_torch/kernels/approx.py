"""K12: approximate pose repeatability of descriptor pairs.

Replaces mad_tpu/engine/match.py:126-155 (``_approx_repeat_body``). The
CUDA kernel ``csrc/approx.cu`` takes two lanes a pair, persistent warps
over tiles of 16 pairs, and counts the anchors whose rounded voxel after
the pose is in the grid and set in the field (K11), all pairs in one
launch; each block first builds a map of coarse cells
(:func:`coarse_cells`) from the map anchors' voxels and K11's radius, and
only an anchor in a set cell reads the field.
:func:`approx_repeat_plain` is the plain PyTorch version: the JAX body's
chunk loop in torch ops, with the pose summed as ``rows_times`` does; it
reads the field for every anchor (the map is a shortcut, not part of the
function).
"""

from __future__ import annotations

import math

import torch

from ..core.geometry import rows_times
from . import build

MAP_BYTES = build.constants("approx.cu")["kMapBytes"]

launches = 0            # kernel launches since the last reset


def _sides(shape, s: int):
    return tuple(-(-int(d) // (1 << s)) for d in shape)


def coarse_shift(shape) -> int:
    """log2 of the coarse cells' edge for a grid of ``shape``: the smallest
    power of two whose map, a byte a cell, fits MAP_BYTES (csrc/approx.cu's
    launcher)."""
    s = 0
    while math.prod(_sides(shape, s)) > MAP_BYTES:
        s += 1
    return s


def coarse_cells(shape, vox: torch.Tensor, radius_vox: int) -> torch.Tensor:
    """The kernel's coarse map as a bool tensor of cells (edge
    2 ** coarse_shift(shape)): set where the box [u - r, u + r] of some
    anchor voxel u, clipped to the grid, overlaps the cell. It holds every
    voxel that K11 sets (within r of an anchor, in the grid)."""
    s = coarse_shift(shape)
    dims = torch.as_tensor(shape, device=vox.device)
    cells = torch.zeros(_sides(shape, s), dtype=torch.bool,
                        device=vox.device)
    lo = torch.clamp(vox.long() - radius_vox, min=0)
    hi = torch.minimum(vox.long() + radius_vox, dims - 1)
    ok = (lo <= hi).all(dim=1)
    lo, hi = lo[ok] >> s, hi[ok] >> s
    span = (2 * radius_vox >> s) + 2
    g = torch.arange(span, device=vox.device)
    c = lo[:, None, None, None, :] + torch.stack(torch.meshgrid(
        g, g, g, indexing="ij"), dim=-1)[None]
    keep = (c <= hi[:, None, None, None, :]).all(dim=-1)
    c = c[keep]
    cells[c[:, 0], c[:, 1], c[:, 2]] = True
    return cells


def approx_repeat_plain(field: torch.Tensor, vox: torch.Tensor,
                        radius_vox: int, hi_cloud: torch.Tensor,
                        origin: torch.Tensor, inv_voxsp: float,
                        rot: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                        chunk: int = 256) -> torch.Tensor:
    shape = torch.as_tensor(field.shape, dtype=torch.float32,
                            device=field.device)
    denom = max(hi_cloud.shape[0], 1)
    inv = torch.tensor(inv_voxsp, dtype=torch.float32, device=field.device)
    out = torch.empty(rot.shape[0], dtype=torch.float32, device=field.device)
    for s in range(0, rot.shape[0], chunk):
        R, h, l = rot[s:s + chunk], hi[s:s + chunk], lo[s:s + chunk]
        # (x - h) @ R^T + l, the pose convention of the start coordinates
        pts = rows_times(hi_cloud[None] - h[:, None],
                         R.transpose(1, 2)) + l[:, None]
        # a NaN coordinate is voxel 0, as mad_tpu's int32 convert makes
        # it; the grid test on the rounded floats (no integer wraps)
        v = torch.round((pts - origin) * inv)
        v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
        inb = ((v >= 0) & (v < shape)).all(dim=-1)
        v = torch.minimum(torch.clamp(v, min=0), shape - 1).to(torch.int64)
        hit = field[v[..., 0], v[..., 1], v[..., 2]] > 0
        cnt = (hit & inb).sum(dim=-1).to(torch.float32)
        out[s:s + chunk] = 100.0 * cnt / torch.full_like(cnt, denom)
    return out


def approx_repeat(field: torch.Tensor, vox: torch.Tensor, radius_vox: int,
                  hi_cloud: torch.Tensor, origin: torch.Tensor,
                  inv_voxsp: float, rot: torch.Tensor, hi: torch.Tensor,
                  lo: torch.Tensor) -> torch.Tensor:
    """Per pair k: 100 * (# subunit anchors x whose voxel
    round(((x - hi_k) @ R_k^T + lo_k - origin) * inv_voxsp) lies in the
    grid and is set in ``field``) / len(hi_cloud).

    field (X, Y, Z) int8, K11's field of the map anchors' voxels vox
    (A_lo, 3) int32 at radius_vox (the kernel's coarse map is built from
    them: a field that is not theirs gives wrong counts on the card);
    hi_cloud (A_hi, 3), origin (3,), rot (P, 3, 3), hi/lo (P, 3) float32,
    all on one device. Returns (P,) float32."""
    if field.device.type == "cpu":
        return approx_repeat_plain(field, vox, radius_vox, hi_cloud, origin,
                                   inv_voxsp, rot, hi, lo)
    global launches
    hi_cloud, origin, rot, hi, lo = [
        t.to(torch.float32).contiguous()
        for t in (hi_cloud, origin, rot, hi, lo)]
    # the kernel's 16-byte pose loads
    rot, hi, lo = [t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (rot, hi, lo)]
    field = field.contiguous()
    vox = vox.to(torch.int32).contiguous()
    build.require_cuda("approx_repeat", field, vox, hi_cloud, origin, rot,
                       hi, lo)
    if (field.dtype != torch.int8 or field.dim() != 3
            or field.numel() >= 1 << 31 or max(field.shape) >= 1 << 16
            or vox.dim() != 2 or vox.shape[1] != 3 or radius_vox < 0
            or rot.shape[1:] != (3, 3) or hi_cloud.shape[-1] != 3
            or origin.shape != (3,)):
        raise ValueError("approx_repeat: bad shapes or field type")
    P = rot.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=rot.device)
    if P == 0:
        return out
    X, Y, Z = field.shape
    lib = build.library()
    build.launch(
        lib.mad_approx_repeat, rot.device, field.data_ptr(), X, Y, Z,
        vox.data_ptr(), vox.shape[0], int(radius_vox), hi_cloud.data_ptr(),
        hi_cloud.shape[0], origin.data_ptr(), float(inv_voxsp),
        rot.data_ptr(), hi.data_ptr(), lo.data_ptr(), P, out.data_ptr())
    launches += 1
    return out
