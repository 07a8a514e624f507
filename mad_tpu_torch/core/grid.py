"""Density grid container (port of mad_tpu/core/grid.py).

``DensityGrid.data`` is a float32 torch tensor that stays on its device
through the pipeline; ``origin`` stays float64 numpy. ``reduce_void``
takes its per-axis occupancy flags from K22 (one pull) and its crop and
re-pad from K23, as ``padded`` does its padding (``kernels/crop_pad.py``).
The map readers and writers and the grid-space scores (``mask_with``,
``ccc_with``, ``overlap_boxes``, ``ccc_grids``, ``ccc_maps_scaled``,
``overlap_fraction``) are copies of the originals' host float64 numpy;
they read a tensor's host copy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

from ..device import resolve
from ..kernels.crop_pad import axis_flags, crop_pad
from .mrc_io import read_mrc as _read_mrc_file
from .mrc_io import write_mrc as _write_mrc_file


@dataclass
class DensityGrid:
    """data[x, y, z] float32 tensor, origin in Angstroms, cubic voxels."""

    data: torch.Tensor
    origin: np.ndarray          # (3,) float64
    voxsp: float
    name: str = ""

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def host(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def to(self, device) -> "DensityGrid":
        return replace(self, data=self.data.to(device))

    def copy(self) -> "DensityGrid":
        return replace(self, data=self.data.clone(),
                       origin=self.origin.copy())

    # -- preprocessing (parity: mad/Dmap.py:50-97) ------------------------

    def clamp_isovalue(self, isovalue: float) -> "DensityGrid":
        d = self.data
        if float(d.max()) > isovalue:
            d = torch.where(d < isovalue, torch.zeros_like(d), d)
        else:
            d = torch.where(d < 0, torch.zeros_like(d), d)
        return replace(self, data=d)

    def normalized(self) -> "DensityGrid":
        m = self.data.max()
        if np.isclose(float(m), 0):
            return self
        return replace(self, data=self.data / m)

    def padded(self, pad: int) -> "DensityGrid":
        return replace(self, data=crop_pad(self.data, (0, 0, 0), self.shape,
                                           pad),
                       origin=self.origin - pad * self.voxsp)

    def reduce_void(self, zeros_padding: int = 10) -> "DensityGrid":
        """Crop to the nonzero bounding box then re-pad
        (parity: mad/Dmap.py:73-90)."""
        flags = axis_flags(self.data).cpu().numpy()
        X, Y, _Z = self.shape
        axes_any = [flags[:X], flags[X:X + Y], flags[X + Y:]]
        if not axes_any[0].any():
            return self
        lo = np.array([int(np.argmax(a)) for a in axes_any])
        hi = np.array([len(a) - int(np.argmax(a[::-1])) for a in axes_any])
        p = zeros_padding
        return replace(self, data=crop_pad(self.data, lo, hi - lo, p),
                       origin=self.origin + (lo - p) * self.voxsp)

    def mask_with(self, mask: "DensityGrid", eps: float = 1e-8
                  ) -> "DensityGrid":
        """Zero every voxel that is zero (or outside) in the mask grid
        (parity: Dmap.mask_with, mad/Dmap.py:99-151); on ``self``'s
        device."""
        if not np.isclose(self.voxsp, mask.voxsp):
            raise ValueError(
                f"voxel spacings do not match: {self.voxsp} vs {mask.voxsp}")
        out = np.zeros(self.shape, dtype=np.float32)
        box = self.overlap_box_with(mask)
        if box is not None:
            lo1, hi1, lo2, hi2 = box
            mdata = mask.host()
            sdata = self.host()
            common = mdata[lo2[0]:hi2[0], lo2[1]:hi2[1], lo2[2]:hi2[2]]
            region = sdata[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]]
            out[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]] = np.where(
                common < eps, 0.0, region)
        return replace(self, data=torch.as_tensor(out, device=self.device))

    # -- scoring ----------------------------------------------------------

    def overlap_box_with(self, other: "DensityGrid"):
        return overlap_boxes(
            self.origin, self.shape, other.origin, other.shape, self.voxsp
        )

    def ccc_with(self, other: "DensityGrid", isovalue: float = 0.0) -> float:
        """Normalized cross-correlation over the overlapping box
        (parity: Dmap.get_CCC_with_grid, mad/Dmap.py:153-258)."""
        return ccc_grids(
            self.host(), self.origin, other.host(), other.origin, self.voxsp,
            isovalue=isovalue,
        )


def _host(a) -> np.ndarray:
    """A numpy view of an array or a tensor's host copy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def overlap_boxes(origin1, shape1, origin2, shape2, voxsp):
    """Index ranges of the voxel-aligned intersection of two grids.

    Returns (lo1, hi1, lo2, hi2) int arrays or None when disjoint. Mirrors
    the origin arithmetic of mad/Dmap.py:170-234 (round-to-nearest voxel).
    """
    o1 = np.asarray(origin1, dtype=np.float64) / voxsp
    o2 = np.asarray(origin2, dtype=np.float64) / voxsp
    s1 = np.asarray(shape1, dtype=np.int64)
    s2 = np.asarray(shape2, dtype=np.int64)
    shift = np.rint(o2 - o1).astype(np.int64)   # grid2 origin in grid1 index space
    lo1 = np.maximum(shift, 0)
    hi1 = np.minimum(s1, s2 + shift)
    if np.any(hi1 <= lo1):
        return None
    lo2 = lo1 - shift
    hi2 = hi1 - shift
    return lo1, hi1, lo2, hi2


def ccc_grids(grid1, origin1, grid2, origin2, voxsp, isovalue: float = 0.0):
    """CCC = <g1, g2> / sqrt(<g1,g1><g2,g2>) over the overlap box.

    Parity with mad/Dmap.py:153-258, including that the norms are taken over
    the overlap box only (not the full grids).
    """
    grid1 = _host(grid1)
    grid2 = _host(grid2)
    box = overlap_boxes(origin1, grid1.shape, origin2, grid2.shape, voxsp)
    if box is None:
        return 0.0
    lo1, hi1, lo2, hi2 = box
    m1 = grid1[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]].astype(np.float64)
    m2 = grid2[lo2[0]:hi2[0], lo2[1]:hi2[1], lo2[2]:hi2[2]].astype(np.float64)
    if isovalue:
        m1 = np.where(m1 < isovalue, 0.0, m1)
        m2 = np.where(m2 < isovalue, 0.0, m2)
    olap = float(np.vdot(m1, m2))
    n1 = float(np.vdot(m1, m1))
    n2 = float(np.vdot(m2, m2))
    denom = np.sqrt(n1 * n2)
    if denom == 0:
        return 0.0
    return olap / denom


def ccc_maps_scaled(m1: "DensityGrid", m2: "DensityGrid",
                    isovalue: float = 0.0) -> float:
    """Common-voxel-scaled CCC between two maps
    (parity: Dmap.get_CCC_with_dmap, mad/Dmap.py:260-372): each map is
    normalized over the voxels where the *other* map is nonzero, the dot
    product is then scaled by the fraction of the smaller map's nonzero
    voxels that are shared."""
    if m1.voxsp != m2.voxsp:
        raise ValueError(f"voxsp differ ({m1.voxsp} vs {m2.voxsp})")
    box = m1.overlap_box_with(m2)
    if box is None:
        return 0.0
    lo1, hi1, lo2, hi2 = box
    d1, d2 = m1.host(), m2.host()
    a = d1[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]].astype(
        np.float64).copy()
    b = d2[lo2[0]:hi2[0], lo2[1]:hi2[1], lo2[2]:hi2[2]].astype(
        np.float64).copy()
    nonzero = min(np.count_nonzero(d1 > isovalue),
                  np.count_nonzero(d2 > isovalue))
    common = int(np.count_nonzero(b[(b > isovalue) & (a > isovalue)]))
    if not common or not nonzero:
        return 0.0
    na = np.linalg.norm(a[b > 0])
    nb = np.linalg.norm(b[a > 0])
    if na == 0 or nb == 0:
        return 0.0
    a /= na
    b /= nb
    return float(np.vdot(a, b)) * common / nonzero


def overlap_fraction(grid1, origin1, grid2, origin2, voxsp,
                     isovalue: float = 1e-8) -> float:
    """Fraction of grid1's nonzero voxels that overlap nonzero voxels of
    grid2 (parity: structure_utils.get_overlap, mad/structure_utils.py:163-259)."""
    g1 = np.where(_host(grid1) < isovalue, 0.0, _host(grid1))
    g2 = np.where(_host(grid2) < isovalue, 0.0, _host(grid2))
    box = overlap_boxes(origin1, g1.shape, origin2, g2.shape, voxsp)
    m1_vals = np.count_nonzero(g1 > 0)
    if m1_vals == 0 or box is None:
        return 0.0
    lo1, hi1, lo2, hi2 = box
    m1 = g1[lo1[0]:hi1[0], lo1[1]:hi1[1], lo1[2]:hi1[2]]
    m2 = g2[lo2[0]:hi2[0], lo2[1]:hi2[1], lo2[2]:hi2[2]]
    common = int(np.count_nonzero((m1 > 0) & (m2 > 0)))
    return common / m1_vals


# -- file I/O (copied from mad_tpu/core/grid.py, numpy) --------------------

def read_map(path: str, isovalue: float = 0.0, normalize: bool = True,
             *, device=None) -> DensityGrid:
    """Load .mrc/.map/.sit/.situs into a DensityGrid on ``device`` (the
    card unless named; ``device.resolve``)
    (parity: mad/Dmap.py:11-67 incl. MRC axis-order + nxstart/origin)."""
    device = resolve(device)
    ext = os.path.splitext(path)[-1].lower()
    name = os.path.splitext(os.path.split(path)[-1])[0]
    if ext in (".sit", ".situs"):
        data, origin, voxsp = _read_sit(path)
    elif ext in (".map", ".mrc"):
        data, origin, voxsp = _read_mrc(path)
    else:
        raise ValueError(f"Unsupported map format: {path}")
    g = DensityGrid(data=torch.as_tensor(data, device=device),
                    origin=origin, voxsp=voxsp, name=name)
    g = g.clamp_isovalue(isovalue)
    if normalize:
        g = g.normalized()
    return g


def _read_sit(path: str):
    with open(path, "rb") as fh:
        header = fh.readline().decode().split()
        fh.readline()
        body = fh.read()
    grid1d = np.fromiter((float(t) for t in body.split()), dtype=np.float64)
    voxsp, xi, yi, zi = [float(x) for x in header[:4]]
    xb, yb, zb = [int(x) for x in header[4:7]]
    data = np.reshape(grid1d.astype(np.float32), (xb, yb, zb), order="F")
    return np.ascontiguousarray(data), np.array([xi, yi, zi]), voxsp


def _read_mrc(path: str):
    hdr, raw = _read_mrc_file(path)
    axis_order = [hdr.mapc - 1, hdr.mapr - 1, hdr.maps - 1]
    voxsp = hdr.voxel_size_x
    if all([hdr.nxstart, hdr.nystart, hdr.nzstart]):
        start = np.array([hdr.nxstart, hdr.nystart, hdr.nzstart])
        origin = np.array([start[a] * voxsp for a in axis_order],
                          dtype=np.float64)
    else:
        o = np.asarray(hdr.origin, dtype=np.float64)
        origin = np.array([o[a] for a in axis_order])
    data = np.ascontiguousarray(
        np.transpose(raw, axis_order[::-1]).astype(np.float32))
    return data, origin, voxsp


def write_mrc(grid: DensityGrid, path: str) -> None:
    """Write MRC with mapc/r/s = 1/2/3 and origin header
    (parity: mad/Dmap.py:392-416)."""
    # Contiguous before writing: ndarray.tofile of the transposed view
    # writes element by element, several times slower for the same bytes.
    _write_mrc_file(path, np.ascontiguousarray(
        grid.host().astype(np.float32).transpose(2, 1, 0)),
        grid.voxsp, grid.origin)


def write_sit(grid: DensityGrid, path: str) -> None:
    """Situs text format (parity: mad/Dmap.py:377-390), byte for byte with
    mad_tpu's writer: ten "%6.6f" values a line, formatted a block of
    lines at a time."""
    xb, yb, zb = grid.shape
    vals = grid.host().transpose(2, 1, 0).reshape(-1).tolist()  # x fastest
    line = "   " + "   ".join(["%6.6f"] * 10) + "   \n"
    full = len(vals) // 10
    with open(path, "w") as fh:
        fh.write("%f %f %f %f %i %i %i\n\n" % (
            grid.voxsp, grid.origin[0], grid.origin[1], grid.origin[2],
            xb, yb, zb))
        for r in range(0, full, _SIT_LINES):
            k = min(_SIT_LINES, full - r)
            fh.write((line * k) % tuple(vals[10 * r:10 * (r + k)]))
        if len(vals) > 10 * full:
            fh.write("   " + "   ".join("%6.6f" % v
                                        for v in vals[10 * full:])
                     + "   \n")


_SIT_LINES = 10_000     # lines of a Situs file formatted at once
