"""Density grid container (port of mad_tpu/core/grid.py).

``DensityGrid.data`` is a float32 torch tensor that stays on its device
through the pipeline; ``origin`` stays float64 numpy. ``reduce_void``
takes its per-axis occupancy flags from K22 (one pull) and its crop and
re-pad from K23, as ``padded`` does its padding (``kernels/crop_pad.py``).
The map readers are copies of the originals (numpy only).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch

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


# -- file I/O (copied from mad_tpu/core/grid.py, numpy) --------------------

def read_map(path: str, device, isovalue: float = 0.0,
             normalize: bool = True) -> DensityGrid:
    """Load .mrc/.map/.sit/.situs into a DensityGrid on ``device``
    (parity: mad/Dmap.py:11-67 incl. MRC axis-order + nxstart/origin)."""
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
