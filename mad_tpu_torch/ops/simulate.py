"""Structure -> simulated density map (port of mad_tpu/ops/simulate.py).

Replaces PDB.structure_to_density (mad/PDB.py:131-208):
  1. mass-weighted trilinear scatter of atoms onto a lattice-registered box
     (margin = 2 + pad voxels), normalized to max 1;
  2. Gaussian blur with sigma = resolution / (pi*sqrt(2)) / voxsp truncated
     at ceil(3*sigma), *full* convolution (the box grows by the radius),
     through kernel K1;
  3. normalize to max 1, clamp below the isovalue.
The scatter is ``index_put_(accumulate=True)``, one call per cell corner.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..core.config import bucket
from ..core.grid import DensityGrid
from ..core.structure import Structure
from .convolve import separable_conv3d


@dataclass(frozen=True)
class SimPlan:
    box: Tuple[int, int, int]       # scatter-grid dims
    vox_min: Tuple[float, float, float]  # lattice-registered min corner (A)
    margin: int
    radius: int                     # blur kernel radius (voxels)
    sigma: float                    # blur sigma (voxels)
    voxsp: float
    isovalue: float

    @property
    def out_origin(self) -> np.ndarray:
        return np.asarray(self.vox_min) - (self.radius + self.margin) * self.voxsp


def plan_simulation(coords: np.ndarray, resolution: float, voxsp: float,
                    isovalue: float = 0.0, pad: int = 0,
                    shape_bucket: int = 16) -> SimPlan:
    """Host-side planning: registered box extents + blur size. The box
    rounds up to ``shape_bucket`` voxels, as in mad_tpu (it sets the grid
    shape the rest of the pipeline sees)."""
    mins = voxsp * np.floor(coords.min(axis=0) / voxsp)
    maxs = voxsp * np.ceil(coords.max(axis=0) / voxsp)
    margin = 2 + pad
    dims = np.ceil((maxs - mins) / voxsp).astype(int) + 2 * margin + 1
    dims = tuple(bucket(int(d), shape_bucket) for d in dims)
    sigma = resolution / (math.pi * math.sqrt(2.0)) / voxsp
    radius = int(math.ceil(3.0 * sigma))
    return SimPlan(box=dims, vox_min=tuple(float(m) for m in mins),
                   margin=margin, radius=radius, sigma=sigma, voxsp=voxsp,
                   isovalue=isovalue)


def simulated_shape(coords: np.ndarray, resolution: float, voxsp: float,
                    pad: int = 0, shape_bucket: int = 16
                    ) -> Tuple[int, int, int]:
    """simulate_density's output grid shape, without running it."""
    p = plan_simulation(np.asarray(coords), resolution, voxsp, pad=pad,
                        shape_bucket=shape_bucket)
    return tuple(b + 2 * p.radius for b in p.box)


def _blur_taps(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k1 = np.exp(-(x * x) / (2.0 * sigma ** 2))
    return (k1 / k1.sum()).astype(np.float32)


def _scatter_blur(coords: torch.Tensor, masses: torch.Tensor,
                  vox_min: torch.Tensor, box, margin: int, voxsp: float,
                  taps: np.ndarray, isovalue: float) -> torch.Tensor:
    """One structure: trilinear mass scatter, normalize, 'full' blur,
    normalize, clamp (mad_tpu/ops/simulate.py:86-108)."""
    g = margin + (coords - vox_min) / voxsp
    g0 = torch.floor(g)
    frac = g - g0
    i0 = g0.to(torch.int64)
    w1, w0 = frac, 1.0 - frac
    grid = torch.zeros(box, dtype=torch.float32, device=coords.device)
    dims = torch.as_tensor(box, device=coords.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (masses
                     * (w1[:, 0] if dx else w0[:, 0])
                     * (w1[:, 1] if dy else w0[:, 1])
                     * (w1[:, 2] if dz else w0[:, 2]))
                idx = i0 + torch.as_tensor([dx, dy, dz], device=i0.device)
                keep = ((idx >= 0) & (idx < dims)).all(dim=1)
                idx, w = idx[keep], w[keep]
                grid.index_put_((idx[:, 0], idx[:, 1], idx[:, 2]), w,
                                accumulate=True)
    grid = grid / torch.clamp(grid.max(), min=1e-30)
    dens = separable_conv3d(grid, (taps, taps, taps), mode="full")
    dens = dens / torch.clamp(dens.max(), min=1e-30)
    if isovalue:
        dens = torch.where(dens < isovalue, torch.zeros_like(dens), dens)
    return dens


def simulate_density(struct_or_coords, resolution: float, voxsp: float,
                     device, isovalue: float = 0.0, pad: int = 0,
                     masses: np.ndarray = None, shape_bucket: int = 16,
                     name: str = "") -> DensityGrid:
    """Simulate a density map from a structure at (resolution, voxsp), on
    ``device``."""
    if isinstance(struct_or_coords, Structure):
        coords = struct_or_coords.coords
        masses = struct_or_coords.masses
        name = name or struct_or_coords.source
    else:
        coords = np.asarray(struct_or_coords)
        if masses is None:
            masses = np.full(coords.shape[0], 12.011, dtype=np.float32)
    plan = plan_simulation(coords, resolution, voxsp, isovalue, pad,
                           shape_bucket)
    dens = _scatter_blur(
        torch.as_tensor(coords, dtype=torch.float32, device=device),
        torch.as_tensor(masses, dtype=torch.float32, device=device),
        torch.as_tensor(plan.vox_min, dtype=torch.float32, device=device),
        plan.box, plan.margin, plan.voxsp,
        _blur_taps(plan.sigma, plan.radius), plan.isovalue)
    return DensityGrid(data=dens, origin=plan.out_origin, voxsp=voxsp,
                       name=name)


def batched_simulate(coords: np.ndarray, masses: np.ndarray,
                     resolution: float, voxsp: float, device,
                     isovalue: float = 0.0, shape_bucket: int = 16):
    """Simulate M same-sized structures on one common box size.

    coords: (M, N, 3); masses: (M, N). Each structure keeps its own
    lattice-registered origin. Returns (density (M, X, Y, Z) tensor,
    origins (M, 3) numpy)."""
    mins = voxsp * np.floor(coords.min(axis=1) / voxsp)          # (M, 3)
    maxs = voxsp * np.ceil(coords.max(axis=1) / voxsp)
    margin = 2
    dims = np.ceil((maxs - mins) / voxsp).astype(int) + 2 * margin + 1
    box = tuple(bucket(int(d), shape_bucket) for d in dims.max(axis=0))
    sigma = resolution / (math.pi * math.sqrt(2.0)) / voxsp
    radius = int(math.ceil(3.0 * sigma))
    taps = _blur_taps(sigma, radius)
    c = torch.as_tensor(coords, dtype=torch.float32, device=device)
    w = torch.as_tensor(masses, dtype=torch.float32, device=device)
    vm = torch.as_tensor(mins, dtype=torch.float32, device=device)
    dens = torch.stack([
        _scatter_blur(c[i], w[i], vm[i], box, margin, voxsp, taps, isovalue)
        for i in range(coords.shape[0])])
    origins = mins - (radius + margin) * voxsp
    return dens, origins
