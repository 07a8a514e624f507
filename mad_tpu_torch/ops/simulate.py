"""Structure -> simulated density map (port of mad_tpu/ops/simulate.py).

Replaces PDB.structure_to_density (mad/PDB.py:131-208):
  1. mass-weighted trilinear scatter of atoms onto a lattice-registered box
     (margin = 2 + pad voxels), normalized to max 1;
  2. Gaussian blur with sigma = resolution / (pi*sqrt(2)) / voxsp truncated
     at ceil(3*sigma), *full* convolution (the box grows by the radius),
     through kernel K1, three launches for a whole batch;
  3. normalize to max 1, clamp below the isovalue.
On the card the whole body of a batch runs in kernels, with no torch op
on the volume: K9 (:mod:`mad_tpu_torch.kernels.scatter`) scatters and
takes each structure's max, K1's blur divides its x pass's inputs by it
and takes the blurred max in its z pass
(:mod:`mad_tpu_torch.kernels.conv1d`), and K9's scale-and-clamp pass
finishes in place. :func:`simulate_batch_plain` is the plain version of
the body (the torch sequence), which a CPU tensor takes.
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
from ..device import resolve
from ..kernels import conv1d, maxkey, scatter
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


def finish_plain(grids: torch.Tensor, taps: np.ndarray,
                 isovalue: float) -> torch.Tensor:
    """The body after the scatter, as torch ops on (M, X, Y, Z) grids:
    normalize, 'full' blur (the batch at once), normalize, clamp
    (mad_tpu/ops/simulate.py:103-107)."""
    grids = grids / torch.clamp(grids.amax(dim=(1, 2, 3), keepdim=True),
                                min=1e-30)
    dens = separable_conv3d(grids, (taps, taps, taps), mode="full")
    del grids
    dens = dens / torch.clamp(dens.amax(dim=(1, 2, 3), keepdim=True),
                              min=1e-30)
    if isovalue:
        dens = torch.where(dens < isovalue, torch.zeros_like(dens), dens)
    return dens


def simulate_batch_plain(coords: torch.Tensor, masses: torch.Tensor,
                         vox_min: torch.Tensor, box, margin: int,
                         voxsp: float, taps: np.ndarray,
                         isovalue: float) -> torch.Tensor:
    """The plain version of the body of M structures: the plain scatter,
    then :func:`finish_plain` (mad_tpu/ops/simulate.py:86-108)."""
    return finish_plain(scatter.scatter_atoms_plain(coords, masses, vox_min,
                                                    box, margin, voxsp),
                        taps, isovalue)


def _simulate_batch(coords: torch.Tensor, masses: torch.Tensor,
                    vox_min: torch.Tensor, box, margin: int, voxsp: float,
                    taps: np.ndarray, isovalue: float) -> torch.Tensor:
    """M structures: the trilinear mass scatter, normalize, 'full' blur,
    normalize, clamp (mad_tpu/ops/simulate.py:86-108). On the card: K9
    with the grids' maxima, K1's three blur passes (the x pass divides its
    inputs by the maxima, the z pass takes the blurred maxima), then the
    scale-and-clamp pass in place; bit for bit with the plain version
    whose scatter runs on the CPU. A CPU tensor takes the plain version."""
    if coords.device.type == "cpu":
        return simulate_batch_plain(coords, masses, vox_min, box, margin,
                                    voxsp, taps, isovalue)
    M = masses.shape[0]
    # the grids' and the blurred volumes' maxima, zeroed at once
    gmax, dmax = maxkey.new_keys(2 * M, coords.device).split(M)
    grids = scatter.scatter_atoms(coords, masses, vox_min, box, margin, voxsp,
                                  max_into=gmax)
    dens = conv1d.conv1d_along(grids, taps, 0, "full", divide_by=gmax)
    del grids
    dens = conv1d.conv1d_along(dens, taps, 1, "full")
    dens = conv1d.conv1d_along(dens, taps, 2, "full", max_into=dmax)
    return scatter.scale_clamp(dens, dmax, isovalue)


def simulate_density(struct_or_coords, resolution: float, voxsp: float,
                     isovalue: float = 0.0, pad: int = 0,
                     masses: np.ndarray = None, shape_bucket: int = 16,
                     name: str = "", *, device=None) -> DensityGrid:
    """Simulate a density map from a structure at (resolution, voxsp), on
    ``device`` (``device.resolve``: the card unless named)."""
    device = resolve(device)
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
    dens = _simulate_batch(
        torch.as_tensor(coords, dtype=torch.float32, device=device)[None],
        torch.as_tensor(masses, dtype=torch.float32, device=device)[None],
        torch.as_tensor(plan.vox_min, dtype=torch.float32,
                        device=device)[None],
        plan.box, plan.margin, plan.voxsp,
        _blur_taps(plan.sigma, plan.radius), plan.isovalue)
    return DensityGrid(data=dens[0], origin=plan.out_origin, voxsp=voxsp,
                       name=name)


def _batch_plan(coords: np.ndarray, voxsp: float, shape_bucket: int):
    """Lattice-registered min corners (M, 3), the common scatter box and
    the margin of a batch."""
    mins = voxsp * np.floor(coords.min(axis=1) / voxsp)          # (M, 3)
    maxs = voxsp * np.ceil(coords.max(axis=1) / voxsp)
    margin = 2
    dims = np.ceil((maxs - mins) / voxsp).astype(int) + 2 * margin + 1
    box = tuple(bucket(int(d), shape_bucket) for d in dims.max(axis=0))
    return mins, box, margin


def scatter_args(coords: np.ndarray, masses: np.ndarray, voxsp: float,
                 device, shape_bucket: int = 16):
    """The arguments ``batched_simulate`` hands to K9 for this batch:
    (coords, masses, vox_min tensors on ``device``, box, margin, voxsp)."""
    mins, box, margin = _batch_plan(coords, voxsp, shape_bucket)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(coords, **f32), torch.as_tensor(masses, **f32),
            torch.as_tensor(mins, **f32), box, margin, voxsp)


def batched_simulate(coords: np.ndarray, masses: np.ndarray,
                     resolution: float, voxsp: float, device,
                     isovalue: float = 0.0, shape_bucket: int = 16):
    """Simulate M same-sized structures on one common box size.

    coords: (M, N, 3); masses: (M, N). Each structure keeps its own
    lattice-registered origin. Returns (density (M, X, Y, Z) tensor,
    origins (M, 3) numpy)."""
    mins, _box, margin = _batch_plan(coords, voxsp, shape_bucket)
    sigma = resolution / (math.pi * math.sqrt(2.0)) / voxsp
    radius = int(math.ceil(3.0 * sigma))
    dens = _simulate_batch(
        *scatter_args(coords, masses, voxsp, device, shape_bucket),
        _blur_taps(sigma, radius), isovalue)
    origins = mins - (radius + margin) * voxsp
    return dens, origins
