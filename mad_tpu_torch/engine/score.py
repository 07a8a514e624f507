"""CC scoring of simulated grids against the map (port of
mad_tpu/engine/score.py).

Each candidate's simulated grid correlates with the map over the
candidate's own box (mad/Dmap.py:153-258): map voxels outside the real map
count as zero, and model voxels there drop from the model's norm, as the
reference's overlap-box crop does (kernel K17, :mod:`..kernels.ccc`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import DensityGrid
from ..kernels import ccc as k17
from ..ops.simulate import batched_simulate
from ..utils import profiling, sanitize


def batched_ccc(dmap: DensityGrid, model_grids: torch.Tensor,
                model_origins: np.ndarray) -> np.ndarray:
    """CCC of each (M, bx, by, bz) model grid against the map: one K17
    launch for all models."""
    starts = np.rint(
        (model_origins - np.asarray(dmap.origin)) / dmap.voxsp).astype(int)
    dev = model_grids.device
    out = profiling.pull(k17.batched_ccc(
        dmap.data.to(dev), model_grids,
        torch.as_tensor(starts, dtype=torch.int32, device=dev))).numpy()
    sanitize.check_host("score.ccc", out)
    return out


def ccc_structures(dmap: DensityGrid, coords: np.ndarray, masses: np.ndarray,
                   resolution: float, isovalue: float = 0.0,
                   shape_bucket: int = 16, device=None) -> np.ndarray:
    """Simulate M same-sized structures and CC-score them against the map.

    coords: (M, N, 3); masses: (N,) or (M, N)."""
    device = torch.device(device) if device is not None else dmap.device
    m, n = coords.shape[:2]
    if masses.ndim == 1:
        masses = np.tile(masses, (m, 1))
    grids, origins = batched_simulate(coords, masses, resolution, dmap.voxsp,
                                      device, isovalue=isovalue,
                                      shape_bucket=shape_bucket)
    return batched_ccc(dmap, grids, origins)
