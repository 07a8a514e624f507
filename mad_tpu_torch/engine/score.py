"""CC scoring of simulated grids against the map (port of
mad_tpu/engine/score.py).

Each candidate's simulated grid correlates with the map over the
candidate's own box (mad/Dmap.py:153-258): the map is zero-padded so every
box is a plain slice, and model voxels outside the real map drop from the
model's norm, as the reference's overlap-box crop does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.grid import DensityGrid
from ..ops.simulate import batched_simulate


def batched_ccc(dmap: DensityGrid, model_grids: torch.Tensor,
                model_origins: np.ndarray) -> np.ndarray:
    """CCC of each (M, bx, by, bz) model grid against the map."""
    model_shape = tuple(model_grids.shape[1:])
    shape = np.asarray(dmap.shape)
    starts = np.rint(
        (model_origins - np.asarray(dmap.origin)) / dmap.voxsp).astype(int)
    pad_lo = np.maximum(0, -starts.min(axis=0))
    pad_hi = np.maximum(0, (starts + model_shape).max(axis=0) - shape)
    data = dmap.data.to(model_grids.device)
    map_pad = F.pad(data, (int(pad_lo[2]), int(pad_hi[2]), int(pad_lo[1]),
                           int(pad_hi[1]), int(pad_lo[0]), int(pad_hi[0])))
    in_lo, in_hi = pad_lo, pad_lo + shape
    out = torch.empty(model_grids.shape[0], dtype=torch.float32,
                      device=model_grids.device)
    for i, s in enumerate(starts + pad_lo):
        sub = map_pad[s[0]:s[0] + model_shape[0], s[1]:s[1] + model_shape[1],
                      s[2]:s[2] + model_shape[2]]
        inb = None
        for a in range(3):
            r = torch.arange(model_shape[a], device=sub.device) + int(s[a])
            m = (r >= int(in_lo[a])) & (r < int(in_hi[a]))
            m = m.reshape([-1 if b == a else 1 for b in range(3)])
            inb = m if inb is None else inb & m
        model = model_grids[i] * inb
        olap = (sub * model).sum()
        n1 = (sub * sub).sum()
        n2 = (model * model).sum()
        out[i] = olap / torch.clamp(torch.sqrt(n1 * n2), min=1e-30)
    return out.cpu().numpy()


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
