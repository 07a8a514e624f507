"""Gaussian/LoG scale space (port of mad_tpu/ops/scalespace.py).

Replaces MapSpace.build_space (mad/MapSpace.py:69-189): an optional x2
upsampled octave (Catmull-Rom, presmoothed) and the base octave, each with
its scale-normalized negative LoG (clamped at 0) and the gradient of its
Gaussian-smoothed volume (kernel K3, :mod:`mad_tpu_torch.kernels.gradient`).

The map is zero-padded by ``map_padding`` voxels and used at its real
size; mad_tpu's shape buckets only bounded XLA recompiles. Octaves build
one at a time and each field is freed as soon as its consumer is done.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ScaleSpaceConfig
from ..core.grid import DensityGrid
from ..kernels.gradient import gradient  # noqa: F401  (K3, the octave field)
from .convolve import gaussian_filter3d, log_filter3d, upsample2

# Above this many octave voxels the gradient field is stored as bfloat16
# (mad_tpu/ops/scalespace.py:287: 250 M voxels = 3 GB of float32 gradients).
BF16_VOXELS = 250_000_000


@dataclass
class Octave:
    """One scale-space octave of a padded map."""

    base: torch.Tensor        # padded base volume (shared by the octaves)
    voxsp: float
    upsampled: bool
    cfg: ScaleSpaceConfig

    @property
    def real_shape(self) -> Tuple[int, int, int]:
        s = tuple(self.base.shape)
        return tuple(2 * x - 1 for x in s) if self.upsampled else s

    def volume(self) -> torch.Tensor:
        vol = self.base
        if self.upsampled:
            vol = upsample2(vol)
            if self.cfg.presmooth_sigma:
                vol = gaussian_filter3d(vol, self.cfg.presmooth_sigma,
                                        self.cfg.truncate)
        return vol

    def log_gauss(self):
        """(LoG response, Gaussian-smoothed volume)."""
        return log_filter3d(self.volume(), self.cfg.detect_sigma,
                            self.cfg.truncate)

    def grad_dtype(self):
        n = int(np.prod(self.real_shape, dtype=np.int64))
        return torch.bfloat16 if n > BF16_VOXELS else torch.float32


def prepare(grid: DensityGrid, cfg: ScaleSpaceConfig):
    """Zero-pad the map by ``map_padding``; returns (volume, origin)."""
    pad = int(cfg.map_padding)
    data = grid.data.to(torch.float32)
    if pad:
        data = F.pad(data, (pad,) * 6)
    return data, grid.origin - pad * grid.voxsp


def iter_octaves(grid: DensityGrid, cfg: ScaleSpaceConfig):
    """Yield (origin, Octave): the upsampled octave first, as mad_tpu."""
    data, origin = prepare(grid, cfg)
    if cfg.oct_mode in ("up", "both"):
        yield origin, Octave(data, grid.voxsp / 2.0, True, cfg)
    if cfg.oct_mode in ("base", "both"):
        yield origin, Octave(data, grid.voxsp, False, cfg)
