"""Anchor detection: LoG peaks + batched Newton subvoxel localization
(port of mad_tpu/ops/detect.py, single device).

Replaces Detector.find_anchors / check_localize (mad/Detector.py:18-123):
  * peaks = voxels equal to their 3x3x3 neighbourhood max, above an
    absolute threshold, ``exclude_border`` voxels inside the real extent;
    the top ``max_anchors`` by response, ties in flat-index order
    (kernel K4, :mod:`mad_tpu_torch.kernels.peaks`);
  * each peak runs <= n_iter Newton steps on a finite-difference Hessian
    and gradient; offsets > max_offset walk one voxel, convergence needs
    all |offset| < max_offset, saddles (an eigenvalue > 0, tested by the
    characteristic-polynomial invariants) are rejected (kernel K5,
    :mod:`mad_tpu_torch.kernels.localize`).
The anchor table holds exactly the peaks found (at most ``max_anchors``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import DetectConfig
from ..kernels.localize import localize
from ..kernels.peaks import peak_topk


@dataclass
class Anchors:
    """Anchor set of one octave, in detection (response) order."""

    coords: torch.Tensor      # (K, 3) int64 voxel coords (post-walk)
    subvox: torch.Tensor      # (K, 3) float32 subvoxel coords (voxels)
    values: torch.Tensor      # (K,) float32 LoG response at the seed peak
    valid: torch.Tensor       # (K,) bool: localized, not a saddle

    @property
    def n(self) -> int:
        return self.coords.shape[0]


def detect_anchors(log_vol: torch.Tensor, real_shape,
                   cfg: DetectConfig) -> Anchors:
    """Anchors of one octave's LoG volume (real_shape = its real extent)."""
    eb = int(cfg.exclude_border)
    vals, flat = peak_topk(log_vol, real_shape, float(cfg.threshold_abs), eb,
                           int(cfg.max_anchors))
    shape = log_vol.shape
    seeds = torch.stack([flat // (shape[1] * shape[2]),
                         (flat // shape[2]) % shape[1], flat % shape[2]], -1)
    hi = torch.as_tensor(np.asarray(real_shape) - eb - 1, device=seeds.device)
    seeds = torch.minimum(torch.clamp(seeds, min=eb), hi)
    pos, subvox, good = localize(log_vol, seeds, real_shape,
                                 float(cfg.max_offset), int(cfg.newton_iters))
    return Anchors(coords=pos, subvox=subvox, values=vals,
                   valid=(vals > cfg.threshold_abs) & good)
