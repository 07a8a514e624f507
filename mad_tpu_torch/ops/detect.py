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
    characteristic-polynomial invariants) are rejected.
The anchor table holds exactly the peaks found (at most ``max_anchors``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import DetectConfig
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


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Cofactor determinant of (..., 3, 3), jnp.linalg.det's 3x3 formula."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _hessian_grad(p: torch.Tensor):
    """Finite-difference Hessian + gradient from (K, 3, 3, 3) patches
    (parity: mad/Detector.py:66-79)."""
    c = p[:, 1, 1, 1]
    xx = p[:, 0, 1, 1] + p[:, 2, 1, 1] - 2 * c
    yy = p[:, 1, 0, 1] + p[:, 1, 2, 1] - 2 * c
    zz = p[:, 1, 1, 0] + p[:, 1, 1, 2] - 2 * c
    xy = 0.25 * ((p[:, 2, 2, 1] - p[:, 2, 0, 1]) - (p[:, 0, 2, 1] - p[:, 0, 0, 1]))
    xz = 0.25 * ((p[:, 2, 1, 2] - p[:, 2, 1, 0]) - (p[:, 0, 1, 2] - p[:, 0, 1, 0]))
    yz = 0.25 * ((p[:, 1, 2, 2] - p[:, 1, 2, 0]) - (p[:, 1, 0, 2] - p[:, 1, 0, 0]))
    H = torch.stack([torch.stack([xx, xy, xz], -1),
                     torch.stack([xy, yy, yz], -1),
                     torch.stack([xz, yz, zz], -1)], -2)
    G = 0.5 * torch.stack([p[:, 2, 1, 1] - p[:, 0, 1, 1],
                           p[:, 1, 2, 1] - p[:, 1, 0, 1],
                           p[:, 1, 1, 2] - p[:, 1, 1, 0]], -1)
    return H, G


def _inv3(H: torch.Tensor):
    """Adjugate-based 3x3 inverse; returns (inv, ok)."""
    det = _det3(H)
    ok = torch.abs(det) > 1e-20
    h = lambda i, j: H[:, i, j]
    adj = torch.stack([
        torch.stack([h(1, 1) * h(2, 2) - h(1, 2) * h(2, 1),
                     h(0, 2) * h(2, 1) - h(0, 1) * h(2, 2),
                     h(0, 1) * h(1, 2) - h(0, 2) * h(1, 1)], -1),
        torch.stack([h(1, 2) * h(2, 0) - h(1, 0) * h(2, 2),
                     h(0, 0) * h(2, 2) - h(0, 2) * h(2, 0),
                     h(0, 2) * h(1, 0) - h(0, 0) * h(1, 2)], -1),
        torch.stack([h(1, 0) * h(2, 1) - h(1, 1) * h(2, 0),
                     h(0, 1) * h(2, 0) - h(0, 0) * h(2, 1),
                     h(0, 0) * h(1, 1) - h(0, 1) * h(1, 0)], -1),
    ], -2)
    return adj / torch.where(ok, det, torch.ones_like(det))[:, None, None], ok


def _neg_semidefinite(H: torch.Tensor) -> torch.Tensor:
    """No positive eigenvalue of symmetric H: trace <= 0, sum of principal
    2x2 minors >= 0, det <= 0 (saddle rejection, mad/Detector.py:103-107)."""
    i1 = H[:, 0, 0] + H[:, 1, 1] + H[:, 2, 2]
    i2 = (H[:, 0, 0] * H[:, 1, 1] - H[:, 0, 1] * H[:, 1, 0]
          + H[:, 0, 0] * H[:, 2, 2] - H[:, 0, 2] * H[:, 2, 0]
          + H[:, 1, 1] * H[:, 2, 2] - H[:, 1, 2] * H[:, 2, 1])
    i3 = _det3(H)
    return (i1 <= 0) & (i2 >= 0) & (i3 <= 0)


_PATCH = torch.stack(torch.meshgrid(
    *([torch.arange(-1, 2)] * 3), indexing="ij"), -1).reshape(27, 3)


def localize(vol: torch.Tensor, seeds: torch.Tensor, real_shape,
             max_offset: float, n_iter: int):
    """Newton walk from each seed (K, 3) int64; returns (coords, subvox,
    accepted & not a saddle)."""
    K = seeds.shape[0]
    dev = vol.device
    rs = torch.as_tensor(real_shape, device=dev)
    patch_off = _PATCH.to(dev)
    pos = seeds.clone()
    offset = torch.zeros((K, 3), dtype=vol.dtype, device=dev)
    H = torch.zeros((K, 3, 3), dtype=vol.dtype, device=dev)
    accepted = torch.zeros(K, dtype=torch.bool, device=dev)
    bad = torch.zeros(K, dtype=torch.bool, device=dev)
    for _ in range(n_iter):
        p = pos[:, None, :] + patch_off[None]
        patch = vol[p[..., 0], p[..., 1], p[..., 2]].reshape(K, 3, 3, 3)
        Hn, G = _hessian_grad(patch)
        Hinv, ok = _inv3(Hn)
        off = -(Hinv[..., 0] * G[:, 0:1] + Hinv[..., 1] * G[:, 1:2]
                + Hinv[..., 2] * G[:, 2:3])
        acc_now = (torch.abs(off) < max_offset).all(dim=1) & ok
        # Voxel walk toward the offset, clamped to the interior
        # (mad/Detector.py:92-97; bounds use the real extent).
        lo_ok = pos - 1 > 0
        hi_ok = pos + 1 < rs - 1
        step = (((off < -max_offset) & lo_ok).to(pos.dtype) * -1
                + ((off > max_offset) & hi_ok).to(pos.dtype))
        frozen = accepted | bad
        pos = torch.where((frozen | acc_now)[:, None], pos, pos + step)
        offset = torch.where(frozen[:, None], offset, off)
        H = torch.where(frozen[:, None, None], H, Hn)
        accepted, bad = accepted | (acc_now & ~bad), bad | (~ok & ~accepted)
    good = accepted & _neg_semidefinite(H)
    return pos, pos.to(vol.dtype) + offset, good


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
