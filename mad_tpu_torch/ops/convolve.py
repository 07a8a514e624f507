"""Separable filters for 3D volumes (port of mad_tpu/ops/convolve.py).

Gaussian smoothing, the scale-normalized LoG and the simulator's blur are
1D convolutions along each axis, all through kernel K1
(:mod:`mad_tpu_torch.kernels.conv1d`); the x2 Catmull-Rom upsampling goes
axis by axis through kernel K2 (:mod:`mad_tpu_torch.kernels.upsample`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.conv1d import conv1d_along
from ..kernels.upsample import upsample_axis


def gaussian_kernel1d(sigma: float, order: int = 0, truncate: float = 4.0
                      ) -> np.ndarray:
    """Gaussian (or Gaussian-derivative) kernel, scipy-compatible
    (radius = int(truncate*sigma + 0.5); copied from the JAX original)."""
    radius = int(truncate * float(sigma) + 0.5)
    sigma2 = float(sigma) ** 2
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / sigma2 * x ** 2)
    phi /= phi.sum()
    if order == 0:
        return phi.astype(np.float32)
    expo = np.arange(order + 1)
    q = np.zeros(order + 1)
    q[0] = 1
    D = np.diag(expo[1:], 1)
    P = np.diag(np.ones(order) / -sigma2, -1)
    for _ in range(order):
        q = (D + P).dot(q)
    q = (x[:, None] ** expo).dot(q)
    return (q * phi).astype(np.float32)


def separable_conv3d(vol: torch.Tensor, kernels, mode: str = "same"
                     ) -> torch.Tensor:
    """Apply (kx, ky, kz) 1D kernels along axes 0, 1, 2."""
    out = vol
    for axis, kern in enumerate(kernels):
        out = conv1d_along(out, kern, axis, mode=mode)
    return out


def gaussian_filter3d(vol: torch.Tensor, sigma: float, truncate: float = 4.0
                      ) -> torch.Tensor:
    """Separable Gaussian smoothing (zero boundary)."""
    k = gaussian_kernel1d(sigma, 0, truncate)
    return separable_conv3d(vol, (k, k, k))


def log_filter3d(vol: torch.Tensor, sigma: float, truncate: float = 4.0):
    """Scale-normalized negative LoG plus the plain Gaussian, sharing passes.

    Returns (log_response, gauss) with
      log_response = max(0, -sigma^2 * laplacian_of_gaussian(vol))
    (parity: mad/MapSpace.py:169-182); the pass order and the sums are
    those of mad_tpu/ops/convolve.py:152-162."""
    g0 = gaussian_kernel1d(sigma, 0, truncate)
    g2 = gaussian_kernel1d(sigma, 2, truncate)
    ax = conv1d_along(vol, g0, 0)
    axy = conv1d_along(ax, g0, 1)
    gauss = conv1d_along(axy, g0, 2)
    lap = conv1d_along(axy, g2, 2)                           # term_z
    del axy
    term = conv1d_along(conv1d_along(ax, g2, 1), g0, 2)      # term_y
    del ax
    x = conv1d_along(conv1d_along(conv1d_along(vol, g2, 0), g0, 1), g0, 2)
    # lap = term_x + term_y + term_z, summed in that order
    lap = torch.add(x, term).add_(lap)
    del x, term
    log_resp = torch.clamp_(lap.neg_().mul_(sigma ** 2), min=0.0)
    return log_resp, gauss


def upsample2(vol: torch.Tensor) -> torch.Tensor:
    """Separable x2 cubic upsampling: (X,Y,Z) -> (2X-1, 2Y-1, 2Z-1)."""
    out = vol
    for axis in range(3):
        out = upsample_axis(out, axis)
    return out
