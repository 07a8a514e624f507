"""Separable filters for 3D volumes (port of mad_tpu/ops/convolve.py).

Gaussian smoothing and the simulator's blur (of one volume or a batch)
are 1D convolutions along each axis, and the scale-normalized LoG is three
fused passes, all through kernel K1 (:mod:`mad_tpu_torch.kernels.conv1d`:
``conv1d_along`` and ``log_gauss``); the x2 Catmull-Rom upsampling,
``upsample2``, is kernel K2's wrapper (:mod:`mad_tpu_torch.kernels.upsample`,
all three axes in one launch).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.conv1d import conv1d_along, log_gauss
from ..kernels.upsample import upsample2  # noqa: F401  (K2)


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
    """Apply (kx, ky, kz) 1D kernels along spatial axes 0, 1, 2 of a volume
    or of a (B, X, Y, Z) batch (three launches for the whole batch)."""
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
    (parity: mad/MapSpace.py:169-182); the sums and their order are those
    of mad_tpu/ops/convolve.py:152-162, in K1's three fused passes on the
    card. The volume is handed over, so that it is freed once the first
    pass has read it unless the caller keeps it."""
    g0 = gaussian_kernel1d(sigma, 0, truncate)
    g2 = gaussian_kernel1d(sigma, 2, truncate)
    held = [vol]
    del vol
    return log_gauss(held, g0, g2, sigma)
