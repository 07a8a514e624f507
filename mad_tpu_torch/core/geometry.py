"""Rotation / rigid-transform primitives on torch tensors, batched over
leading dimensions (port of mad_tpu/core/geometry.py); ``kabsch_np`` is a
numpy copy of the original.

Elementwise arithmetic follows the JAX originals term for term, so the
same float32 inputs round the same way on the CPU.
"""

from __future__ import annotations

import math

import torch

from ..device import resolve


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of size 3, summed left to right."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def unit(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Normalize along the last axis; zero vectors pass through unchanged
    (parity with mad/math_utils.py:5-13)."""
    n = norm3(v)[..., None]
    ok = n > eps
    return torch.where(ok, v / torch.where(ok, n, torch.ones_like(n)), v)


def axis_angle_mat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Euler-Rodrigues rotation matrix, batched over leading dims, with the
    reference sign convention (mad/math_utils.py:15-27): the quaternion
    vector part is ``-axis * sin(angle/2)``."""
    a = torch.cos(angle / 2.0)[..., None]
    bcd = -axis * torch.sin(angle / 2.0)[..., None]
    b, c, d = bcd[..., 0:1], bcd[..., 1:2], bcd[..., 2:3]
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    row0 = torch.cat([aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)], -1)
    row1 = torch.cat([2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)], -1)
    row2 = torch.cat([2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_to_pole(v: torch.Tensor) -> torch.Tensor:
    """Rotation matrix taking unit vector(s) v to +z; for v at -z the half
    turn is about +y (mad/Orientator.py:197-203)."""
    angle = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    ax = torch.linalg.cross(v, z, dim=-1)
    n = norm3(ax)[..., None]
    fallback = torch.zeros_like(v)
    fallback[..., 1] = 1.0
    ok = n > 1e-12
    ax = torch.where(ok, ax / torch.where(ok, n, torch.ones_like(n)),
                     fallback)
    return axis_angle_mat(ax, angle)


def rotation_about_z(angle: torch.Tensor) -> torch.Tensor:
    z = torch.zeros(angle.shape + (3,), dtype=angle.dtype,
                    device=angle.device)
    z[..., 2] = 1.0
    return axis_angle_mat(z, angle)


def kabsch(mobile: torch.Tensor, reference: torch.Tensor):
    """Optimal rigid transform: returns (R, T) with reference ~ mobile @ R + T.

    Matches the application convention of mad/math_utils.py:29-53
    (``T = av2 - av1 @ R``, points transform as ``x @ R + T``).
    Batched over leading dims.
    """
    av1 = torch.mean(mobile, dim=-2, keepdim=True)
    av2 = torch.mean(reference, dim=-2, keepdim=True)
    m = mobile - av1
    r = reference - av2
    a = m.transpose(-1, -2) @ r
    u, _, vt = torch.linalg.svd(a)
    det = torch.linalg.det(vt.transpose(-1, -2) @ u.transpose(-1, -2))
    flip = torch.stack([torch.ones_like(det), torch.ones_like(det), det],
                       dim=-1)[..., :, None]
    vt = vt * flip
    R = (vt.transpose(-1, -2) @ u.transpose(-1, -2)).transpose(-1, -2)
    T = av2[..., 0, :] - (av1 @ R)[..., 0, :]
    return R, T


def kabsch_np(mobile: "np.ndarray", reference: "np.ndarray"):
    """Copied from mad_tpu/core/geometry.py (``kabsch_np``, numpy): the
    host twin of :func:`kabsch` (same convention)."""
    import numpy as np
    av1 = np.mean(mobile, axis=-2, keepdims=True)
    av2 = np.mean(reference, axis=-2, keepdims=True)
    m = mobile - av1
    r = reference - av2
    a = np.swapaxes(m, -1, -2) @ r
    u, _, vt = np.linalg.svd(a)
    det = np.linalg.det(np.swapaxes(vt, -1, -2) @ np.swapaxes(u, -1, -2))
    flip = np.stack(
        [np.ones_like(det), np.ones_like(det), det], axis=-1
    )[..., :, None]
    vt = vt * flip
    R = np.swapaxes(np.swapaxes(vt, -1, -2) @ np.swapaxes(u, -1, -2), -1, -2)
    T = av2[..., 0, :] - (av1 @ R)[..., 0, :]
    return R, T


def rmsd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-atom RMSD along the last two axes (parity mad/PDB.py:115-117)."""
    d = torch.sum(torch.square(a - b), dim=(-1, -2)) / a.shape[-2]
    return torch.sqrt(d)


def random_rotation(generator: torch.Generator, device=None
                    ) -> torch.Tensor:
    """Uniform random rotation matrix (for tests / decoy transforms), from
    a unit quaternion of four normal draws of ``generator``, on ``device``
    (the card unless named). mad_tpu draws from a ``jax.random`` key, so
    the two never give the same matrix for a seed."""
    q = torch.randn(4, generator=generator, dtype=torch.float32,
                    device=generator.device)
    q = q / torch.linalg.norm(q)
    w, x, y, z = q
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)]),
    ])
    return R.to(resolve(device))


def apply_rigid(coords: torch.Tensor, R: torch.Tensor, T: torch.Tensor
                ) -> torch.Tensor:
    """coords @ R + T with broadcasting over leading batch dims."""
    return coords @ R + T[..., None, :]


def rows_times(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """v @ R over the last two axes, summed over the inner index in order
    (v (..., P, 3), R broadcastable to (..., 3, 3))."""
    return (v[..., 0:1] * R[..., None, 0, :] + v[..., 1:2] * R[..., None, 1, :]
            + v[..., 2:3] * R[..., None, 2, :])


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for batched 3x3 matrices, summed over the inner index in order."""
    return (A[..., :, 0:1] * B[..., None, 0, :]
            + A[..., :, 1:2] * B[..., None, 1, :]
            + A[..., :, 2:3] * B[..., None, 2, :])


def spherical_angles(vecs: torch.Tensor):
    """(theta in [0, 2pi), phi in [0, pi]) of vectors, reference convention
    (mad/Orientator.py:305-321)."""
    theta = torch.atan2(vecs[..., 1], vecs[..., 0])
    theta = torch.where(theta < 0, theta + 2.0 * math.pi, theta)
    phi = torch.arccos(torch.clamp(vecs[..., 2], -1.0, 1.0))
    return theta, phi


def zone_mask(dirs: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(..., Z) bool: direction inside zone z by the reference's strict
    bounds [theta_min, phi_min, theta_max, phi_max] on theta (or
    theta + 2pi) and phi (mad/Orientator.py:323-335)."""
    theta, phi = spherical_angles(dirs)
    sth = theta + 2.0 * math.pi
    t, s, p = theta[..., None], sth[..., None], phi[..., None]
    b = bounds
    return ((((t > b[:, 0]) & (t < b[:, 2])) | ((s > b[:, 0]) & (s < b[:, 2])))
            & (p > b[:, 1]) & (p < b[:, 3]))


def zone_assign(dirs: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(...,) int64 zone per direction with the reference *descriptor*
    semantics (mad/Descriptor.py:173-190): the LAST matching zone wins,
    unmatched directions fall to zone 0."""
    zidx = torch.arange(bounds.shape[0], device=dirs.device)
    zid = torch.where(zone_mask(dirs, bounds), zidx,
                      torch.full_like(zidx, -1)).amax(dim=-1)
    return torch.clamp(zid, min=0)
