"""Rotation / rigid-transform primitives on torch tensors, batched over
leading dimensions (port of mad_tpu/core/geometry.py).

Elementwise arithmetic follows the JAX originals term for term, so the
same float32 inputs round the same way on the CPU.
"""

from __future__ import annotations

import math

import torch


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
