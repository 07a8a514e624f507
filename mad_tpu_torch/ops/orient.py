"""Canonical orientation assignment (port of mad_tpu/ops/orient.py).

Reference semantics (mad/Orientator.py:68-343), as in the JAX original:
  * gradient patch of (2r+1)^3 samples around each anchor, stride 1 on the
    base octave, stride 2 on the upsampled octave;
  * spherical corner mask (radius * 1.05), samples with |g| < cutoff drop;
  * 112-zone histogram of gradient directions with the reference's strict
    4-decimal zone bounds, quantized to int(count / max * 50);
  * dominant bins: quantized count > 0.8 * max, anchor rejected if more
    than max_main;
  * per dominant bin: rotate its centre to +z, re-histogram, secondary bins
    from zones 1..N-2 renormalized and thresholded the same way;
  * per (main, sec): R_final = Rz(-(theta_c(sec) - theta_first(belt))) @ R_main.

Anchors run in chunks as batched tensor ops; every (anchor, main, sec)
triple is a lane of a (K, M, S) frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import OrientConfig
from ..core.eqsp import EQSPSphere, get_eqsp
from ..core.geometry import norm3, rotation_about_z, spherical_angles

TWO_PI = 2.0 * math.pi


def ref_zone_bounds(eqsp: EQSPSphere) -> np.ndarray:
    """Zone bounds [theta_min, phi_min, theta_max, phi_max] rounded to four
    decimals, the precision of the reference's shipped tables."""
    return np.round(eqsp.bounds, 4).astype(np.float32)


def zone_mask(dirs: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(..., Z) bool: direction inside zone z by the reference's strict
    bounds on theta (or theta + 2pi) and phi (mad/Orientator.py:323-335)."""
    theta, phi = spherical_angles(dirs)
    sth = theta + TWO_PI
    t, s, p = theta[..., None], sth[..., None], phi[..., None]
    b = bounds
    return ((((t > b[:, 0]) & (t < b[:, 2])) | ((s > b[:, 0]) & (s < b[:, 2])))
            & (p > b[:, 1]) & (p < b[:, 3]))


def zone_hist(dirs: torch.Tensor, w: torch.Tensor, bounds: torch.Tensor
              ) -> torch.Tensor:
    """counts[..., z] = sum over samples of w where the direction is in z.

    dirs (..., P, 3), w (..., P) -> (..., Z). A direction may fall in
    several zones or none, as in the reference."""
    m = zone_mask(dirs, bounds).to(w.dtype)
    lead = dirs.shape[:-2]
    P, Z = m.shape[-2], m.shape[-1]
    out = torch.bmm(w.reshape(-1, 1, P), m.reshape(-1, P, Z))
    return out.reshape(lead + (Z,))


def zone_assign(dirs: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(...,) int64 zone per direction with the reference *descriptor*
    semantics (mad/Descriptor.py:173-190): the LAST matching zone wins,
    unmatched directions fall to zone 0."""
    zidx = torch.arange(bounds.shape[0], device=dirs.device)
    zid = torch.where(zone_mask(dirs, bounds), zidx,
                      torch.full_like(zidx, -1)).amax(dim=-1)
    return torch.clamp(zid, min=0)


def zone_assign_fn(eqsp: EQSPSphere, device):
    """zone_assign with the 4-decimal bounds of ``eqsp`` on ``device``."""
    b = torch.as_tensor(ref_zone_bounds(eqsp), device=device)
    return lambda dirs: zone_assign(dirs, b)


def _quantize(counts: torch.Tensor) -> torch.Tensor:
    """int32(count / max * 50), max-safe (mad/Orientator.py:340)."""
    m = counts.amax(dim=-1, keepdim=True)
    return (counts / torch.clamp(m, min=1e-30) * 50.0).to(torch.int32)


def _first_k_flagged(flag: torch.Tensor, k: int):
    """Indices of the first k true entries along the last axis (ascending,
    padded with the false ones), plus the count of true entries."""
    order = torch.sort((~flag).to(torch.int8), dim=-1, stable=True).indices
    return order[..., :k], flag.sum(dim=-1)


def _ref_rotation_to_pole(theta: float, phi: float) -> np.ndarray:
    """Float64 rotation taking the (theta, phi) zone centre to +z, exactly
    as the reference computes it (mad/Orientator.py:197-203)."""
    c = np.array([np.sin(phi) * np.cos(theta),
                  np.sin(phi) * np.sin(theta), np.cos(phi)])
    angle = np.arccos(np.clip(c[2], -1.0, 1.0))
    ax = np.cross(c, [0.0, 0.0, 1.0])
    n = np.linalg.norm(ax)
    ax = ax / n if n > 0 else np.array([0.0, 1.0, 0.0])
    a = np.cos(angle / 2.0)
    b, cc, d = -ax * np.sin(angle / 2.0)
    return np.array([
        [a * a + b * b - cc * cc - d * d, 2 * (b * cc + a * d),
         2 * (b * d - a * cc)],
        [2 * (b * cc - a * d), a * a + cc * cc - b * b - d * d,
         2 * (cc * d + a * b)],
        [2 * (b * d + a * cc), 2 * (cc * d - a * b),
         a * a + d * d - b * b - cc * cc],
    ])


def _sphere_mask(radius: int, gw_sig: float) -> np.ndarray:
    """Corner-removal mask (+ optional Gaussian window),
    parity mad/Orientator.py:37-54."""
    r = np.arange(-radius, radius + 1)
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    sumsq = gx * gx + gy * gy + gz * gz
    mask = (np.sqrt(sumsq) <= radius * 1.05).astype(np.float32)
    if gw_sig:
        mask = mask * np.exp(-sumsq / (2.0 * gw_sig ** 2)).astype(np.float32)
    return mask


def rows_times(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """v @ R over the last two axes, summed over the inner index in order
    (v (..., P, 3), R broadcastable to (..., 3, 3))."""
    return (v[..., 0:1] * R[..., None, 0, :] + v[..., 1:2] * R[..., None, 1, :]
            + v[..., 2:3] * R[..., None, 2, :])


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for batched 3x3 matrices, summed over the inner index in order."""
    return (A[..., :, 0:1] * B[..., None, 0, :] + A[..., :, 1:2] * B[..., None, 1, :]
            + A[..., :, 2:3] * B[..., None, 2, :])


class _OrientTables:
    """Host-built constants of one (eqsp size, radius, stride) setting."""

    def __init__(self, cfg: OrientConfig, radius: int, stride: int, device):
        eqsp = get_eqsp(cfg.eqsp_size)
        self.bounds = torch.as_tensor(ref_zone_bounds(eqsp), device=device)
        self.mask = torch.as_tensor(
            _sphere_mask(radius, cfg.gw_sig).reshape(-1), device=device)
        offs = np.arange(-radius, radius + 1) * stride
        ox, oy, oz = np.meshgrid(offs, offs, offs, indexing="ij")
        self.offsets = torch.as_tensor(
            np.stack([ox, oy, oz], axis=-1).reshape(-1, 3), dtype=torch.int64,
            device=device)
        # Main-bin rotations in float64 with the reference recipe on the
        # 4-decimal polar centres its tables ship (the south cap resolves
        # to the +y half turn through 3.1416).
        p4 = np.round(eqsp.p_centers, 4)
        rot = np.stack([_ref_rotation_to_pole(t, f) for t, f in p4])
        rot[0] = np.eye(3)                  # the north cap is the pole
        self.rot_to_pole = torch.as_tensor(rot, dtype=torch.float32,
                                           device=device)
        self.p_theta = torch.as_tensor(p4[:, 0], dtype=torch.float32,
                                       device=device)
        self.belt_first = torch.as_tensor(
            np.round(eqsp.belt_first_theta, 4), dtype=torch.float32,
            device=device)


def orient_anchors(grad: torch.Tensor, coords: torch.Tensor,
                   valid: torch.Tensor, real_shape, upsampled: bool,
                   cfg: OrientConfig, chunk: int = 32):
    """Canonical frames for K anchors of one octave.

    grad: (X, Y, Z, 3) gradient field; coords: (K, 3) int64 voxel coords;
    valid: (K,) bool. Returns (main_bin (K, M) int32, sec_bin (K, M, S)
    int32, rfinal (K, M, S, 3, 3) float32, valid (K, M, S) bool)."""
    dev = grad.device
    radius = (cfg.patch_size - cfg.patch_size % 2) // 2
    stride = 2 if upsampled else 1
    M, S = cfg.max_main, cfg.max_sec
    tab = _OrientTables(cfg, radius, stride, dev)
    rs = torch.as_tensor(real_shape, device=dev)
    half = radius * stride
    K = coords.shape[0]
    mains_o = torch.zeros((K, M), dtype=torch.int32, device=dev)
    secs_o = torch.zeros((K, M, S), dtype=torch.int32, device=dev)
    rfin_o = torch.zeros((K, M, S, 3, 3), dtype=torch.float32, device=dev)
    ok_o = torch.zeros((K, M, S), dtype=torch.bool, device=dev)
    ar_m = torch.arange(M, device=dev)
    ar_s = torch.arange(S, device=dev)
    for s0 in range(0, K, chunk):
        coord = coords[s0:s0 + chunk]
        n = coord.shape[0]
        # Border rejection: the upper bound is conservative by one voxel
        # (mad/Orientator.py:127-155).
        ok = (valid[s0:s0 + chunk] & (coord - half >= 0).all(dim=1)
              & (coord + half + 1 <= rs - 1).all(dim=1))
        safe = torch.minimum(torch.clamp(coord, min=half),
                             torch.clamp(rs - half - 1, min=half))
        pts = safe[:, None, :] + tab.offsets[None]               # (n, P, 3)
        g = grad[pts[..., 0], pts[..., 1], pts[..., 2]].to(torch.float32)
        magn = norm3(g)
        dirs = g / torch.clamp(magn, min=1e-30)[..., None]
        w = tab.mask[None] * (magn >= cfg.cutoff_magn).to(torch.float32)

        q0 = _quantize(zone_hist(dirs, w, tab.bounds))           # (n, Z)
        q0max = q0.amax(dim=-1, keepdim=True)
        flag0 = q0 > q0max * 0.8
        main_idx, n_main = _first_k_flagged(flag0, M)            # (n, M)
        ok = ok & (n_main >= 1) & (n_main <= M) & (q0max[:, 0] > 0)

        Rm = tab.rot_to_pole[main_idx]                           # (n, M, 3, 3)
        rot_dirs = rows_times(dirs[:, None], Rm.transpose(-1, -2))
        q1 = _quantize(zone_hist(rot_dirs, w[:, None].expand(-1, M, -1),
                                 tab.bounds))                    # (n, M, Z)
        not_pole = q1[..., 1:-1]
        m1 = not_pole.amax(dim=-1, keepdim=True)
        nq = (not_pole.to(torch.float32)
              / torch.clamp(m1, min=1).to(torch.float32) * 50.0
              ).to(torch.int32)
        flag1 = (nq > nq.amax(dim=-1, keepdim=True) * 0.8) & (m1 > 0)
        sec_idx, n_sec = _first_k_flagged(flag1, S)              # (n, M, S)
        sec_bins = sec_idx.to(torch.int64) + 1
        main_ok = (m1[..., 0] > 0) & (n_sec >= 1) & (n_sec <= S)
        ftheta = -(tab.p_theta[sec_bins] - tab.belt_first[sec_bins])
        Rz = rotation_about_z(ftheta)                            # (n, M, S, 3, 3)
        rfin = matmul3(Rz, Rm[:, :, None])
        sub_ok = main_ok[..., None] & (ar_s < n_sec[..., None])
        lane_ok = (ok[:, None, None] & (ar_m < n_main[:, None])[..., None]
                   & sub_ok)
        mains_o[s0:s0 + n] = main_idx.to(torch.int32)
        secs_o[s0:s0 + n] = sec_bins.to(torch.int32)
        rfin_o[s0:s0 + n] = rfin
        ok_o[s0:s0 + n] = lane_ok
    return mains_o, secs_o, rfin_o, ok_o
