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

Every (anchor, main, sec) triple is a lane of a (K, M, S) frame. The
per-anchor work is kernel K6 (:mod:`mad_tpu_torch.kernels.orient`).

Capacity mode (a mesh; mad_tpu's ``orient_shard``, ops/orient.py:356-424):
the gradient field arrives as x-slabs. Each shard orients the anchors whose
x lies in its slab, with K6 gathering from the shard's block of the
field, extended by radius * stride * 2 rows of its neighbours (built once
per octave for orientation and descriptors,
``parallel.volume.sharded_gradient``); the frames go back to the anchors'
slots on the mesh's first device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import OrientConfig
from ..core.eqsp import EQSPSphere, get_eqsp
from ..core.geometry import zone_assign
from ..kernels import orient as k6
from ..parallel.volume import check_halo, map_owned


def ref_zone_bounds(eqsp: EQSPSphere) -> np.ndarray:
    """Zone bounds [theta_min, phi_min, theta_max, phi_max] rounded to four
    decimals, the precision of the reference's shipped tables."""
    return np.round(eqsp.bounds, 4).astype(np.float32)


def zone_assign_fn(eqsp: EQSPSphere, device):
    """zone_assign with the 4-decimal bounds of ``eqsp`` on ``device``."""
    b = torch.as_tensor(ref_zone_bounds(eqsp), device=device)
    return lambda dirs: zone_assign(dirs, b)


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


class _OrientTables:
    """Host-built constants of one (eqsp size, radius, stride) setting."""

    def __init__(self, cfg: OrientConfig, radius: int, stride: int, device):
        eqsp = get_eqsp(cfg.eqsp_size)
        bounds = ref_zone_bounds(eqsp)
        self.bounds = torch.as_tensor(bounds, device=device)
        # K6's zone lookup (kernels/orient.zone_table)
        self.zone_edges, self.zone_start, self.zone_cands = (
            torch.as_tensor(a, device=device) for a in k6.zone_table(bounds))
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


@functools.lru_cache(maxsize=None)
def orient_tables(cfg: OrientConfig, radius: int, stride: int, device
                  ) -> _OrientTables:
    """The tables of one setting on one device, built once (a build runs
    112 float64 rotations through a Python loop and makes eight uploads;
    a fit orients two octaves of each map and subunit). Never written: K6
    and its plain version only read them."""
    return _OrientTables(cfg, radius, stride, device)


def orient_anchors(grad, coords: torch.Tensor, valid: torch.Tensor,
                   real_shape, upsampled: bool, cfg: OrientConfig,
                   chunk: int = 32, mesh=None):
    """Canonical frames for K anchors of one octave.

    grad: (X, Y, Z, 3) gradient field (with a mesh, its
    ``parallel.volume.Blocks``); coords: (K, 3) int64 voxel coords; valid:
    (K,) bool. Returns (main_bin (K, M) int32, sec_bin (K, M, S) int32,
    rfinal (K, M, S, 3, 3) float32, valid (K, M, S) bool), on the device of
    ``coords``."""
    radius = (cfg.patch_size - cfg.patch_size % 2) // 2
    stride = 2 if upsampled else 1
    params = (radius, stride, cfg.max_main, cfg.max_sec, cfg.cutoff_magn,
              chunk)
    if mesh is None:
        tab = orient_tables(cfg, radius, stride, grad.device)
        return k6.orient(grad, coords, valid, real_shape, tab, *params)
    check_halo(grad, radius * stride * 2, "orient_anchors")

    def shard(blk, lo, c, v):
        return k6.orient(blk, c, v, real_shape,
                         orient_tables(cfg, radius, stride, blk.device),
                         *params, lo)
    return map_owned(grad, shard, coords, valid)
