"""Plain PyTorch descriptor chain: density grid -> anchors, frames, rows.

The method of the reference (mad/MapSpace.py, Detector.py, Orientator.py,
Descriptor.py, MaD.py:358-368) as plain tensor operations, frozen from the
port's plain versions so that it does not move with the program:

1. scale space: the map zero-padded by ``map_padding``; an x2 Catmull-Rom
   upsampled octave presmoothed by a Gaussian, then the base octave; each
   octave's scale-normalized negative LoG (clamped at 0) and the gradient
   of its Gaussian-smoothed volume (bfloat16 above 250 M octave voxels, as
   the method stores it);
2. anchors: voxels equal to their 3x3x3 maximum, above the threshold,
   ``exclude_border`` inside the octave, the top ``max_anchors`` by
   response (ties by flat index); Newton subvoxel walks with saddle
   rejection;
3. frames: the 112-zone histogram of gradient directions about each
   anchor, dominant and secondary bins, one frame a (main, sec) lane;
4. rows: per lane the 16^3 lattice rotated into the frame, sampled by
   nearest neighbour, binned into 64 subregions x 16 zones (int16
   counts); the first ``max_descriptors`` valid lanes of an octave kept.

``dtype``: the type the volumes are computed in (float32, or bfloat16 for
the control).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import eqsp, sim

BF16_VOXELS = 250_000_000


# -- geometry -------------------------------------------------------------

def norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def axis_angle_mat(axis, angle):
    a = torch.cos(angle / 2.0)[..., None]
    bcd = -axis * torch.sin(angle / 2.0)[..., None]
    b, c, d = bcd[..., 0:1], bcd[..., 1:2], bcd[..., 2:3]
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    row0 = torch.cat([aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)], -1)
    row1 = torch.cat([2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)], -1)
    row2 = torch.cat([2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_about_z(angle):
    z = torch.zeros(angle.shape + (3,), dtype=angle.dtype,
                    device=angle.device)
    z[..., 2] = 1.0
    return axis_angle_mat(z, angle)


def rows_times(v, R):
    return (v[..., 0:1] * R[..., None, 0, :] + v[..., 1:2] * R[..., None, 1, :]
            + v[..., 2:3] * R[..., None, 2, :])


def matmul3(A, B):
    return (A[..., :, 0:1] * B[..., None, 0, :]
            + A[..., :, 1:2] * B[..., None, 1, :]
            + A[..., :, 2:3] * B[..., None, 2, :])


def zone_mask(dirs, bounds):
    """(..., Z): direction strictly inside zone z (theta or theta + 2 pi)."""
    theta = torch.atan2(dirs[..., 1], dirs[..., 0])
    theta = torch.where(theta < 0, theta + 2.0 * math.pi, theta)
    phi = torch.arccos(torch.clamp(dirs[..., 2], -1.0, 1.0))
    sth = theta + 2.0 * math.pi
    t, s, p = theta[..., None], sth[..., None], phi[..., None]
    b = bounds
    return ((((t > b[:, 0]) & (t < b[:, 2])) | ((s > b[:, 0]) & (s < b[:, 2])))
            & (p > b[:, 1]) & (p < b[:, 3]))


def zone_assign(dirs, bounds):
    """The last matching zone; unmatched directions fall to zone 0."""
    zidx = torch.arange(bounds.shape[0], device=dirs.device)
    zid = torch.where(zone_mask(dirs, bounds), zidx,
                      torch.full_like(zidx, -1)).amax(dim=-1)
    return torch.clamp(zid, min=0)


def zone_bounds(size: int) -> np.ndarray:
    """Zone bounds rounded to the four decimals of the reference's
    shipped tables."""
    return np.round(eqsp.sphere(size)[0], 4).astype(np.float32)


# -- scale space ----------------------------------------------------------

def gaussian_kernel1d(sigma: float, order: int = 0, truncate: float = 4.0):
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


def conv_same(vol, kernel, axis: int):
    """'same' shift-and-add convolution along ``axis``, zero taps skipped."""
    k = np.asarray(kernel, dtype=np.float32)
    ksz = k.shape[0]
    n = vol.shape[axis]
    lo = ksz // 2
    shape = list(vol.shape)
    shape[axis] = n + ksz - 1
    padded = vol.new_zeros(shape)
    padded.narrow(axis, lo, n).copy_(vol)
    out = None
    for m in range(ksz):
        w = float(k[ksz - 1 - m])
        if w == 0.0:
            continue
        term = padded.narrow(axis, m, n) * w
        out = term if out is None else out + term
    return out


CR_HALF = np.array([-1.0 / 16, 9.0 / 16, 9.0 / 16, -1.0 / 16],
                   dtype=np.float32)


def upsample2(vol):
    """(X, Y, Z) -> (2X-1, 2Y-1, 2Z-1): originals on even indices,
    Catmull-Rom half samples with edges replicated on odd ones."""
    for axis in range(3):
        n = vol.shape[axis]
        padded = torch.cat([vol.narrow(axis, 0, 1), vol,
                            vol.narrow(axis, n - 1, 1)], dim=axis)
        half = None
        for m in range(4):
            term = padded.narrow(axis, m, n - 1) * float(CR_HALF[3 - m])
            half = term if half is None else half.add_(term)
        shape = list(vol.shape)
        shape[axis] = 2 * n - 1
        out = vol.new_empty(shape)
        idx = [slice(None)] * 3
        idx[axis] = slice(0, None, 2)
        out[tuple(idx)] = vol
        idx[axis] = slice(1, None, 2)
        out[tuple(idx)] = half
        vol = out
    return vol


def log_gauss(vol, sigma: float, truncate: float):
    """(max(0, -sigma^2 LoG(vol)), Gaussian(vol)): the nine shift-adds,
    the Laplacian summed x, y, z."""
    g0 = gaussian_kernel1d(sigma, 0, truncate)
    g2 = gaussian_kernel1d(sigma, 2, truncate)
    c = conv_same
    ax = c(vol, g0, 0)
    axy = c(ax, g0, 1)
    gauss = c(axy, g0, 2)
    lap_z = c(axy, g2, 2)
    del axy
    lap_y = c(c(ax, g2, 1), g0, 2)
    del ax
    lap_x = c(c(c(vol, g2, 0), g0, 1), g0, 2)
    lap = torch.add(lap_x, lap_y).add_(lap_z)
    del lap_x, lap_y, lap_z
    return torch.clamp_(lap.neg_().mul_(sigma ** 2), min=0.0), gauss


def gradient(vol, dtype):
    """Central differences, one-sided at the edges, stored in ``dtype``."""
    out = torch.empty(vol.shape + (3,), dtype=dtype, device=vol.device)
    for a in range(3):
        n = vol.shape[a]
        o = out[..., a]
        o.narrow(a, 1, n - 2).copy_(
            (vol.narrow(a, 2, n - 2) - vol.narrow(a, 0, n - 2)) * 0.5)
        o.narrow(a, 0, 1).copy_(vol.narrow(a, 1, 1) - vol.narrow(a, 0, 1))
        o.narrow(a, n - 1, 1).copy_(vol.narrow(a, n - 1, 1)
                                    - vol.narrow(a, n - 2, 1))
    return out


# -- anchors --------------------------------------------------------------

_LOW = 0xFFFFFFFF
_SIGN = 0x80000000


def _value_keys(vals):
    """Keys whose ascending order is the values' descending order, +0.0
    above -0.0 (a total order of the float's bits)."""
    bits = vals.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & _LOW
    up = torch.where(bits >= _SIGN, _LOW - bits, bits | _SIGN)
    return (_SIGN - 1) - up


def peaks(vol, real_shape, threshold: float, border: int, capacity: int):
    """Top ``capacity`` voxels equal to their 3x3x3 max and above the
    threshold, ``border`` inside: (values, flat indices), by (-value,
    index)."""
    pooled = F.max_pool3d(vol[None, None], 3, stride=1, padding=1)[0, 0]
    inside = None
    for a in range(3):
        r = torch.arange(vol.shape[a], device=vol.device)
        m = (r >= border) & (r < real_shape[a] - border)
        m = m.reshape([-1 if b == a else 1 for b in range(3)])
        inside = m if inside is None else inside & m
    is_peak = (vol >= pooled) & (vol > threshold) & inside
    idx = torch.nonzero(is_peak.reshape(-1)).reshape(-1)
    vals = vol.reshape(-1)[idx]
    idx, perm = torch.sort(idx, stable=True)
    vals = vals[perm]
    _, perm = torch.sort(_value_keys(vals), stable=True)
    return vals[perm][:capacity], idx[perm][:capacity]


def _det3(a):
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _hessian_grad(p):
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


def _inv3(H):
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


def _neg_semidefinite(H):
    i1 = H[:, 0, 0] + H[:, 1, 1] + H[:, 2, 2]
    i2 = (H[:, 0, 0] * H[:, 1, 1] - H[:, 0, 1] * H[:, 1, 0]
          + H[:, 0, 0] * H[:, 2, 2] - H[:, 0, 2] * H[:, 2, 0]
          + H[:, 1, 1] * H[:, 2, 2] - H[:, 1, 2] * H[:, 2, 1])
    return (i1 <= 0) & (i2 >= 0) & (_det3(H) <= 0)


_PATCH = torch.stack(torch.meshgrid(*([torch.arange(3)] * 3),
                                    indexing="ij"), -1).reshape(27, 3)


def _patch_index(pos, shape):
    """The 3x3x3 patch about each position: start pos - 1, wrapped by the
    extent when negative, clamped to [0, n - 3]."""
    n = torch.as_tensor([int(e) for e in shape], device=pos.device)
    start = pos - 1
    start = torch.where(start < 0, start + n, start)
    start = torch.minimum(torch.clamp(start, min=0), n - 3)
    return start[:, None, :] + _PATCH.to(pos.device)[None]


def localize(vol, seeds, real_shape, max_offset: float, n_iter: int):
    """Newton walk from each seed: (coords, subvox, accepted & not a
    saddle)."""
    K = seeds.shape[0]
    dev = vol.device
    rs = torch.as_tensor(real_shape, device=dev)
    pos = seeds.clone()
    offset = torch.zeros((K, 3), dtype=vol.dtype, device=dev)
    H = torch.zeros((K, 3, 3), dtype=vol.dtype, device=dev)
    accepted = torch.zeros(K, dtype=torch.bool, device=dev)
    bad = torch.zeros(K, dtype=torch.bool, device=dev)
    for _ in range(n_iter):
        p = _patch_index(pos, vol.shape)
        patch = vol[p[..., 0], p[..., 1], p[..., 2]].reshape(K, 3, 3, 3)
        Hn, G = _hessian_grad(patch)
        Hinv, ok = _inv3(Hn)
        off = -(Hinv[..., 0] * G[:, 0:1] + Hinv[..., 1] * G[:, 1:2]
                + Hinv[..., 2] * G[:, 2:3])
        acc_now = (torch.abs(off) < max_offset).all(dim=1) & ok
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


def detect(log_vol, real_shape, cfg: dict):
    eb, thr = int(cfg["exclude_border"]), float(cfg["threshold_abs"])
    vals, flat = peaks(log_vol, real_shape, thr, eb, int(cfg["max_anchors"]))
    shape = log_vol.shape
    seeds = torch.stack([flat // (shape[1] * shape[2]),
                         (flat // shape[2]) % shape[1], flat % shape[2]], -1)
    hi = torch.as_tensor(np.asarray(real_shape) - eb - 1, device=seeds.device)
    seeds = torch.minimum(torch.clamp(seeds, min=eb), hi)
    pos, subvox, good = localize(log_vol, seeds, real_shape,
                                 float(cfg["max_offset"]),
                                 int(cfg["newton_iters"]))
    return pos, subvox, (vals > thr) & good


# -- frames ---------------------------------------------------------------

def _rotation_to_pole(theta: float, phi: float) -> np.ndarray:
    """Float64 rotation taking the (theta, phi) zone centre to +z
    (mad/Orientator.py:197-203)."""
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


class _OrientTables:
    def __init__(self, size: int, radius: int, stride: int, gw_sig: float,
                 device):
        _b, centres, first = eqsp.sphere(size)
        self.bounds = torch.as_tensor(zone_bounds(size), device=device)
        r = np.arange(-radius, radius + 1)
        gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
        sumsq = gx * gx + gy * gy + gz * gz
        mask = (np.sqrt(sumsq) <= radius * 1.05).astype(np.float32)
        if gw_sig:
            mask = mask * np.exp(-sumsq / (2.0 * gw_sig ** 2)).astype(
                np.float32)
        self.mask = torch.as_tensor(mask.reshape(-1), device=device)
        offs = np.arange(-radius, radius + 1) * stride
        ox, oy, oz = np.meshgrid(offs, offs, offs, indexing="ij")
        self.offsets = torch.as_tensor(
            np.stack([ox, oy, oz], axis=-1).reshape(-1, 3),
            dtype=torch.int64, device=device)
        p4 = np.round(centres, 4)
        rot = np.stack([_rotation_to_pole(t, f) for t, f in p4])
        rot[0] = np.eye(3)
        self.rot_to_pole = torch.as_tensor(rot, dtype=torch.float32,
                                           device=device)
        self.p_theta = torch.as_tensor(p4[:, 0], dtype=torch.float32,
                                       device=device)
        self.belt_first = torch.as_tensor(np.round(first, 4),
                                          dtype=torch.float32, device=device)


def _zone_hist(dirs, w, bounds):
    m = zone_mask(dirs, bounds).to(w.dtype)
    lead = dirs.shape[:-2]
    P, Z = m.shape[-2], m.shape[-1]
    out = torch.bmm(w.reshape(-1, 1, P), m.reshape(-1, P, Z))
    return out.reshape(lead + (Z,))


def _quantize(counts):
    m = counts.amax(dim=-1, keepdim=True)
    return (counts / torch.clamp(m, min=1e-30) * 50.0).to(torch.int32)


def _first_k_flagged(flag, k: int):
    order = torch.sort((~flag).to(torch.int8), dim=-1, stable=True).indices
    return order[..., :k], flag.sum(dim=-1)


def orient(grad, coords, real_shape, tab, radius: int, stride: int,
           M: int, S: int, cutoff: float, chunk: int = 32):
    """(main (K, M), sec (K, M, S), frames (K, M, S, 3, 3), ok (K, M, S))."""
    dev = grad.device
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
        ok = ((coord - half >= 0).all(dim=1)
              & (coord + half + 1 <= rs - 1).all(dim=1))
        safe = torch.minimum(torch.clamp(coord, min=half),
                             torch.clamp(rs - half - 1, min=half))
        pts = safe[:, None, :] + tab.offsets[None]
        px = torch.clamp(pts[..., 0], 0, grad.shape[0] - 1)
        g = grad[px, pts[..., 1], pts[..., 2]].to(torch.float32)
        magn = norm3(g)
        dirs = g / torch.clamp(magn, min=1e-30)[..., None]
        w = tab.mask[None] * (magn >= cutoff).to(torch.float32)
        q0 = _quantize(_zone_hist(dirs, w, tab.bounds))
        q0max = q0.amax(dim=-1, keepdim=True)
        main_idx, n_main = _first_k_flagged(q0 > q0max * 0.8, M)
        ok = ok & (n_main >= 1) & (n_main <= M) & (q0max[:, 0] > 0)
        Rm = tab.rot_to_pole[main_idx]
        rot_dirs = rows_times(dirs[:, None], Rm.transpose(-1, -2))
        q1 = _quantize(_zone_hist(rot_dirs, w[:, None].expand(-1, M, -1),
                                  tab.bounds))
        not_pole = q1[..., 1:-1]
        m1 = not_pole.amax(dim=-1, keepdim=True)
        nq = (not_pole.to(torch.float32)
              / torch.clamp(m1, min=1).to(torch.float32) * 50.0
              ).to(torch.int32)
        flag1 = (nq > nq.amax(dim=-1, keepdim=True) * 0.8) & (m1 > 0)
        sec_idx, n_sec = _first_k_flagged(flag1, S)
        sec_bins = sec_idx.to(torch.int64) + 1
        main_ok = (m1[..., 0] > 0) & (n_sec >= 1) & (n_sec <= S)
        ftheta = -(tab.p_theta[sec_bins] - tab.belt_first[sec_bins])
        rfin = matmul3(rotation_about_z(ftheta), Rm[:, :, None])
        sub_ok = main_ok[..., None] & (ar_s < n_sec[..., None])
        lane_ok = (ok[:, None, None] & (ar_m < n_main[:, None])[..., None]
                   & sub_ok)
        mains_o[s0:s0 + n] = main_idx.to(torch.int32)
        secs_o[s0:s0 + n] = sec_bins.to(torch.int32)
        rfin_o[s0:s0 + n] = rfin
        ok_o[s0:s0 + n] = lane_ok
    return mains_o, secs_o, rfin_o, ok_o


# -- rows -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lattice(radius: int, upsampled: bool) -> np.ndarray:
    if upsampled:
        r = np.arange(-2 * radius + 1, 2 * radius + 1, 2, dtype=np.float32)
    else:
        r = np.arange(-radius + 0.5, radius + 0.5, 1.0, dtype=np.float32)
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def _regions(radius: int, subregions: int) -> np.ndarray:
    n = 2 * radius
    idx = np.arange(n)
    if subregions == 64:
        bounds = [0, radius // 2, radius, 3 * radius // 2, n]
        b = np.searchsorted(bounds, idx, side="right") - 1
        bx, by, bz = np.meshgrid(b, b, b, indexing="ij")
        reg = by * 16 + bx * 4 + bz
    elif subregions == 27:
        bounds = [0, n // 3, 2 * n // 3, n]
        b = np.searchsorted(bounds, idx, side="right") - 1
        bx, by, bz = np.meshgrid(b, b, b, indexing="ij")
        reg = by * 9 + bx * 3 + bz
    elif subregions == 8:
        b = (idx >= radius).astype(int)
        bx, by, bz = np.meshgrid(b, b, b, indexing="ij")
        reg = bx * 4 + by * 2 + (1 - bz)
    else:
        reg = np.zeros((n, n, n), dtype=int)
    return reg.reshape(-1).astype(np.int64)


def rows(grad, coords, rfinal, real_shape, upsampled: bool, cfg: dict,
         chunk: int = 64):
    """(L, subregions * zones) int16 counts and (L,) ok of each lane."""
    radius = (cfg["patch_size"] - cfg["patch_size"] % 2) // 2
    dev = grad.device
    lat = torch.as_tensor(_lattice(radius, upsampled), device=dev)
    reg = torch.as_tensor(_regions(radius, cfg["subregions"]), device=dev)
    bnd = torch.as_tensor(zone_bounds(cfg["subeqsp_size"]), device=dev)
    nz = bnd.shape[0]
    nbins = cfg["subregions"] * nz
    hi = torch.as_tensor(np.asarray(real_shape) - 1, dtype=torch.float32,
                         device=dev)
    shp = torch.as_tensor(grad.shape[:3], device=dev)
    L = coords.shape[0]
    descs = torch.zeros((L, nbins), dtype=torch.int16, device=dev)
    oks = torch.zeros(L, dtype=torch.bool, device=dev)
    for s in range(0, L, chunk):
        c = coords[s:s + chunk].to(torch.float32)
        R = rfinal[s:s + chunk]
        n = c.shape[0]
        pts = rows_times(lat[None].expand(n, -1, -1), R) + c[:, None, :]
        inb = ((pts >= 0) & (pts <= hi)).all(dim=-1).all(dim=-1)
        ids = torch.ceil(pts - 0.5).to(torch.int64)
        ids = torch.minimum(torch.clamp(ids, min=0), shp - 1)
        g = grad[ids[..., 0], ids[..., 1], ids[..., 2]].to(torch.float32)
        magn = norm3(g)
        big = (magn > cfg["cutoff_magn"])[..., None]
        dirs = torch.where(big, g / torch.clamp(magn, min=1e-30)[..., None],
                           g)
        zones = zone_assign(rows_times(dirs, R.transpose(1, 2)), bnd)
        binid = reg[None] * nz + zones
        binid = torch.where(magn < cfg["zero_magn"],
                            torch.full_like(binid, nbins), binid)
        counts = torch.zeros((n, nbins + 1), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, binid, torch.ones_like(binid,
                                                      dtype=torch.int32))
        descs[s:s + n] = torch.where(inb[:, None], counts[:, :nbins],
                                     0).to(torch.int16)
        oks[s:s + n] = inb
    return descs, oks


# -- the chain ------------------------------------------------------------

@dataclass
class Described:
    """The rows of one described grid, in octave order."""

    octave: np.ndarray        # (N,) int
    subv: np.ndarray          # (N, 3) float64 subvoxel anchor coords (A)
    main: np.ndarray          # (N,) int
    sec: np.ndarray           # (N,) int
    desc: torch.Tensor        # (N, D) int16 counts
    rfinal: np.ndarray        # (N, 3, 3) float32 frames


def describe(vol: torch.Tensor, origin, voxsp: float, cfg: dict,
             dtype=torch.float32) -> Described:
    """Anchors, frames and rows of a density grid ``vol`` at ``origin``
    (A); ``cfg`` the configuration's ``method`` section."""
    ss, dc, oc, de = cfg["scalespace"], cfg["detect"], cfg["orient"], \
        cfg["describe"]
    pad = int(ss["map_padding"])
    base = F.pad(vol.to(torch.float32), (pad,) * 6).to(dtype)
    origin = np.asarray(origin) - pad * voxsp
    modes = {"up": [True], "base": [False], "both": [True, False]}
    parts = []
    for oi, up in enumerate(modes[ss["oct_mode"]]):
        if up:
            v = upsample2(base)
            if ss["presmooth_sigma"]:
                g0 = gaussian_kernel1d(ss["presmooth_sigma"], 0,
                                       ss["truncate"])
                for axis in range(3):
                    v = conv_same(v, g0, axis)
            vs = voxsp / 2.0
        else:
            v, vs = base, voxsp
        real = tuple(v.shape)
        log_vol, gauss = log_gauss(v, ss["detect_sigma"], ss["truncate"])
        del v
        pos, subvox, valid = detect(log_vol, real, dc)
        del log_vol
        n_vox = int(np.prod(real, dtype=np.int64))
        fdt = torch.bfloat16 if n_vox > BF16_VOXELS else torch.float32
        grad = gradient(gauss, fdt if dtype == torch.float32 else dtype)
        del gauss
        vidx = torch.nonzero(valid).reshape(-1)
        coords_v = pos[vidx]
        M, S = oc["max_main"], oc["max_sec"]
        radius = (oc["patch_size"] - oc["patch_size"] % 2) // 2
        stride = 2 if up else 1
        tab = _OrientTables(oc["eqsp_size"], radius, stride, oc["gw_sig"],
                            grad.device)
        mains, secs, rfin, ok = orient(grad, coords_v, real, tab, radius,
                                       stride, M, S, oc["cutoff_magn"])
        lanes = torch.nonzero(ok.reshape(-1)).reshape(-1)
        la, lm, ls = lanes // (M * S), (lanes // S) % M, lanes % S
        descs, dok = rows(grad, coords_v[la], rfin.reshape(-1, 3, 3)[lanes],
                          real, up, de)
        del grad
        keep = torch.nonzero(dok).reshape(-1)[: de["max_descriptors"]]
        sv = subvox[vidx[la]][keep].to(torch.float32).cpu().numpy()
        parts.append(dict(
            octave=np.full(len(keep), oi),
            subv=sv.astype(np.float64) * vs + origin,
            main=mains[la, lm][keep].cpu().numpy(),
            sec=secs[la, lm, ls][keep].cpu().numpy(),
            desc=descs[keep],
            rfinal=rfin.reshape(-1, 3, 3)[lanes][keep].to(
                torch.float32).cpu().numpy()))
    return Described(
        octave=np.concatenate([p["octave"] for p in parts]),
        subv=np.concatenate([p["subv"] for p in parts]),
        main=np.concatenate([p["main"] for p in parts]).astype(np.int64),
        sec=np.concatenate([p["sec"] for p in parts]).astype(np.int64),
        desc=torch.cat([p["desc"] for p in parts]),
        rfinal=np.concatenate([p["rfinal"] for p in parts]))


def describe_mol(coords: np.ndarray, masses: np.ndarray, resolution: float,
                 voxsp: float, cfg: dict, device, dtype=torch.float32):
    """A structure simulated on its own box (bucket ``shape_bucket``) and
    described: the program's PDB path."""
    vol, origins = sim.simulate(coords[None], masses[None], resolution,
                                voxsp, device,
                                shape_bucket=cfg["shape_bucket"], dtype=dtype)
    return describe(vol[0], origins[0], voxsp, cfg, dtype)
