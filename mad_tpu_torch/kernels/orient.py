"""K6: canonical orientation frames of the anchors of one octave.

Replaces mad_tpu/ops/orient.py:212 (``_orient_bodies``, its per-anchor
``one_anchor`` :248-336 with ``zone_hist_fn``, ``_quantize`` and
``_first_k_flagged`` :118-173). The CUDA kernel ``csrc/orient.cu`` runs
one thread-block cluster per anchor, its CTAs splitting the patch and
adding into the leader's 1 + M zone histograms, and looks a direction's
zones up in :func:`zone_table` (its note says what bounds it);
:func:`orient_plain` is the plain PyTorch version, 32 anchors a chunk as
batched tensor ops through (chunk, patch, zones) masks, with the helpers
below.

Both take the (X, Y, Z, 3) gradient field, (K, 3) int64 anchor voxel
coords, a (K,) bool validity, the octave's real extent and the host-built
tables of ``ops.orient._OrientTables``; both return (main_bin (K, M)
int32, sec_bin (K, M, S) int32, rfinal (K, M, S, 3, 3) float32, valid
(K, M, S) bool). Only the lanes flagged valid are defined: the kernel
writes zeros where the plain version carries the values of unused main
slots and rejected anchors.

Both take an offset form for capacity mode (mad_tpu/ops/orient.py:356-387,
``orient_shard``, and its gathers at :255-263): ``grad`` is a shard's
x-slab extended by its neighbours' rows, its row 0 global row ``goff``;
the coords, the border test and the clamped patch centre stay global, the
gathers move into the block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.geometry import (matmul3, norm3, rotation_about_z, rows_times,
                             zone_mask)
from . import build

launches = 0            # kernel launches since the last reset

# What csrc/orient.cu holds per block: main and secondary slots, zones,
# and patch samples (the sum of that many weights of 2^40 fits 64 bits).
MAX_MAIN, MAX_SEC, MAX_ZONES, MAX_PATCH = 8, 16, 256, 1 << 23


def zone_table(bounds):
    """The zone candidates of each phi slot, for the kernel's lookup.

    bounds (Z, 4) float32 [theta_min, phi_min, theta_max, phi_max]. Returns
    (edges, start, zones): the sorted distinct phi bounds (nb float32); and
    for each of the 2 nb + 1 slots of phi (slot 0 below edges[0] or NaN,
    2j + 1 on edges[j], 2j + 2 the open gap above it), the zones whose
    closed phi range meets the slot: zones[start[s]:start[s + 1]] (int32,
    start has 2 nb + 2 entries). A direction strictly inside a zone's phi
    range lies in a slot that meets the range, so the candidates of its
    slot hold every zone it lands in (tests/test_torch_orient_zones.py)."""
    b = np.asarray(bounds, dtype=np.float32)
    lo, hi = b[:, 1], b[:, 3]
    edges = np.unique(np.concatenate([lo, hi]))
    inf = np.float32(np.inf)
    cands = [np.nonzero(lo < edges[0])[0]]                   # (-inf, e0)
    for j, e in enumerate(edges):
        above = edges[j + 1] if j + 1 < len(edges) else inf
        cands.append(np.nonzero((lo <= e) & (hi >= e))[0])   # {e}
        cands.append(np.nonzero((lo < above) & (hi > e))[0])  # (e, above)
    start = np.concatenate([[0], np.cumsum([len(c) for c in cands])])
    return (edges.astype(np.float32), start.astype(np.int32),
            np.concatenate(cands).astype(np.int32))


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


def _quantize(counts: torch.Tensor) -> torch.Tensor:
    """int32(count / max * 50), max-safe (mad/Orientator.py:340)."""
    m = counts.amax(dim=-1, keepdim=True)
    return (counts / torch.clamp(m, min=1e-30) * 50.0).to(torch.int32)


def _first_k_flagged(flag: torch.Tensor, k: int):
    """Indices of the first k true entries along the last axis (ascending,
    padded with the false ones), plus the count of true entries."""
    order = torch.sort((~flag).to(torch.int8), dim=-1, stable=True).indices
    return order[..., :k], flag.sum(dim=-1)


def orient_plain(grad, coords, valid, real_shape, tab, radius: int,
                 stride: int, max_main: int, max_sec: int,
                 cutoff_magn: float, chunk: int = 32, goff: int = 0):
    dev = grad.device
    M, S = max_main, max_sec
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
        px = torch.clamp(pts[..., 0] - goff, 0, grad.shape[0] - 1)
        g = grad[px, pts[..., 1], pts[..., 2]].to(torch.float32)
        magn = norm3(g)
        dirs = g / torch.clamp(magn, min=1e-30)[..., None]
        w = tab.mask[None] * (magn >= cutoff_magn).to(torch.float32)

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


def orient(grad, coords, valid, real_shape, tab, radius: int, stride: int,
           max_main: int, max_sec: int, cutoff_magn: float, chunk: int = 32,
           goff: int = 0):
    """Frames of K anchors; CPU tensors take the plain version (``chunk``
    anchors at a time, the kernel takes one cluster of CTAs per anchor)."""
    if grad.device.type == "cpu":
        return orient_plain(grad, coords, valid, real_shape, tab, radius,
                            stride, max_main, max_sec, cutoff_magn, chunk,
                            goff)
    global launches
    if grad.dim() != 4 or grad.shape[3] != 3 or grad.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"orient: need an (X, Y, Z, 3) float32 or bfloat16 "
                         f"field, got {tuple(grad.shape)} {grad.dtype}")
    nz = tab.bounds.shape[0]
    if (not 1 <= max_main <= MAX_MAIN or not 1 <= max_sec <= MAX_SEC
            or not 3 <= nz <= MAX_ZONES
            or radius < 0 or (2 * radius + 1) ** 3 > MAX_PATCH):
        raise ValueError(f"orient: {max_main} main / {max_sec} secondary "
                         f"slots over {nz} zones at radius {radius} not "
                         "supported")
    K = coords.shape[0]
    if coords.shape != (K, 3) or valid.shape != (K,):
        raise ValueError(f"orient: bad shapes {tuple(coords.shape)}, "
                         f"{tuple(valid.shape)}")
    coords_i = coords.to(torch.int32)
    valid_u8 = valid.to(torch.uint8)
    build.require_cuda("orient", grad, coords_i, valid_u8, tab.bounds,
                       tab.mask, tab.rot_to_pole, tab.p_theta,
                       tab.belt_first, tab.zone_edges, tab.zone_start,
                       tab.zone_cands)
    dev = grad.device
    M, S = max_main, max_sec
    mains = torch.empty((K, M), dtype=torch.int32, device=dev)
    secs = torch.empty((K, M, S), dtype=torch.int32, device=dev)
    rfin = torch.empty((K, M, S, 3, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((K, M, S), dtype=torch.uint8, device=dev)
    if K == 0:
        return mains, secs, rfin, ok.bool()
    X, Y, Z = grad.shape[:3]
    rx, ry, rz = (int(s) for s in real_shape)
    build.launch(
        build.library().mad_orient, dev, grad.data_ptr(),
        0 if grad.dtype == torch.float32 else 1, X, Y, Z, rx, ry, rz,
        int(goff), coords_i.data_ptr(), valid_u8.data_ptr(), K, int(radius),
        int(stride), tab.mask.data_ptr(), tab.bounds.data_ptr(), nz,
        tab.zone_edges.data_ptr(), tab.zone_edges.numel(),
        tab.zone_start.data_ptr(), tab.zone_cands.data_ptr(),
        tab.zone_cands.numel(), tab.rot_to_pole.data_ptr(),
        tab.p_theta.data_ptr(), tab.belt_first.data_ptr(), M, S,
        float(cutoff_magn), mains.data_ptr(),
        secs.data_ptr(), rfin.data_ptr(), ok.data_ptr())
    launches += 1
    return mains, secs, rfin, ok.bool()
