"""K7: descriptor histograms of oriented lanes.

Replaces mad_tpu/ops/describe.py:79-152 (``one_descriptor``) together
with the zone assignment of mad_tpu/ops/orient.py:141-160
(``zone_assign_fn``, here ``core.geometry.zone_assign``). The CUDA
kernel ``csrc/describe.cu`` runs one block per lane with the histogram in
shared memory (its note says what bounds it);
:func:`descriptor_hist_plain` is the plain PyTorch version, chunked over
lanes, with the same per-element arithmetic order.

Both take an offset form for capacity mode (mad_tpu/ops/describe.py:167-196,
``describe_shard``, and its gathers at :108-115): ``grad`` is a shard's
x-slab extended by its neighbours' rows, its row 0 global row ``goff``;
the lattice and the bounds test stay global, and each sample's global
nearest index moves into the block.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.geometry import rows_times, zone_assign
from ..ops.interp import nearest
from . import build

launches = 0            # kernel launches since the last reset


def descriptor_hist_plain(grad, coords, rfinal, valid, real_shape, lattice,
                          regions, bounds, nregions: int, cutoff: float,
                          zero_magn: float, goff: int = 0, chunk: int = 64
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = grad.device
    L = coords.shape[0]
    nz = bounds.shape[0]
    nbins = nregions * nz
    lat = torch.as_tensor(lattice, dtype=torch.float32, device=dev)
    reg = torch.as_tensor(regions, dtype=torch.int64, device=dev)
    bnd = torch.as_tensor(bounds, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(np.asarray(real_shape) - 1, dtype=torch.float32,
                         device=dev)
    descs = torch.zeros((L, nbins), dtype=torch.int16, device=dev)
    oks = torch.zeros(L, dtype=torch.bool, device=dev)
    for s in range(0, L, chunk):
        c = coords[s:s + chunk].to(torch.float32)
        R = rfinal[s:s + chunk]
        n = c.shape[0]
        pts = rows_times(lat[None].expand(n, -1, -1), R) + c[:, None, :]
        inb = ((pts >= 0) & (pts <= hi)).all(dim=-1).all(dim=-1)
        g = nearest(grad, pts, goff).to(torch.float32)
        magn = torch.sqrt(g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]
                          + g[..., 2] * g[..., 2])
        big = (magn > cutoff)[..., None]
        dirs = torch.where(big, g / torch.clamp(magn, min=1e-30)[..., None],
                           g)
        rotated = rows_times(dirs, R.transpose(1, 2))
        zones = zone_assign(rotated, bnd)
        binid = reg[None] * nz + zones
        binid = torch.where(magn < zero_magn, torch.full_like(binid, nbins),
                            binid)
        counts = torch.zeros((n, nbins + 1), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, binid, torch.ones_like(binid,
                                                      dtype=torch.int32))
        ok = valid[s:s + chunk] & inb
        descs[s:s + n] = torch.where(ok[:, None], counts[:, :nbins],
                                     0).to(torch.int16)
        oks[s:s + n] = ok
    return descs, oks


_const_cache: dict = {}


def _device_consts(lattice, regions, bounds, device):
    # Cached per device, as kernels/conv1d.py caches its taps: no
    # host-to-device copy (and stream wait) per launch.
    key = (lattice.tobytes(), regions.tobytes(), bounds.tobytes(),
           str(device))
    t = _const_cache.get(key)
    if t is None:
        t = (torch.as_tensor(np.ascontiguousarray(lattice, np.float32),
                             device=device),
             torch.as_tensor(np.ascontiguousarray(regions, np.int32),
                             device=device),
             torch.as_tensor(np.ascontiguousarray(bounds, np.float32),
                             device=device))
        _const_cache[key] = t
    return t


def descriptor_hist(grad: torch.Tensor, coords: torch.Tensor,
                    rfinal: torch.Tensor, valid: torch.Tensor, real_shape,
                    lattice: np.ndarray, regions: np.ndarray,
                    bounds: np.ndarray, nregions: int, cutoff: float,
                    zero_magn: float, goff: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descriptors of L lanes: (L, nregions * nzones) int16 counts and the
    (L,) bool in-bounds mask (rows of out-of-bounds lanes are zero).

    grad: (X, Y, Z, 3) float32 or bfloat16 gradient field (or a block of
    it from global row ``goff``); coords: (L, 3) anchor voxel coords;
    rfinal: (L, 3, 3) frames; valid: (L,) bool; lattice (P, 3) / regions
    (P,) / bounds (nzones, 4): host constants."""
    if grad.device.type == "cpu":
        return descriptor_hist_plain(grad, coords, rfinal, valid, real_shape,
                                     lattice, regions, bounds, nregions,
                                     cutoff, zero_magn, goff)
    global launches
    if grad.dim() != 4 or grad.shape[3] != 3 or grad.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"descriptor_hist: need an (X, Y, Z, 3) float32 or "
                         f"bfloat16 field, got {tuple(grad.shape)} "
                         f"{grad.dtype}")
    nz = bounds.shape[0]
    if nz > 64 or nregions * nz * 4 > 48 * 1024:
        raise ValueError(f"descriptor_hist: {nregions}x{nz} bins too many")
    L = coords.shape[0]
    coords = coords.to(torch.float32).contiguous()
    rfinal = rfinal.to(torch.float32).contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    grad = grad.contiguous()
    build.require_cuda("descriptor_hist", grad, coords, rfinal, valid_u8)
    lat, reg, bnd = _device_consts(lattice, regions, bounds, grad.device)
    out = torch.empty((L, nregions * nz), dtype=torch.int16,
                      device=grad.device)
    ok = torch.empty(L, dtype=torch.uint8, device=grad.device)
    if L == 0:
        return out, ok.bool()
    X, Y, Z = grad.shape[:3]
    rx, ry, rz = (int(s) for s in real_shape)
    lib = build.library()
    build.launch(
        lib.mad_descriptor_hist, grad.device, grad.data_ptr(),
        0 if grad.dtype == torch.float32 else 1, X, Y, Z, rx, ry, rz,
        int(goff), coords.data_ptr(), rfinal.data_ptr(), valid_u8.data_ptr(),
        L, lat.data_ptr(), reg.data_ptr(), lat.shape[0], bnd.data_ptr(), nz,
        nregions, float(cutoff), float(zero_magn), out.data_ptr(),
        ok.data_ptr())
    launches += 1
    return out, ok.bool()
