"""K7: descriptor histograms of oriented lanes.

Replaces mad_tpu/ops/describe.py:79-152 (``one_descriptor``) together
with the zone assignment of mad_tpu/ops/orient.py:141-160
(``zone_assign_fn``, here ``core.geometry.zone_assign``). The CUDA
kernel ``csrc/describe.cu`` runs one block per lane, each warp over whole
subregions, counting zones by warp ballots (its note says what bounds
it); :func:`descriptor_hist_plain` is the plain PyTorch version, chunked
over lanes, with the same per-element arithmetic order. The kernel's
host-side pieces are here for the tests to hold: the region-major sample
list (:func:`region_layout`), the lattice built from the index
(:func:`lattice_from_index`) and the 8-corner bounds test
(:func:`corners_in_bounds`).

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
from .orient import zone_table

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


def pack(index: np.ndarray, n: int) -> np.ndarray:
    """Lattice indices (ix * n + iy) * n + iz as ix | iy << 8 | iz << 16,
    int32 (n <= 255)."""
    ix, rest = np.divmod(np.asarray(index, np.int64), n * n)
    iy, iz = np.divmod(rest, n)
    return (ix | (iy << 8) | (iz << 16)).astype(np.int32)


def region_layout(regions: np.ndarray, n: int, nregions: int):
    """The lattice listed region by region, as the kernel's warps walk it:
    the packed lattice indices (:func:`pack`) stably sorted by subregion,
    and the (nregions + 1,) int32 offsets of each region's first entry."""
    regions = np.asarray(regions)
    order = np.argsort(regions, kind="stable")
    start = np.searchsorted(regions[order], np.arange(nregions + 1))
    return pack(order, n), start.astype(np.int32)


def lattice_from_index(packed: np.ndarray, n: int, upsampled: bool
                       ) -> np.ndarray:
    """The (len(packed), 3) float32 lattice coordinates of packed indices
    as the kernel builds them: -radius + 0.5 + i on the base octave,
    -2 radius + 1 + 2 i upsampled (radius = n / 2)."""
    packed = np.asarray(packed)
    i = np.stack([packed & 0xFF, (packed >> 8) & 0xFF, packed >> 16], -1)
    if upsampled:
        return (2 * i + 1 - n).astype(np.float32)
    return i.astype(np.float32) + (np.float32(0.5) - np.float32(n // 2))


def corners_in_bounds(coords: torch.Tensor, rfinal: torch.Tensor,
                      real_shape, n: int, upsampled: bool) -> torch.Tensor:
    """(L,) bool: the lattice's 8 corners placed by each lane's frame lie
    in 0 <= q <= real_shape - 1, in the plain version's arithmetic. This
    is the kernel's bounds test; each placed coordinate is monotone in
    each lattice coordinate, so it equals the test over every point."""
    corner = pack([(k >> 2) * (n - 1) * n * n + ((k >> 1) & 1) * (n - 1) * n
                   + (k & 1) * (n - 1) for k in range(8)], n)
    lat = torch.as_tensor(lattice_from_index(corner, n, upsampled),
                          device=coords.device)
    top = torch.as_tensor(np.asarray(real_shape) - 1, dtype=torch.float32,
                          device=coords.device)
    pts = (rows_times(lat[None].expand(coords.shape[0], -1, -1),
                      rfinal.to(torch.float32))
           + coords.to(torch.float32)[:, None, :])
    return ((pts >= 0) & (pts <= top)).all(dim=-1).all(dim=-1)


_layouts: dict = {}


def _device_layout(lattice, regions, bounds, nregions: int, device):
    """The kernel's constants on ``device``, built once per (points an
    axis, upsampled, subregions, zones, device): the region-major sample
    list and offsets, the zone bounds and K6's zone table
    (kernels/orient.zone_table). The host arrays of a call are held equal
    to those its entry was built from: by identity for ops/describe's
    cached lattice and regions (not to be written), else by a compare."""
    n = round(lattice.shape[0] ** (1 / 3))
    upsampled = bool(lattice[0, 0] == 1 - n)
    key = (n, upsampled, int(nregions), bounds.shape[0], str(device))
    entry = _layouts.get(key)
    if entry is None:
        if not (lattice.shape == (n ** 3, 3) and np.array_equal(
                lattice_from_index(pack(np.arange(n ** 3), n), n, upsampled),
                lattice) and regions.shape == (n ** 3,)
                and 0 <= regions.min() and regions.max() < nregions):
            raise ValueError("descriptor_hist: the lattice and regions must "
                             "be ops/describe's")
        packed, start = region_layout(regions, n, nregions)
        edges, slot_start, slot_zone = zone_table(bounds)
        on = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt),
                                           device=device)
        entry = _layouts[key] = dict(
            host=(lattice, regions, np.array(bounds)),
            n=n, upsampled=upsampled,
            consts=(on(packed, np.int32), on(start, np.int32),
                    on(bounds, np.float32), on(edges, np.float32),
                    on(slot_start, np.int32), on(slot_zone, np.int32)))
    elif not all(a is b or np.array_equal(a, b) for a, b in
                 zip(entry["host"], (lattice, regions, bounds))):
        raise ValueError("descriptor_hist: lattice, regions or zone bounds "
                         "differ from those of this setting")
    return entry


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
    (P,) / bounds (nzones, 4): host constants, ops/describe's
    ``descriptor_lattice``, ``region_ids`` and ``ref_zone_bounds``."""
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
    if nz > 64:
        raise ValueError(f"descriptor_hist: {nz} zones, at most 64")
    L = coords.shape[0]
    coords = coords.to(torch.float32).contiguous()
    rfinal = rfinal.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()       # its bytes, as read
    grad = grad.contiguous()
    build.require_cuda("descriptor_hist", grad, coords, rfinal, valid)
    lay = _device_layout(lattice, regions, bounds, nregions, grad.device)
    samples, start, bnd, edges, slot_start, slot_zone = lay["consts"]
    out = torch.empty((L, nregions * nz), dtype=torch.int16,
                      device=grad.device)
    ok = torch.empty(L, dtype=torch.bool, device=grad.device)
    if L == 0:
        return out, ok
    X, Y, Z = grad.shape[:3]
    rx, ry, rz = (int(s) for s in real_shape)
    build.launch(
        build.library().mad_descriptor_hist, grad.device, grad.data_ptr(),
        0 if grad.dtype == torch.float32 else 1, X, Y, Z, rx, ry, rz,
        int(goff), coords.data_ptr(), rfinal.data_ptr(), valid.data_ptr(),
        L, lay["n"], int(lay["upsampled"]), samples.data_ptr(),
        start.data_ptr(), int(nregions), bnd.data_ptr(), nz,
        edges.data_ptr(), edges.shape[0], slot_start.data_ptr(),
        slot_zone.data_ptr(), slot_zone.shape[0], float(cutoff),
        float(zero_magn), out.data_ptr(), ok.data_ptr())
    launches += 1
    return out, ok
