"""1024-dim rotation-invariant descriptors (port of mad_tpu/ops/describe.py).

Per oriented lane, a patch_size^3 lattice (half-voxel centres on the base
octave, stride-2 odd centres on the upsampled octave, mad/Descriptor.py:32-35)
is rotated into the anchor frame, the gradient field is sampled there by
nearest neighbour, and the samples are binned into subregions x EQSP zones
(mad/Descriptor.py:106-202). The per-lane work is kernel K7
(:mod:`mad_tpu_torch.kernels.describe`).

Capacity mode (a mesh; mad_tpu's ``describe_shard``, ops/describe.py:167-232):
the gradient field arrives as x-slabs. Each shard describes the lanes
whose anchor x lies in its slab, with K7 gathering from the shard's block
of the field, extended by radius * stride * 2 rows of its neighbours (the
rotated lattice reaches at most sqrt(3) of the radius; the blocks are
orientation's); the rows go back to the lanes' order on the mesh's first
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import DescribeConfig
from ..core.eqsp import get_eqsp
from ..kernels.describe import descriptor_hist
from ..parallel.volume import check_halo, map_owned
from .orient import ref_zone_bounds


@functools.lru_cache(maxsize=None)
def descriptor_lattice(radius: int, upsampled: bool) -> np.ndarray:
    """(P, 3) sample offsets in octave voxels (mad/Descriptor.py:32-35);
    one array a setting, never written, so K7's wrapper knows it by
    identity."""
    if upsampled:
        r = np.arange(-2 * radius + 1, 2 * radius + 1, 2, dtype=np.float32)
    else:
        r = np.arange(-radius + 0.5, radius + 0.5, 1.0, dtype=np.float32)
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def region_ids(radius: int, subregions: int) -> np.ndarray:
    """Subregion id per lattice point, reference slice-table order
    (mad/Descriptor.py:38-96); one array a setting, never written."""
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
    elif subregions == 1:
        reg = np.zeros((n, n, n), dtype=int)
    else:
        raise ValueError(f"invalid subregions {subregions}")
    return reg.reshape(-1).astype(np.int32)


def describe_anchors(grad, coords: torch.Tensor, rfinals: torch.Tensor,
                     valid: torch.Tensor, real_shape, upsampled: bool,
                     cfg: DescribeConfig, mesh=None):
    """Descriptors for oriented lanes of one octave.

    grad: the gradient field (with a mesh, its ``parallel.volume.Blocks``);
    coords: (L, 3) anchor voxel coords; rfinals: (L, 3, 3); valid: (L,).
    Returns (descriptors (L, subregions*subeqsp) int16, ok (L,) bool), on
    the device of ``coords``."""
    radius = (cfg.patch_size - cfg.patch_size % 2) // 2
    consts = (descriptor_lattice(radius, upsampled),
              region_ids(radius, cfg.subregions),
              ref_zone_bounds(get_eqsp(cfg.subeqsp_size)), cfg.subregions,
              float(cfg.cutoff_magn), float(cfg.zero_magn))
    if mesh is None:
        return descriptor_hist(grad, coords, rfinals, valid, real_shape,
                               *consts)
    stride = 2 if upsampled else 1
    check_halo(grad, radius * stride * 2, "describe_anchors")
    return map_owned(
        grad, lambda blk, lo, c, r, v: descriptor_hist(
            blk, c, r, v, real_shape, *consts, lo),
        coords, rfinals, valid)
