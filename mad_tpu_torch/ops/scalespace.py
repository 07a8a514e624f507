"""Gaussian/LoG scale space (port of mad_tpu/ops/scalespace.py).

Replaces MapSpace.build_space (mad/MapSpace.py:69-189): an optional x2
upsampled octave (Catmull-Rom, presmoothed) and the base octave, each with
its scale-normalized negative LoG (clamped at 0) and the gradient of its
Gaussian-smoothed volume (kernel K3, :mod:`mad_tpu_torch.kernels.gradient`).

The map is zero-padded by ``map_padding`` voxels (one K23 copy,
``kernels/crop_pad.py``) and used at its real size; mad_tpu's shape
buckets only bounded XLA recompiles. Octaves build
one at a time and each field is freed as soon as its consumer is done.

Capacity mode (a mesh; the ``mesh`` branches of mad_tpu's ``_prepare``,
``_compiled_log``, ``_grad_body`` and ``LazyOctave``, :83-346): the padded
map is cut into x-slabs and a :class:`ShardedOctave` builds each shard's
rows of the upsample (K2), presmooth and LoG (K1 and the LoG epilogue) on
its slab extended by the chain's reach (:meth:`ShardedOctave.build_halo`),
so no shard holds a whole octave field; the rows equal the single-device
octave's bit for bit. Its gradient field is K3 on each shard's block
extended by the rows orientation and the descriptors read
(``parallel.volume.sharded_gradient``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..core.config import ScaleSpaceConfig
from ..core.grid import DensityGrid
from ..kernels.crop_pad import crop_pad
from ..kernels.gradient import gradient  # K3, the octave field
from ..parallel.mesh import Mesh, mesh_size
from ..parallel.volume import (filter_radius, map_slabs, row_bounds,
                               split_x, up_bounds)
from .convolve import gaussian_filter3d, log_filter3d, upsample2

# Above this many octave voxels the gradient field is stored as bfloat16
# (mad_tpu/ops/scalespace.py:287: 250 M voxels = 3 GB of float32 gradients).
BF16_VOXELS = 250_000_000


@dataclass
class Octave:
    """One scale-space octave of a padded map."""

    base: torch.Tensor        # padded base volume (shared by the octaves)
    voxsp: float
    upsampled: bool
    cfg: ScaleSpaceConfig

    @property
    def real_shape(self) -> Tuple[int, int, int]:
        s = tuple(self.base.shape)
        return tuple(2 * x - 1 for x in s) if self.upsampled else s

    def volume(self) -> torch.Tensor:
        return octave_volume(self.base, self.upsampled, self.cfg)

    def log_gauss(self):
        """(LoG response, Gaussian-smoothed volume)."""
        return log_filter3d(self.volume(), self.cfg.detect_sigma,
                            self.cfg.truncate)

    def grad_dtype(self):
        return _grad_dtype(self.real_shape, 1)


def octave_volume(base: torch.Tensor, upsampled: bool,
                  cfg: ScaleSpaceConfig) -> torch.Tensor:
    """The octave's volume: the base itself, or its x2 upsample (K2)
    presmoothed (K1)."""
    vol = base
    if upsampled:
        vol = upsample2(vol)
        if cfg.presmooth_sigma:
            vol = gaussian_filter3d(vol, cfg.presmooth_sigma, cfg.truncate)
    return vol


def _grad_dtype(real_shape, n_shards: int):
    # A mesh scales the gate by its size, as mad_tpu does (what must fit is
    # one shard's field): above 250 M octave voxels a mesh run keeps the
    # float32 field that a single-device run stores as bfloat16.
    n = int(np.prod(real_shape, dtype=np.int64))
    return (torch.bfloat16 if n > BF16_VOXELS * n_shards
            else torch.float32)


@dataclass
class ShardedOctave:
    """One octave of a padded map cut into x-slabs over a mesh."""

    base: list                # the padded base volume's slabs
    voxsp: float
    upsampled: bool
    cfg: ScaleSpaceConfig
    mesh: Mesh

    @property
    def real_shape(self) -> Tuple[int, int, int]:
        s = (row_bounds(self.base)[-1],) + tuple(self.base[0].shape[1:])
        return tuple(2 * x - 1 for x in s) if self.upsampled else s

    @property
    def bounds(self):
        """The octave's row bounds: which rows each shard owns."""
        b = row_bounds(self.base)
        return up_bounds(b) if self.upsampled else b

    def build_halo(self) -> int:
        """Base rows of halo that make the shard's octave rows exact: the
        LoG's reach, plus the presmooth's on the upsampled octave, there in
        up rows, halved, and two base rows for K2's Catmull-Rom taps
        (i - 1 ... i + 2)."""
        c = self.cfg
        reach = filter_radius(c.detect_sigma, c.truncate)
        if not self.upsampled:
            return reach
        if c.presmooth_sigma:
            reach += filter_radius(c.presmooth_sigma, c.truncate)
        return (reach + 1) // 2 + 2

    def log_gauss(self):
        """(LoG response slabs, Gaussian-smoothed slabs)."""
        c = self.cfg
        log_s, gauss_s = map_slabs(
            self.base, self.mesh, self.build_halo(),
            lambda v: log_filter3d(octave_volume(v, self.upsampled, c),
                                   c.detect_sigma, c.truncate),
            up=self.upsampled)
        return log_s, gauss_s

    def grad_dtype(self):
        return _grad_dtype(self.real_shape, mesh_size(self.mesh))


@dataclass
class OctaveFields:
    """One materialized octave, mad_tpu's ``Octave`` fields
    (mad_tpu/ops/scalespace.py:29-36) at the real size (no bucket
    padding)."""

    voxsp: float
    log: torch.Tensor         # (X, Y, Z) clamped -sigma^2 * LoG
    grad: torch.Tensor        # (X, Y, Z, 3) gradient of the smoothed grid
    real_shape: Tuple[int, int, int]


@dataclass
class ScaleSpace:
    octaves: List[OctaveFields]
    origin: np.ndarray        # shared map origin (A) after padding
    name: str = ""


def build_scale_space(grid: DensityGrid, cfg: ScaleSpaceConfig,
                      shape_bucket: int = 32) -> ScaleSpace:
    """All octaves of a density grid resident at once (mad_tpu's
    ``build_scale_space``, :376-384), over :func:`iter_octaves`: each
    octave's LoG (K2, K1) and gradient field (K3), on the grid's device.
    ``shape_bucket`` is accepted and ignored: the port works at the real
    size, where mad_tpu pads each octave to a multiple of it."""
    octaves = []
    origin = grid.origin
    for origin, octv in iter_octaves(grid, cfg):
        log_vol, gauss = octv.log_gauss()
        grad = gradient(gauss, octv.grad_dtype())
        del gauss
        octaves.append(OctaveFields(octv.voxsp, log_vol, grad,
                                    octv.real_shape))
    return ScaleSpace(octaves=octaves, origin=origin, name=grid.name)


def prepare(grid: DensityGrid, cfg: ScaleSpaceConfig):
    """Zero-pad the map by ``map_padding`` (K23); returns (volume,
    origin)."""
    pad = int(cfg.map_padding)
    data = grid.data.to(torch.float32)
    if pad:
        data = crop_pad(data, (0, 0, 0), data.shape, pad)
    return data, grid.origin - pad * grid.voxsp


def iter_octaves(grid: DensityGrid, cfg: ScaleSpaceConfig, mesh=None):
    """Yield (origin, Octave): the upsampled octave first, as mad_tpu;
    with a mesh, (origin, ShardedOctave) on the padded map's slabs."""
    data, origin = prepare(grid, cfg)
    if mesh is None:
        make = lambda up, vs: Octave(data, vs, up, cfg)
    else:
        slabs = split_x(data, mesh)
        del data
        make = lambda up, vs: ShardedOctave(slabs, vs, up, cfg, mesh)
    if cfg.oct_mode in ("up", "both"):
        yield origin, make(True, grid.voxsp / 2.0)
    if cfg.oct_mode in ("base", "both"):
        yield origin, make(False, grid.voxsp)
