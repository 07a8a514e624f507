"""Anchor detection: LoG peaks + batched Newton subvoxel localization
(port of mad_tpu/ops/detect.py, single device).

Replaces Detector.find_anchors / check_localize (mad/Detector.py:18-123):
  * peaks = voxels equal to their 3x3x3 neighbourhood max, above an
    absolute threshold, ``exclude_border`` voxels inside the real extent;
    the top ``max_anchors`` by response, ties in flat-index order
    (kernel K4, :mod:`mad_tpu_torch.kernels.peaks`);
  * each peak runs <= n_iter Newton steps on a finite-difference Hessian
    and gradient; offsets > max_offset walk one voxel, convergence needs
    all |offset| < max_offset, saddles (an eigenvalue > 0, tested by the
    characteristic-polynomial invariants) are rejected (kernel K5,
    :mod:`mad_tpu_torch.kernels.localize`, which on one device also makes
    the seeds from K4's flat indices and the validity flags: no PyTorch op
    runs between the two kernels).
The anchor table holds exactly the peaks found (at most ``max_anchors``).

Capacity mode (a mesh; mad_tpu's ``detect_shard``, ops/detect.py:221-275):
the LoG volume arrives as x-slabs and stays so. Each shard runs K4 on its
slab extended by 2 + ``newton_iters`` rows of its neighbours (the pooling
reads them; the border test is global), the shards' top-``max_anchors``
lists merge by (-value, global flat index) -- K4's own order, so ties fall
as in the single-device top-k -- and each merged seed is localized (K5) by
the shard that holds its seed x, on the same block; the results return to
the anchor table on the mesh's first device, in the merged order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.config import DetectConfig
from ..kernels.localize import flat_seeds, localize, localize_peaks
from ..kernels.peaks import _order, peak_topk
from ..parallel.volume import halo_extend, map_owned


@dataclass
class Anchors:
    """Anchor set of one octave, in detection (response) order."""

    coords: torch.Tensor      # (K, 3) int64 voxel coords (post-walk)
    subvox: torch.Tensor      # (K, 3) float32 subvoxel coords (voxels)
    values: torch.Tensor      # (K,) float32 LoG response at the seed peak
    valid: torch.Tensor       # (K,) bool: localized, not a saddle

    @property
    def n(self) -> int:
        return self.coords.shape[0]


def detect_anchors(log_vol, real_shape, cfg: DetectConfig,
                   mesh=None) -> Anchors:
    """Anchors of one octave's LoG volume (real_shape = its real extent);
    with a mesh, ``log_vol`` is the list of its x-slabs."""
    if mesh is not None:
        return _detect_mesh(log_vol, real_shape, cfg, mesh)
    eb, thr = int(cfg.exclude_border), float(cfg.threshold_abs)
    vals, flat = peak_topk(log_vol, real_shape, thr, eb,
                           int(cfg.max_anchors))
    pos, subvox, valid = localize_peaks(log_vol, flat, vals, real_shape, thr,
                                        eb, float(cfg.max_offset),
                                        int(cfg.newton_iters))
    return Anchors(coords=pos, subvox=subvox, values=vals, valid=valid)


def _detect_mesh(slabs, real_shape, cfg: DetectConfig, mesh) -> Anchors:
    eb, cap = int(cfg.exclude_border), int(cfg.max_anchors)
    thr, n_iter = float(cfg.threshold_abs), int(cfg.newton_iters)
    blocks = halo_extend(slabs, 2 + n_iter, mesh)  # pool, the walk, patch
    b = blocks.bounds
    shape = (b[-1],) + tuple(slabs[0].shape[1:])
    vals, flats = [], []
    for s, (blk, lo) in enumerate(zip(blocks.blocks, blocks.lo)):
        v, f = peak_topk(blk, real_shape, thr, eb, cap, b[s] - lo,
                         b[s + 1] - b[s], b[s])
        vals.append(v.to(mesh.home))
        flats.append(f.to(mesh.home))
    vals, flat = _order(torch.cat(vals), torch.cat(flats), cap)
    pos, subvox, good = map_owned(
        blocks, lambda blk, lo, seeds: localize(
            blk, seeds, real_shape, float(cfg.max_offset), n_iter, lo,
            shape[0]),
        flat_seeds(flat, shape, real_shape, eb))
    return Anchors(coords=pos, subvox=subvox, values=vals,
                   valid=(vals > cfg.threshold_abs) & good)
