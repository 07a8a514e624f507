"""Describe pipeline: density grid -> descriptor set (port of
mad_tpu/engine/pipeline.py, single device).

Per octave: LoG -> anchors (K4 + K5 Newton) -> gradient field (K3) ->
orientation (K6) -> descriptors (K7) -> kept lanes; then the kept rows of
all octaves are gathered, concatenated and L2-normalized in one launch of
K8 (mad/MaD.py:358-368). Every buffer is sized from the real
counts of the run, so there are no static frames, overflow redos or
approximate-peak guards.

Capacity mode (``mesh=``, mad_tpu's ``_describe_octave_mesh``,
engine/pipeline.py:541-610): the octave fields stay x-slabs over the mesh
through detect, orient and describe (``ops.scalespace.ShardedOctave``,
``parallel.volume``; the LoG and the gradient field as one halo block a
shard, each built once), so no shard holds a whole field; the anchor table,
the frames and the descriptor rows come back to the mesh's first device in
the single-device order (anchor slot, main, sec), and K8 and everything
after it are shared with the single-device path. The ``DescriptorSet`` is
the single-device one, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.config import MadConfig
from ..core.grid import DensityGrid
from ..core.structure import Structure
from ..device import resolve
from ..kernels.gather_norm import gather_norm
from ..ops.describe import describe_anchors
from ..ops.detect import detect_anchors
from ..ops.orient import orient_anchors
from ..ops.scalespace import gradient, iter_octaves
from ..ops.simulate import simulate_density
from ..parallel.mesh import run_device
from ..parallel.volume import sharded_gradient
from ..utils import sanitize


@dataclass
class DescriptorSet:
    """Dense descriptor table for one structure.

    ``desc`` and ``desc_norm`` stay on the device; the per-row metadata is
    host numpy. ``info`` layout of the reference h5 schema
    (mad/MaD.py:848-859): ``desc`` is (N, subregions*subeqsp) int16 counts.
    """

    desc: torch.Tensor        # (N, D) int16 counts
    desc_norm: torch.Tensor   # (N, D) float32 unit rows
    coords: np.ndarray        # (N, 3) float32 voxel coords in own octave
    map_coords: np.ndarray    # (N, 3) float64 on-lattice coords (A)
    subv_coords: np.ndarray   # (N, 3) float64 subvoxel coords (A)
    rfinal: np.ndarray        # (N, 3, 3) float32
    octave: np.ndarray        # (N,) int32
    anchor_id: np.ndarray     # (N,) int32 global anchor index
    main_bin: np.ndarray      # (N,) int32
    sec_bin: np.ndarray       # (N,) int32
    eqsp_size: int = 112
    subeqsp_size: int = 16
    name: str = ""
    n_rows: Optional[int] = None   # real row count (== desc.shape[0] here)

    @property
    def n(self) -> int:
        return self.desc.shape[0]

    def unique_anchor_coords(self, rows: Optional[np.ndarray] = None
                             ) -> np.ndarray:
        """Unique subvoxel anchor coordinates (sorted, np.unique parity with
        mad/MaD.py:427-428)."""
        c = self.subv_coords if rows is None else self.subv_coords[rows]
        return np.unique(c, axis=0)


@dataclass
class OctaveLanes:
    """An octave's gradient field and its oriented lanes, one lane per
    valid (anchor, main bin, secondary bin), in (anchor, main, sec) order:
    the input of the descriptor kernel."""

    grad: object              # (X, Y, Z, 3) gradient of the smoothed
                              # octave (with a mesh, its halo Blocks)
    coords: torch.Tensor      # (L, 3) int64 anchor voxel coords
    rfinal: torch.Tensor      # (L, 3, 3) float32 frames
    slot: torch.Tensor        # (L,) detection slot of the lane's anchor
    subvox: torch.Tensor      # (L, 3) subvoxel anchor coords
    main: torch.Tensor        # (L,) main bin
    sec: torch.Tensor         # (L,) secondary bin


def grad_halo(cfg: MadConfig, upsampled: bool) -> int:
    """Rows of the gradient field that orientation and the descriptors
    read beyond an anchor's x: radius * stride * 2, mad_tpu's halo."""
    stride = 2 if upsampled else 1
    return max((c.patch_size - c.patch_size % 2) // 2
               for c in (cfg.orient, cfg.describe)) * stride * 2


def octave_index(octv) -> int:
    """The octave's place in ``iter_octaves``' order (the upsampled one
    first), as the stage sanitizer names it."""
    return int(not octv.upsampled and octv.cfg.oct_mode == "both")


def octave_lanes(octv, cfg: MadConfig, mesh=None) -> OctaveLanes:
    """LoG -> anchors (K4 + K5) -> gradient field (K3) -> orientation;
    the stage sanitizer watches each stage (mad_tpu's names,
    engine/pipeline.py:321-401)."""
    real, oi = octv.real_shape, octave_index(octv)
    log_vol, gauss = octv.log_gauss()
    if mesh is not None:
        sanitize.watch(f"scalespace.log[o{oi}]", log_vol)
    anch = detect_anchors(log_vol, real, cfg.detect, mesh)
    sanitize.watch(f"detect[o{oi}]", anch.subvox)
    del log_vol
    if mesh is None:
        grad = gradient(gauss, octv.grad_dtype())
        sanitize.watch(f"scalespace.grad[o{oi}]", grad)
    else:
        grad = sharded_gradient(gauss, octv.grad_dtype(), mesh,
                                grad_halo(cfg, octv.upsampled))
        sanitize.watch("scalespace.grad[mesh]", grad)
    del gauss
    vidx = torch.nonzero(anch.valid).reshape(-1)     # slots of valid anchors
    coords_v = anch.coords[vidx]
    mains, secs, rfin, ok = orient_anchors(
        grad, coords_v, torch.ones_like(vidx, dtype=torch.bool), real,
        octv.upsampled, cfg.orient, mesh=mesh)
    M, S = cfg.orient.max_main, cfg.orient.max_sec
    sanitize.watch(f"orient[o{oi}]", rfin)
    lanes = torch.nonzero(ok.reshape(-1)).reshape(-1)  # (anchor, main, sec)
    la, lm, ls = lanes // (M * S), (lanes // S) % M, lanes % S
    return OctaveLanes(grad=grad, coords=coords_v[la],
                       rfinal=rfin.reshape(-1, 3, 3)[lanes], slot=vidx[la],
                       subvox=anch.subvox[vidx[la]], main=mains[la, lm],
                       sec=secs[la, lm, ls])


def _describe_octave(octv, cfg: MadConfig, mesh=None):
    """One octave: returns its lanes' device descriptor table, the indices
    of the kept lanes and their host metadata, with anchor ids local to the
    octave's detection order."""
    lanes = octave_lanes(octv, cfg, mesh)
    descs, dok = describe_anchors(
        lanes.grad, lanes.coords, lanes.rfinal,
        torch.ones(lanes.coords.shape[0], dtype=torch.bool,
                   device=lanes.coords.device),
        octv.real_shape, octv.upsampled, cfg.describe, mesh)
    sanitize.watch(f"describe[o{octave_index(octv)}]", descs)
    keep = torch.nonzero(dok).reshape(-1)[: cfg.describe.max_descriptors]
    host = {k: getattr(lanes, k)[keep].cpu().numpy()
            for k in ("coords", "rfinal", "slot", "subvox", "main", "sec")}
    return descs, keep, host


def describe_grid(grid: DensityGrid, cfg: MadConfig, name: str = "",
                  mesh=None, *, device=None) -> DescriptorSet:
    """Anchor / orientation / descriptor chain of a density grid, run on
    ``device`` (default: the grid's own device); with a mesh
    (``parallel.mesh.make_mesh``), in capacity mode over its shards, the
    result on the mesh's first device."""
    device = run_device(mesh, device, grid.device)
    if grid.device != device:
        grid = grid.to(device)
    rows, tables, keeps = [], [], []
    for oi, (origin, octv) in enumerate(iter_octaves(grid, cfg.scalespace,
                                                     mesh)):
        table, keep, h = _describe_octave(octv, cfg, mesh)
        n = h["coords"].shape[0]
        tables.append(table)
        keeps.append(keep)
        rows.append(dict(
            coords=h["coords"].astype(np.float32),
            map_coords=h["coords"] * octv.voxsp + origin,
            subv_coords=(h["subvox"].astype(np.float64) * octv.voxsp
                         + origin),
            rfinal=h["rfinal"],
            octave=np.full(n, oi, dtype=np.int32),
            anchor_id=(oi * cfg.detect.max_anchors + h["slot"]).astype(
                np.int32),
            main_bin=h["main"].astype(np.int32),
            sec_bin=h["sec"].astype(np.int32),
        ))
    sanitize.flush()        # stage-mode NaN checks drain in one pull
    cat = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    desc, desc_norm = gather_norm(tables, keeps)
    return DescriptorSet(
        desc=desc, desc_norm=desc_norm, n_rows=desc.shape[0],
        eqsp_size=cfg.orient.eqsp_size,
        subeqsp_size=cfg.describe.subeqsp_size, name=name or grid.name,
        **cat)


def describe_structure(struct: Structure, resolution: float, voxsp: float,
                       cfg: MadConfig, isovalue: float = 0.0, name: str = "",
                       mesh=None, *, device=None) -> DescriptorSet:
    """PDB path of the describe pipeline: simulate the density on
    ``device`` first (parity: MapSpace PDB_mode, mad/MapSpace.py:73-75),
    the card unless named; with a mesh, described in capacity mode
    (``device`` its first device)."""
    device = run_device(mesh, device) if mesh is not None else resolve(device)
    grid = simulate_density(struct, resolution, voxsp, device=device,
                            isovalue=isovalue, shape_bucket=cfg.shape_bucket)
    return describe_grid(grid, cfg, name=name or struct.source, device=device,
                         mesh=mesh)
