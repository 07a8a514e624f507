"""Descriptor matching + pose repeatability scoring (port of
mad_tpu/engine/match.py).

Replaces MaD._match_dsc (mad/MaD.py:414-453):
  * cosine similarity of every (subunit, map) descriptor pair, one float32
    matrix product;
  * pairs above cc_threshold, at most ``row_cap`` per subunit row and
    ``max_pairs`` overall, in the order of mad_tpu's per-row + global
    top_k (value descending, ties by subunit row then map column): K10's
    head;
  * per pair, relative pose R = R_lo^T @ R_hi and repeatability = % of the
    subunit's unique anchor cloud landing within ``anchor_dist`` of a map
    anchor after the pose: an approximate score for every pair from a
    dilated occupancy field of the map anchors (K11, K12), then exact
    nearest-neighbour scores (K13) for the top pairs the clustering
    consumes, selected and gathered on the device (K21), so K12, K21 and
    K13 run with no host step between them and the scores come back in
    one pull.

With a mesh (``parallel.mesh``, mad_tpu's ``match_pairs`` /
``_compiled_approx_repeat`` / ``_compiled_exact_repeat`` under a mesh):
the subunit rows are cut into blocks, one a shard, each shard runs the
product and K10's head on its block, and the second entry of K10's source
(``pair_merge``) keeps the global head on the mesh's home device; K11 is
built once per distinct device, K12 runs over each shard's block of the
pairs and K13 over its block of the exactly scored rows, gathered on the
home device. K21 selects those rows on the home device over the gathered
scores, and the final order stays on the host, so the table is the
single-device one. A shard's product is taken
at the whole table's row count (its rows in a zero frame): cuBLAS picks
its kernel by the row count, and a block of rows multiplied alone comes
out in other roundings than the same rows of the whole product.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.config import MatchConfig, bucket
from ..kernels.approx import approx_repeat
from ..kernels.field import anchor_field
from ..kernels.pairs import (head_length, pair_head, pair_merge,
                             split_pair_keys)
from ..kernels.repeat import exact_repeat
from ..kernels.select_exact import select_exact
from ..parallel.mesh import (Mesh, map_rows, replicate, run_device,
                             shard_bounds)
from ..utils import sanitize
from .pipeline import DescriptorSet


@dataclass
class MatchTable:
    """Per-pair match data, sorted by repeatability (descending)."""

    cc: np.ndarray            # (P,) descriptor cosine similarity
    repeat: np.ndarray        # (P,) repeatability %
    hi_idx: np.ndarray        # (P,) row into the subunit DescriptorSet
    lo_idx: np.ndarray        # (P,) row into the map DescriptorSet
    rot: np.ndarray           # (P, 3, 3) pose rotation R = R_lo^T R_hi
    hi_coord: np.ndarray      # (P, 3) subunit anchor of the pair (A)
    lo_coord: np.ndarray      # (P, 3) map anchor of the pair (A)
    hi_cloud: np.ndarray      # (A_hi, 3) unique subunit anchor coords (A)
    lo_cloud: np.ndarray      # (A_lo, 3) unique map anchor coords (A)

    @property
    def n(self) -> int:
        return self.cc.shape[0]

    def take(self, rows: np.ndarray, repeat: Optional[np.ndarray] = None
             ) -> "MatchTable":
        """Row-subset view (same clouds); optionally with re-scored
        repeatabilities for the taken rows."""
        return MatchTable(
            cc=self.cc[rows],
            repeat=self.repeat[rows] if repeat is None else repeat,
            hi_idx=self.hi_idx[rows], lo_idx=self.lo_idx[rows],
            rot=self.rot[rows], hi_coord=self.hi_coord[rows],
            lo_coord=self.lo_coord[rows],
            hi_cloud=self.hi_cloud, lo_cloud=self.lo_cloud)


def _sharded_head(hi: torch.Tensor, lo: torch.Tensor, cfg: MatchConfig,
                  mesh: Mesh) -> torch.Tensor:
    """K10's head of hi @ lo.T over the mesh: per shard its block of rows
    (in a zero frame of all rows, on the shard's device) times the map
    rows, its head with the block's first row; then the global head of the
    shards' heads (pair_merge) on the home device."""
    dh, dl = hi.shape[0], lo.shape[0]
    lo_d = replicate(mesh, lambda d: lo.to(d))
    b = shard_bounds(dh, len(mesh))
    heads = []
    for s, dev in enumerate(mesh.devices):
        if b[s + 1] == b[s]:
            continue
        frame = torch.zeros(hi.shape, dtype=hi.dtype, device=dev)
        frame[b[s]:b[s + 1]] = hi[b[s]:b[s + 1]]
        sim = (frame @ lo_d[dev].T)[b[s]:b[s + 1]]
        del frame
        heads.append(pair_head(sim, cfg.row_cap, cfg.max_pairs,
                               float(cfg.cc_threshold), b[s], dh
                               ).to(mesh.home))
        del sim
    keys = torch.cat(heads) if heads else torch.zeros(
        0, dtype=torch.int64, device=mesh.home)
    return pair_merge(keys, head_length(dh, dl, cfg.row_cap, cfg.max_pairs))


def match_pairs(map_set: DescriptorSet, sub_set: DescriptorSet,
                cfg: MatchConfig, mesh: Optional[Mesh] = None
                ) -> Optional[dict]:
    """Similarity stage + host pose data (mad/MaD.py:414-438): the cosine
    product (torch.matmul), the pair head (K10's head; with a mesh per
    shard of subunit rows, then merged) and its one pull; None when no
    pair clears the threshold."""
    if mesh is None:
        sim = sub_set.desc_norm @ map_set.desc_norm.T
        keys = pair_head(sim, cfg.row_cap, cfg.max_pairs,
                         float(cfg.cc_threshold))
    else:
        keys = _sharded_head(sub_set.desc_norm, map_set.desc_norm, cfg,
                             mesh)
    ccs, rows, cols = split_pair_keys(keys.cpu().numpy(),
                                      map_set.desc_norm.shape[0])
    sanitize.check_host("match.similarity", ccs)
    if len(rows) == 0:
        return None
    hi_cloud = np.unique(sub_set.subv_coords[rows], axis=0)
    lo_cloud = np.unique(map_set.subv_coords[cols], axis=0)
    r_hi = sub_set.rfinal[rows]
    r_lo = map_set.rfinal[cols]
    rot = np.einsum("pji,pjk->pik", r_lo, r_hi)  # R_lo^T @ R_hi
    return dict(ccs=ccs, rows=rows, cols=cols, rot=rot,
                hi_coord=sub_set.subv_coords[rows],
                lo_coord=map_set.subv_coords[cols],
                hi_cloud=hi_cloud, lo_cloud=lo_cloud)


def anchor_voxels(lo_cloud: np.ndarray, grid_origin, voxsp: float,
                  grid_shape) -> np.ndarray:
    """(A_lo, 3) int32 voxel of each map anchor, clipped to the grid (the
    field's input, mad_tpu/engine/match.py:366-368)."""
    origin32 = np.asarray(grid_origin, dtype=np.float32)
    return np.clip(np.round(
        (lo_cloud.astype(np.float32) - origin32) / voxsp).astype(np.int64),
        0, np.asarray(grid_shape) - 1).astype(np.int32)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                           device=device)


def _empty_table() -> MatchTable:
    e = np.zeros(0)
    e3 = np.zeros((0, 3))
    return MatchTable(cc=e, repeat=e, hi_idx=e.astype(int),
                      lo_idx=e.astype(int), rot=np.zeros((0, 3, 3)),
                      hi_coord=e3, lo_coord=e3, hi_cloud=e3, lo_cloud=e3)


def match_descriptors(map_set: DescriptorSet, sub_set: DescriptorSet,
                      grid_shape, grid_origin, voxsp: float,
                      cfg: MatchConfig, min_exact: int = 0,
                      device=None, mesh: Optional[Mesh] = None
                      ) -> MatchTable:
    """hi = subunit, lo = map (reference naming, mad/MaD.py:414).

    min_exact: the clustering consumes the top pairs by repeatability, so
    at least that many leading pairs get exact scores. With a mesh the
    work is sharded (module docstring) and ``device`` is its home."""
    device = run_device(mesh, device, map_set.desc_norm.device)
    pairs = match_pairs(map_set, sub_set, cfg, mesh)
    if pairs is None:
        return _empty_table()
    ccs, rows, cols = pairs["ccs"], pairs["rows"], pairs["cols"]
    rot, hi_coord, lo_coord = (pairs["rot"], pairs["hi_coord"],
                               pairs["lo_coord"])
    hi_cloud, lo_cloud = pairs["hi_cloud"], pairs["lo_cloud"]
    shards = mesh or Mesh((device,))

    # Stage A: approximate repeatability of every pair (K11 once per
    # device, replicated with the anchor voxels that K12's coarse map
    # takes; K12 over each shard's pairs), gathered on the home device.
    r_vox = max(1, int(round(cfg.anchor_dist / voxsp)))
    vox = anchor_voxels(lo_cloud, grid_origin, voxsp, grid_shape)
    inv = float(np.float32(1.0 / voxsp))

    def rep_in_on(d):
        v = torch.as_tensor(vox, device=d)
        return (anchor_field(tuple(grid_shape), v, r_vox), v, r_vox,
                _f32(hi_cloud, d), _f32(grid_origin, d))

    rep_in = replicate(shards, rep_in_on)
    poses = [_f32(a, shards.home) for a in (rot, hi_coord, lo_coord)]
    rep_d = map_rows(shards, len(rows), lambda d, a, e: approx_repeat(
        *rep_in[d], inv, *[t[a:e].to(d) for t in poses]))

    # Stage B: exact scores for the ordering-critical top pairs, selected
    # and gathered by K21 on the home device. Selection count is
    # mesh-independent, so a mesh run re-scores the same rows.
    want = max(cfg.exact_top, min_exact)
    if want > 0:
        n_use = min(bucket(want, 64), len(rows))
        top_d, *picked = select_exact(rep_d, *poses, n_use)
        erep_d = _exact(shards, hi_cloud, lo_cloud, *picked,
                        cfg.anchor_dist)
        top, rep, erep = _pull(top_d, rep_d, erep_d)
        rep[top] = erep
    else:
        rep = rep_d.cpu().numpy()
    sanitize.check_host("match.repeat", rep)
    order = np.argsort(-rep, kind="stable")
    return MatchTable(
        cc=ccs[order], repeat=rep[order], hi_idx=rows[order],
        lo_idx=cols[order], rot=rot[order], hi_coord=hi_coord[order],
        lo_coord=lo_coord[order], hi_cloud=hi_cloud, lo_cloud=lo_cloud)


def _pull(*parts: torch.Tensor):
    """Tensors of one device as numpy arrays, in one device-to-host copy
    (the 8-byte ones first, so each lands aligned for its type)."""
    host = torch.cat([p.reshape(-1).view(torch.int32) for p in parts]).cpu()
    out, at = [], 0
    for p in parts:
        n = p.numel() * p.element_size() // 4
        out.append(host[at:at + n].view(p.dtype).reshape(p.shape).numpy())
        at += n
    return out


def _exact(shards: Mesh, hi_cloud, lo_cloud, rot, hi_coord, lo_coord,
           anchor_dist: float) -> torch.Tensor:
    """K13 over each shard's block of the given rows (float32 tensors or
    arrays; clouds replicated once per device), gathered on the mesh's
    home device."""
    clouds = replicate(shards, lambda d: (_f32(hi_cloud, d),
                                          _f32(lo_cloud, d)))
    rows = lambda a, d: (a.to(d) if isinstance(a, torch.Tensor)
                         else _f32(a, d))
    return map_rows(shards, len(rot), lambda d, a, e: exact_repeat(
        *clouds[d], rows(rot[a:e], d), rows(hi_coord[a:e], d),
        rows(lo_coord[a:e], d), float(anchor_dist)))


def exact_rescore(table: MatchTable, rows: np.ndarray, anchor_dist: float,
                  device, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Exact repeatability of an arbitrary row subset of ``table`` (the
    rescue pass reaches below the exact-scored prefix), with a mesh over
    its shards' blocks of the rows."""
    if len(rows) == 0:
        return np.zeros(0, np.float32)
    return _exact(mesh or Mesh((torch.device(device),)), table.hi_cloud,
                  table.lo_cloud, table.rot[rows], table.hi_coord[rows],
                  table.lo_coord[rows], anchor_dist).cpu().numpy()
