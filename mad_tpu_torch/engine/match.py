"""Descriptor matching + pose repeatability scoring (port of
mad_tpu/engine/match.py, single device).

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
    consumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.config import MatchConfig, bucket
from ..kernels.approx import approx_repeat
from ..kernels.field import anchor_field
from ..kernels.pairs import pair_head, split_pair_keys
from ..kernels.repeat import exact_repeat
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


def match_pairs(map_set: DescriptorSet, sub_set: DescriptorSet,
                cfg: MatchConfig) -> Optional[dict]:
    """Similarity stage + host pose data (mad/MaD.py:414-438): the cosine
    product (torch.matmul), the pair head (K10's head) and its one pull;
    None when no pair clears the threshold."""
    sim = sub_set.desc_norm @ map_set.desc_norm.T
    keys = pair_head(sim, cfg.row_cap, cfg.max_pairs,
                     float(cfg.cc_threshold))
    ccs, rows, cols = split_pair_keys(keys.cpu().numpy(), sim.shape[1])
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
                      device=None) -> MatchTable:
    """hi = subunit, lo = map (reference naming, mad/MaD.py:414).

    min_exact: the clustering consumes the top pairs by repeatability, so
    at least that many leading pairs get exact scores."""
    device = torch.device(device) if device is not None \
        else map_set.desc_norm.device
    pairs = match_pairs(map_set, sub_set, cfg)
    if pairs is None:
        return _empty_table()
    ccs, rows, cols = pairs["ccs"], pairs["rows"], pairs["cols"]
    rot, hi_coord, lo_coord = (pairs["rot"], pairs["hi_coord"],
                               pairs["lo_coord"])
    hi_cloud, lo_cloud = pairs["hi_cloud"], pairs["lo_cloud"]

    # Stage A: approximate repeatability of every pair (K11, K12).
    r_vox = max(1, int(round(cfg.anchor_dist / voxsp)))
    field = anchor_field(tuple(grid_shape), torch.as_tensor(anchor_voxels(
        lo_cloud, grid_origin, voxsp, grid_shape), device=device), r_vox)
    hi_cloud_d, lo_cloud_d = _f32(hi_cloud, device), _f32(lo_cloud, device)
    rot_d, hc_d, lc_d = (_f32(rot, device), _f32(hi_coord, device),
                         _f32(lo_coord, device))
    rep = approx_repeat(field, hi_cloud_d, _f32(grid_origin, device),
                        float(np.float32(1.0 / voxsp)), rot_d, hc_d,
                        lc_d).cpu().numpy()

    # Stage B: exact scores for the ordering-critical top pairs.
    want = max(cfg.exact_top, min_exact)
    if want > 0:
        n_use = min(bucket(want, 64), len(rows))
        top = np.argsort(-rep, kind="stable")[:n_use]
        top_d = torch.as_tensor(top, device=device)
        rep[top] = exact_repeat(hi_cloud_d, lo_cloud_d, rot_d[top_d],
                                hc_d[top_d], lc_d[top_d],
                                float(cfg.anchor_dist)).cpu().numpy()
    order = np.argsort(-rep, kind="stable")
    return MatchTable(
        cc=ccs[order], repeat=rep[order], hi_idx=rows[order],
        lo_idx=cols[order], rot=rot[order], hi_coord=hi_coord[order],
        lo_coord=lo_coord[order], hi_cloud=hi_cloud, lo_cloud=lo_cloud)


def exact_rescore(table: MatchTable, rows: np.ndarray, anchor_dist: float,
                  device) -> np.ndarray:
    """Exact repeatability of an arbitrary row subset of ``table`` (the
    rescue pass reaches below the exact-scored prefix)."""
    if len(rows) == 0:
        return np.zeros(0, np.float32)
    return exact_repeat(
        _f32(table.hi_cloud, device), _f32(table.lo_cloud, device),
        _f32(table.rot[rows], device), _f32(table.hi_coord[rows], device),
        _f32(table.lo_coord[rows], device), float(anchor_dist)
    ).cpu().numpy()
