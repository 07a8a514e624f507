"""Per-subunit docking: match -> filter -> refine -> score -> dedup (port
of the split path of mad_tpu/engine/docking.py:596-706).

Replaces MaD._match_filter_refine / _refine_filtered_solutions
(mad/MaD.py:371-411, 556-629), with the rescue rounds of the original:
after the first round, descriptor pairs whose map anchor no accepted
solution explains get a fresh clustering budget under the same quality
gates. The port has one path; mad_tpu's fused dock programs compute the
same solutions and are not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..core.config import FilterConfig, MadConfig
from ..core.grid import DensityGrid
from ..core.structure import Structure
from ..timing import stage
from ..kernels.cluster import cluster_select, gate_threshold, split_selection
from .cluster import Candidate
from .match import MatchTable, exact_rescore, match_descriptors
from .pipeline import DescriptorSet
from .refine import refine_candidates
from .score import ccc_structures


@dataclass
class Solution:
    """One refined, deduplicated docking solution."""

    structure: Structure           # refined pose
    corresp_anchors: np.ndarray    # (K, 3) matched anchors post-refine
    repeat: float
    weight: int
    ccc: float
    members: List[np.ndarray] = field(default_factory=list)
    score: float = 0.0             # RWmCC = repeat * weight * ccc


def start_poses(candidates: List[Candidate], sub_struct: Structure
                ) -> np.ndarray:
    """(C, N, 3) float32 start coords of the candidates' poses."""
    x0 = sub_struct.coords
    return np.stack([
        (x0 - c.hi_coord) @ c.rot.T + c.lo_coord for c in candidates
    ]).astype(np.float32)


def cluster_candidates(table: MatchTable, hi_bins: np.ndarray,
                       lo_bins: np.ndarray, cfg: FilterConfig,
                       n_samples: int, device,
                       best_repeat: float = None) -> List[Candidate]:
    """engine/cluster.filter_pairs with its scan, weights, gates and
    candidate order on ``device`` (K14), one pull; the host builds the
    candidates, members included, from the selection. Same arguments and
    result as filter_pairs."""
    if table.n == 0:
        return []
    n = min(n_samples, table.n)
    X = table.hi_cloud
    mu = X.mean(axis=0)
    M = (X.T @ X) / X.shape[0]
    if best_repeat is None:
        best_repeat = table.repeat[0]

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=device)

    sel = cluster_select(
        put(table.rot[:n], np.float32), put(table.hi_coord[:n], np.float64),
        put(table.lo_coord[:n], np.float64),
        put(table.repeat[:n], np.float32), put(mu, np.float64),
        put(M, np.float64), cfg.rmsd_cloud, cfg.weight_threshold,
        gate_threshold(best_repeat, cfg.min_repeat, cfg.repeat_frac))
    assign, found, weights, cands, _n = split_selection(sel.cpu().numpy(), n)
    # each member row: [hi_coord(3), lo_coord(3), hi_bin, lo_bin]
    rows = np.concatenate([table.hi_coord[:n], table.lo_coord[:n],
                           hi_bins[:n, None], lo_bins[:n, None]], axis=1)
    out = []
    for c in cands:
        row, w = int(found[c]), int(weights[c])
        rep = table.repeat[row]
        out.append(Candidate(
            hi_coord=table.hi_coord[row], lo_coord=table.lo_coord[row],
            rot=table.rot[row], cc=float(table.cc[row]), weight=w,
            repeat=float(rep), score=float(rep * w),
            members=list(rows[assign == c])))
    return out


def _refine_and_merge(candidates: List[Candidate], solutions: List[Solution],
                      sub_struct: Structure, dmap: DensityGrid,
                      table: MatchTable, cfg: MadConfig, device,
                      timings=None) -> int:
    """Refine candidate poses and merge them into ``solutions`` (CA-RMSD
    dedup with weight merging, mad/MaD.py:592-620). Returns the number of
    genuinely new solutions appended."""
    starts = start_poses(candidates, sub_struct)
    with stage(timings, "refine", device):
        res = refine_candidates(dmap, starts, cfg.refine, device=device)
    return _merge_refined(res, candidates, solutions, sub_struct, dmap,
                          table, cfg)


def _merge_refined(res, candidates: List[Candidate],
                   solutions: List[Solution], sub_struct: Structure,
                   dmap: DensityGrid, table: MatchTable,
                   cfg: MadConfig) -> int:
    """Post-refinement host half (mad_tpu/engine/docking.py:61-112): the
    refined pose is the composition of the candidate's start pose with the
    refinement's rot/trans, in float64 on the float32 results; the
    repeatability is re-scored on it, then CA-RMSD dedup + weight merge."""
    x032 = sub_struct.coords.astype(np.float32).astype(np.float64)
    lo_tree = cKDTree(table.lo_cloud)
    thresh = dmap.voxsp * 1.5
    refined: List[tuple] = []
    for i, cand in enumerate(candidates):
        if res.failed[i]:
            continue  # numerically failed candidate (NaN guard)
        A = cand.rot.T.astype(np.float64)
        b = cand.lo_coord - cand.hi_coord.astype(np.float64) @ A
        center = (x032 @ A + b).mean(axis=0)
        R = np.asarray(res.rot[i], dtype=np.float64)
        t = np.asarray(res.trans[i], dtype=np.float64)
        s_a = ((table.hi_cloud @ A + b) - center) @ R + center + t
        d, _ = lo_tree.query(s_a, distance_upper_bound=thresh)
        hits = d <= thresh
        repeat = 100.0 * np.count_nonzero(hits) / table.hi_cloud.shape[0]
        if repeat <= 0:
            continue
        refined.append((res.coords[i], s_a[hits], repeat, cand.weight,
                        cand.members))

    n_new = 0
    for coords, corresp, repeat, weight, members in refined:
        struct = sub_struct.with_coords(coords)
        merged = False
        if solutions:
            rmsds = [struct.rmsd_ca_with(s.structure) for s in solutions]
            j = int(np.argmin(rmsds))
            if rmsds[j] < cfg.refine.dedup_rmsd:
                solutions[j].weight += weight
                solutions[j].members.extend(members)
                merged = True
        if not merged:
            solutions.append(Solution(
                structure=struct, corresp_anchors=corresp, repeat=repeat,
                weight=weight, ccc=0.0, members=list(members)))
            n_new += 1
    return n_new


def _finalize_solutions(solutions: List[Solution], sub_struct: Structure,
                        dmap: DensityGrid, resolution: float,
                        cfg: MadConfig, device, timings=None
                        ) -> List[Solution]:
    """CC-score, RWmCC-rank (mad_tpu/engine/docking.py:579-593)."""
    if solutions:
        with stage(timings, "score", device):
            coords_b = np.stack([s.structure.coords for s in solutions])
            cccs = ccc_structures(dmap, coords_b, sub_struct.masses,
                                  resolution, shape_bucket=cfg.shape_bucket,
                                  device=device)
        for s, c in zip(solutions, cccs):
            s.ccc = float(c)
    for s in solutions:
        s.score = s.repeat * s.weight * s.ccc
    solutions.sort(key=lambda s: s.score, reverse=True)
    return solutions


def dock_structure(map_set: DescriptorSet, sub_set: DescriptorSet,
                   sub_struct: Structure, dmap: DensityGrid,
                   resolution: float, cfg: MadConfig, n_copies: int = 1,
                   verbose: bool = False, device=None,
                   timings: Optional[dict] = None,
                   on_filtered=None) -> List[Solution]:
    """Dock one subunit into the map on ``device`` (default: the map's);
    returns scored unique solutions, best first. ``timings``: optional
    dict that collects seconds per stage (match, cluster, refine, score).
    ``on_filtered``: optional callback receiving the first round's filtered
    pre-refinement Candidate list (the reference's pre_solutions hook,
    mad/MaD.py:404-405, 891-921)."""
    device = torch.device(device) if device is not None else dmap.device
    n_samples = cfg.filter.n_samples * n_copies
    with stage(timings, "match", device):
        # Clustering consumes the top n_samples pairs by repeatability;
        # their ordering must be exact, not approximate (min_exact).
        table = match_descriptors(map_set, sub_set, dmap.shape, dmap.origin,
                                  dmap.voxsp, cfg.match,
                                  min_exact=n_samples, device=device)
    if verbose:
        print(f"MaD> {table.n} descriptor pairs above "
              f"cc={cfg.match.cc_threshold:.2f}")
    if table.n == 0:
        return []

    with stage(timings, "cluster", device):
        candidates = cluster_candidates(
            table, sub_set.main_bin[table.hi_idx],
            map_set.main_bin[table.lo_idx], cfg.filter, n_samples, device)
    if verbose:
        print(f"MaD> {len(candidates)} filtered pose candidates")
    if not candidates:
        return []
    if on_filtered is not None:
        on_filtered(candidates)

    solutions: List[Solution] = []
    _refine_and_merge(candidates, solutions, sub_struct, dmap, table, cfg,
                      device, timings)

    # Rescue rounds: pairs whose map anchor no accepted solution explains
    # get a fresh n_samples budget under the same gates; the repeat gate
    # stays relative to the FULL table's best. Stops when a round adds
    # nothing.
    best_repeat = float(table.repeat[0])
    for _ in range(max(0, int(cfg.filter.rescue_rounds))):
        if not solutions:
            break
        atoms = np.concatenate([s.structure.coords for s in solutions])
        d, _ = cKDTree(atoms).query(
            table.lo_coord, distance_upper_bound=cfg.match.anchor_dist)
        elig = np.nonzero(d > cfg.match.anchor_dist)[0]
        if not len(elig):
            break
        top = elig[:n_samples]
        # Below the first-round prefix repeatabilities are approximate;
        # re-score exactly what this round consumes, then re-rank.
        with stage(timings, "match", device):
            erep = exact_rescore(table, top, cfg.match.anchor_dist, device)
        order = np.argsort(-erep, kind="stable")
        sub_table = table.take(top[order], repeat=erep[order])
        with stage(timings, "cluster", device):
            cands = cluster_candidates(
                sub_table, sub_set.main_bin[sub_table.hi_idx],
                map_set.main_bin[sub_table.lo_idx], cfg.filter, n_samples,
                device, best_repeat=best_repeat)
        if not cands:
            break
        n_new = _refine_and_merge(cands, solutions, sub_struct, dmap, table,
                                  cfg, device, timings)
        if verbose and n_new:
            print(f"MaD> Rescue round: {n_new} additional solution(s) in "
                  "unexplained density")
        if n_new == 0:
            break

    return _finalize_solutions(solutions, sub_struct, dmap, resolution, cfg,
                               device, timings)
