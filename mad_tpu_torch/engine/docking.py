"""Per-subunit docking: match -> filter -> refine -> score -> dedup (port
of the split path of mad_tpu/engine/docking.py:596-706).

Replaces MaD._match_filter_refine / _refine_filtered_solutions
(mad/MaD.py:371-411, 556-629), with the rescue rounds of the original:
after the first round, descriptor pairs whose map anchor no accepted
solution explains get a fresh clustering budget under the same quality
gates. The port has one path; mad_tpu's fused dock programs compute the
same solutions and are not carried over.

With a mesh (``parallel.mesh``; mad_tpu's ``dock_structure(mesh=)`` and
the three ``run_sharded`` chains of its engine/dock_fused.py) the stages
shard as there, gathered on the mesh's home device: the similarity rows,
the pairs and the exactly scored rows in ``match_descriptors`` (K10's head
per shard and its merge, K11 once per device, K12, K13), the candidates in
``refine_candidates`` (K15), the lanes, cloud points and table rows of
K16's lane and eligibility stages, and the rescue round's rows
(``exact_rescore``, K13). K14's cluster selection runs whole, once on the
home device on the gathered table, as mad_tpu runs its scan replicated
after an all-gather (dock_fused.py:198-218, 278-287); so do K16's dedup
scan and compaction and the CC score (K17), which mad_tpu does not shard
either. The solutions are the single-device ones.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .. import cache
from ..core.config import FilterConfig, MadConfig
from ..core.grid import DensityGrid
from ..core.structure import Structure
from ..device import resolve
from ..timing import stage
from ..utils import sanitize
from ..kernels.cluster import cluster_select, gate_threshold, split_selection
from ..kernels.post import post, split_post
from ..parallel.mesh import Mesh, run_device
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


def selection_args(table: MatchTable, cfg: FilterConfig, n: int, device,
                   best_repeat: float = None) -> tuple:
    """K14's arguments (kernels/cluster.cluster_select) for the first n
    rows of a repeat-ordered table: the rows' poses and repeats, the
    moments of the subunit cloud, the thresholds of ``cfg`` and the repeat
    gate of ``best_repeat`` (the table's first repeat by default)."""
    X = table.hi_cloud
    mu = X.mean(axis=0)
    M = (X.T @ X) / X.shape[0]
    if best_repeat is None:
        best_repeat = table.repeat[0]

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=device)

    return (put(table.rot[:n], np.float32),
            put(table.hi_coord[:n], np.float64),
            put(table.lo_coord[:n], np.float64),
            put(table.repeat[:n], np.float32), put(mu, np.float64),
            put(M, np.float64), cfg.rmsd_cloud, cfg.weight_threshold,
            gate_threshold(best_repeat, cfg.min_repeat, cfg.repeat_frac))


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
    sel = cluster_select(*selection_args(table, cfg, n, device, best_repeat))
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
                      timings=None, n_top: int = 0,
                      mesh: Optional[Mesh] = None):
    """Refine candidate poses and merge them into ``solutions`` (CA-RMSD
    dedup with weight merging, mad/MaD.py:592-620). Returns the number of
    genuinely new solutions appended and the first ``n_top`` table rows
    that the next rescue round may take (none when n_top is 0)."""
    starts = start_poses(candidates, sub_struct)
    with stage(timings, "refine", device):
        res = refine_candidates(dmap, starts, cfg.refine, device=device,
                                mesh=mesh)
    with stage(timings, "post", device):
        return _merge_refined(res, candidates, solutions, sub_struct, dmap,
                              table, cfg, device, n_top, mesh)


def _merge_refined(res, candidates: List[Candidate],
                   solutions: List[Solution], sub_struct: Structure,
                   dmap: DensityGrid, table: MatchTable, cfg: MadConfig,
                   device, n_top: int = 0, mesh: Optional[Mesh] = None):
    """Post-refinement half (mad_tpu/engine/docking.py:61-112): the refined
    pose is the composition of the candidate's start pose with the
    refinement's rot/trans, in float64 on the float32 results; the
    repeatability is re-scored on it, then CA-RMSD dedup + weight merge;
    with ``n_top``, the rescue eligibility of the table's rows after the
    merge. K16 computes all of it on ``device`` (its lane and eligibility
    stages over the mesh's shards) and one pull brings it back; the host
    rebuilds the Solution records."""
    N = sub_struct.coords.shape[0]
    x032 = sub_struct.coords.astype(np.float32).astype(np.float64)
    idx = sub_struct.ca_idx if len(sub_struct.ca_idx) else np.arange(N)
    prev = (np.stack([s.structure.coords for s in solutions]) if solutions
            else np.zeros((0, N, 3)))

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                               device=device)

    vec = post(*res.device_out,
               put([c.rot for c in candidates]),
               put([c.hi_coord for c in candidates]),
               put([c.lo_coord for c in candidates]), put(x032),
               put(table.hi_cloud), put(table.lo_cloud), put(prev),
               torch.as_tensor(np.asarray(idx, dtype=np.int64),
                               device=device),
               dmap.voxsp * 1.5, cfg.refine.dedup_rmsd,
               put(table.lo_coord if n_top else np.zeros((0, 3))),
               cfg.match.anchor_dist, n_top, mesh)
    a_hi = table.hi_cloud.shape[0]
    s_a, hits, counts, accepted, slot, top = split_post(
        vec.cpu().numpy(), len(candidates), a_hi, n_top)
    n_new = 0
    for i, cand in enumerate(candidates):
        if accepted[i]:
            solutions.append(Solution(
                structure=sub_struct.with_coords(res.coords[i]),
                corresp_anchors=s_a[i][hits[i]],
                repeat=100.0 * counts[i] / a_hi, weight=cand.weight,
                ccc=0.0, members=list(cand.members)))
            n_new += 1
        elif slot[i] >= 0:
            solutions[slot[i]].weight += cand.weight
            solutions[slot[i]].members.extend(cand.members)
    return n_new, top


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
                   verbose: bool = True, match_cache: str = None, *,
                   on_filtered=None, mesh: Optional[Mesh] = None,
                   device=None, timings: Optional[dict] = None
                   ) -> List[Solution]:
    """Dock one subunit into the map on ``device`` (the card unless named);
    returns scored unique solutions, best first. ``timings``: optional
    dict that collects seconds per stage (match, cluster, refine, post,
    score).
    ``match_cache``: optional path (mad_tpu's): when the file exists the
    match table is loaded from it (``cache.load_matching``, a file that
    mad_tpu or the port wrote) and the first round's match stage is
    skipped; otherwise the table that ``match_descriptors`` returns is
    saved to it. The rescue rounds re-score from the table as usual.
    ``on_filtered``: optional callback receiving the first round's filtered
    pre-refinement Candidate list (the reference's pre_solutions hook,
    mad/MaD.py:404-405, 891-921).
    ``mesh``: shard the dock over it (module docstring); ``device`` is
    then its home device (naming another raises)."""
    device = (run_device(mesh, device) if mesh is not None
              else resolve(device))
    n_samples = cfg.filter.n_samples * n_copies
    if match_cache and os.path.exists(match_cache):
        table = cache.load_matching(match_cache)
        if verbose:
            print(f"MaD> Loaded matched descriptor pairs from {match_cache}")
    else:
        with stage(timings, "match", device):
            # Clustering consumes the top n_samples pairs by repeatability;
            # their ordering must be exact, not approximate (min_exact).
            table = match_descriptors(map_set, sub_set, dmap.shape,
                                      dmap.origin, dmap.voxsp, cfg.match,
                                      min_exact=n_samples, device=device,
                                      mesh=mesh)
        if match_cache:
            cache.save_matching(table, match_cache)
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

    # Rescue rounds: pairs whose map anchor no accepted solution explains
    # get a fresh n_samples budget under the same gates; the repeat gate
    # stays relative to the FULL table's best. Stops when a round adds
    # nothing. Each round's K16 launch also finds the rows that the next
    # round may take.
    rounds = max(0, int(cfg.filter.rescue_rounds))
    solutions: List[Solution] = []
    _, top = _refine_and_merge(candidates, solutions, sub_struct, dmap,
                               table, cfg, device, timings,
                               n_samples if rounds else 0, mesh)
    best_repeat = float(table.repeat[0])
    for r in range(rounds):
        if not solutions or not len(top):
            break
        # Below the first-round prefix repeatabilities are approximate;
        # re-score exactly what this round consumes, then re-rank.
        with stage(timings, "match", device):
            erep = exact_rescore(table, top, cfg.match.anchor_dist, device,
                                 mesh)
            sanitize.check_host("match.repeat", erep)
        order = np.argsort(-erep, kind="stable")
        sub_table = table.take(top[order], repeat=erep[order])
        with stage(timings, "cluster", device):
            cands = cluster_candidates(
                sub_table, sub_set.main_bin[sub_table.hi_idx],
                map_set.main_bin[sub_table.lo_idx], cfg.filter, n_samples,
                device, best_repeat=best_repeat)
        if not cands:
            break
        n_new, top = _refine_and_merge(
            cands, solutions, sub_struct, dmap, table, cfg, device, timings,
            n_samples if r + 1 < rounds else 0, mesh)
        if verbose and n_new:
            print(f"MaD> Rescue round: {n_new} additional solution(s) in "
                  "unexplained density")
        if n_new == 0:
            break

    return _finalize_solutions(solutions, sub_struct, dmap, resolution, cfg,
                               device, timings)
