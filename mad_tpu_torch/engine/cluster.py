"""Copied from mad_tpu/engine/cluster.py (numpy only; MatchTable comes
from the port's engine/match.py).

Greedy pose clustering of matched descriptor pairs.

Replaces MaD._filter_dsc_pairs (mad/MaD.py:456-553): walk the top-n_samples
pairs in repeatability order; a pair joins the nearest existing cluster when
the RMSD between its transformed anchor cloud and the cluster's is below
10 A, otherwise founds a new cluster. Clusters below the weight threshold or
below max(5, 0.3 * best_repeatability) are dropped; survivors sort by
weight * repeatability.

The reference recomputes full transformed clouds and cloud RMSDs per pair
(O(n_samples * clusters * A)); here the cloud RMSD uses its closed form from
the cloud's first/second moments:
    cloud_p = X @ A_p + b_p      (A = R^T, b = lo - hi @ R^T)
    rmsd^2(p, q) = <D D^T, M> + 2 (mu @ D) . d + |d|^2
with D = A_p - A_q, d = b_p - b_q, M = E[x x^T], mu = E[x], so the greedy
scan is trivially cheap on host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..core.config import FilterConfig
from .match import MatchTable


@dataclass
class Candidate:
    """One filtered pose candidate (cluster representative)."""

    hi_coord: np.ndarray      # (3,) subunit anchor (A)
    lo_coord: np.ndarray      # (3,) map anchor (A)
    rot: np.ndarray           # (3, 3) pose rotation R; atoms: (x - h) @ R^T + l
    cc: float
    weight: int
    repeat: float
    score: float              # weight * repeat (mad/MaD.py:547,551)
    members: List[np.ndarray] = field(default_factory=list)
    # each member row: [hi_coord(3), lo_coord(3), hi_bin, lo_bin]


def filter_pairs(table: MatchTable, hi_bins: np.ndarray, lo_bins: np.ndarray,
                 cfg: FilterConfig, n_samples: int,
                 best_repeat: float = None) -> List[Candidate]:
    """hi_bins/lo_bins: main orientation bin per match row (for the
    oriented-anchor debug artifacts, parity mad/MaD.py:498,517-520).

    best_repeat: reference value for the adaptive repeatability gate
    max(min_repeat, repeat_frac * best_repeat); defaults to the table's own
    best. The rescue pass passes the FULL table's best so rescued poses
    clear the same global quality bar as first-round ones."""
    if table.n == 0:
        return []
    n = min(n_samples, table.n)
    X = table.hi_cloud
    mu = X.mean(axis=0)
    M = (X.T @ X) / X.shape[0]

    A = np.swapaxes(table.rot[:n], 1, 2)                         # R^T
    b = table.lo_coord[:n] - np.einsum(
        "pd,pde->pe", table.hi_coord[:n], A)                     # l - h @ R^T

    cluster_rows: List[int] = []        # founding pair row per cluster
    cluster_A: List[np.ndarray] = []
    cluster_b: List[np.ndarray] = []
    weights: List[int] = []
    members: List[List[np.ndarray]] = []

    def member_row(i):
        return np.concatenate([table.hi_coord[i], table.lo_coord[i],
                               [hi_bins[i], lo_bins[i]]])

    for i in range(n):
        if not cluster_rows:
            new_cluster = True
        else:
            CA = np.asarray(cluster_A)
            Cb = np.asarray(cluster_b)
            D = CA - A[i]
            d = Cb - b[i]
            r2 = (np.einsum("cij,ik,ckj->c", D, M, D)
                  + 2.0 * np.einsum("j,cjk,ck->c", mu, D, d)
                  + np.einsum("ck,ck->c", d, d))
            j = int(np.argmin(r2))
            new_cluster = np.sqrt(max(r2[j], 0.0)) > cfg.rmsd_cloud
        if new_cluster:
            cluster_rows.append(i)
            cluster_A.append(A[i])
            cluster_b.append(b[i])
            weights.append(1)
            members.append([member_row(i)])
        else:
            weights[j] += 1
            members[j].append(member_row(i))

    if best_repeat is None:
        best_repeat = table.repeat[0]
    rep_thresh = max(cfg.min_repeat, best_repeat * cfg.repeat_frac)

    out = []
    for c, row in enumerate(cluster_rows):
        w = weights[c]
        rep = table.repeat[row]
        if w < cfg.weight_threshold or rep < rep_thresh:
            continue
        out.append(Candidate(
            hi_coord=table.hi_coord[row], lo_coord=table.lo_coord[row],
            rot=table.rot[row], cc=float(table.cc[row]), weight=int(w),
            repeat=float(rep), score=float(rep * w), members=members[c]))
    out.sort(key=lambda c: c.score, reverse=True)
    return out
