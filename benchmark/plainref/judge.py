"""The comparison that decides ``correct``: a candidate's outputs (the
program's, or the control's) against the plain reference, which works
everything out again from the inputs.

Each function returns plain numbers; the configuration's ``limits`` hold
each of them (a number at or under its limit passes).

- ``rows_differ``: of the union of the candidate's and the reference's
  descriptor rows (keyed by octave, subvoxel anchor, main and secondary
  bin), the share present on one side only (an anchor or a frame that
  differs) or on both with counts that differ anywhere (a row that
  differs).
- ``candidates_differ``: of the union of the candidate's and the
  reference's first-round candidates of a dock (the clusters of matched
  pairs that the refinement starts from, keyed by their founding pair's
  anchors and their weight), the share on one side only.
- ``solutions_differ``: of the union of the candidate's and the
  reference's dock solutions, paired one to one by least CA-RMSD under
  ``PAIR_RMSD``, the share left unpaired, or paired farther than the
  configuration's ``pose_tol`` or with another weight (a solution
  missing, extra, misplaced, unrefined, or merged otherwise).
- ``ccc_gap``: the largest gap between a solution's CC as the candidate
  reports it and the CC of its pose simulated and correlated again.
- ``models_differ``: of the assembly's ranks, the share where the
  candidate's tuple of solutions differs from the reference's, which
  ranks the tuples of the candidate's own solutions from their overlap
  worked out again.
- ``model_ccc_gap``: the largest gap between a model's CC as the
  candidate reports it and the CC of its tuple simulated again.

The program's outputs reach these functions as numpy arrays and tensors
(:mod:`harness.cell` makes them); this module imports nothing of the
program.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from . import sim

# solutions closer than this pair up: the dock's dedup_rmsd, the CA-RMSD
# under which it merges two poses into one solution
PAIR_RMSD = 6.0


def row_keys(octave, subv, main, sec):
    """One hashable key a row; a repeated key gets its occurrence."""
    seen = Counter()
    keys = []
    sv = np.round(np.asarray(subv, dtype=np.float64), 4)
    for o, (x, y, z), m, s in zip(np.asarray(octave).tolist(), sv.tolist(),
                                  np.asarray(main).tolist(),
                                  np.asarray(sec).tolist()):
        k = (o, x, y, z, m, s)
        keys.append(k + (seen[k],))
        seen[k] += 1
    return keys


def compare_rows(cand: dict, ref) -> dict:
    """Counts of the rows of one described grid: union, matched, unequal.
    ``cand``: octave, subv, main, sec (numpy) and desc ((N, D) int16
    tensor); ``ref``: a :class:`describe.Described`."""
    pk = row_keys(cand["octave"], cand["subv"], cand["main"], cand["sec"])
    rk = row_keys(ref.octave, ref.subv, ref.main, ref.sec)
    rindex = {k: i for i, k in enumerate(rk)}
    pi, ri = [], []
    for i, k in enumerate(pk):
        j = rindex.get(k)
        if j is not None:
            pi.append(i)
            ri.append(j)
    matched = len(pi)
    unequal = 0
    if matched:
        a = cand["desc"][torch.as_tensor(pi, device=cand["desc"].device)]
        b = ref.desc.to(a.device)[torch.as_tensor(ri, device=a.device)]
        unequal = int((a != b).any(dim=1).sum())
    return dict(union=len(pk) + len(rk) - matched, matched=matched,
                unequal=unequal)


def share_differ(counts: list) -> float:
    """(unpaired + paired but unequal) over the union, summed over the
    parts."""
    union = sum(c["union"] for c in counts)
    matched = sum(c["matched"] for c in counts)
    unequal = sum(c["unequal"] for c in counts)
    return (union - matched + unequal) / max(union, 1)


def pair_solutions(coords: np.ndarray, ref_coords: np.ndarray,
                   ca_idx: np.ndarray) -> list:
    """[(i, j, CA-RMSD)] of one dock's solutions (S, N, 3) and the
    reference's (R, N, 3), paired one to one greedily by least CA-RMSD
    under PAIR_RMSD."""
    S, R = len(coords), len(ref_coords)
    if not (S and R):
        return []
    a = np.asarray(coords)[:, ca_idx]
    b = np.asarray(ref_coords)[:, ca_idx]
    d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1).mean(-1))
    used_i, used_j, out = set(), set(), []
    for flat in np.argsort(d, axis=None, kind="stable"):
        i, j = divmod(int(flat), R)
        if d[i, j] >= PAIR_RMSD:
            break
        if i not in used_i and j not in used_j:
            used_i.add(i)
            used_j.add(j)
            out.append((i, j, float(d[i, j])))
    return out


def compare_solutions(coords, weights, ref_coords, ref_weights, ca_idx,
                      pose_tol: float) -> dict:
    """Counts of one dock's solutions: union, matched (paired within
    ``pose_tol`` A with the same weight), unequal (paired, but farther
    or with another weight), and the pairs' CA-RMSDs."""
    pairs = pair_solutions(coords, ref_coords, ca_idx)
    far = [(i, j, d) for i, j, d in pairs
           if d > pose_tol or int(weights[i]) != int(ref_weights[j])]
    return dict(union=len(coords) + len(ref_coords) - len(pairs),
                matched=len(pairs), unequal=len(far),
                rmsd=sorted(round(d, 6) for _i, _j, d in pairs),
                weights_unequal=sum(int(weights[i]) != int(ref_weights[j])
                                    for i, j, _d in pairs))


def candidate_keys(cands) -> list:
    """One key a first-round candidate: its founding pair's subunit and
    map anchors and its weight."""
    return [tuple(np.round(np.concatenate([c["hi"], c["lo"]]), 4).tolist())
            + (int(c["weight"]),) for c in cands]


def compare_candidates(cands, ref_cands) -> dict:
    """Counts of the first round's candidates: union and matched (the
    same founding pair and weight); none unequal."""
    a, b = Counter(candidate_keys(cands)), Counter(candidate_keys(ref_cands))
    matched = sum((a & b).values())
    return dict(union=sum(a.values()) + sum(b.values()) - matched,
                matched=matched, unequal=0)


def model_cccs(vol, origin, voxsp: float, sol_coords: np.ndarray,
               masses: np.ndarray, tuples, resolution: float,
               dtype=torch.float32) -> np.ndarray:
    """The CC of each model (a tuple of solutions, their atoms together)
    against the map."""
    if not len(tuples):
        return np.zeros(0)
    groups = [np.concatenate([sol_coords[c] for c in t]) for t in tuples]
    n_max = max(len(g) for g in groups)
    coords = np.zeros((len(groups), n_max, 3))
    mass = np.zeros((len(groups), n_max), dtype=np.float32)
    for i, (g, t) in enumerate(zip(groups, tuples)):
        coords[i, :len(g)] = g
        coords[i, len(g):] = g[0]
        mass[i, :len(g)] = np.tile(masses, len(t))
    vols, origins = sim.simulate(coords, mass, resolution, voxsp,
                                 vol.device, dtype=dtype)
    return sim.ccc(vol.to(dtype), origin, voxsp, vols, origins)


def ranks_differ(tuples, ref_tuples) -> float:
    """The share of ranks whose tuple differs (a rank on one side only
    differs)."""
    n = max(len(tuples), len(ref_tuples))
    if n == 0:
        return 0.0
    same = sum(tuple(a) == tuple(b) for a, b in zip(tuples, ref_tuples))
    return (n - same) / n


def gap(a, b) -> float:
    """The largest |a - b| (0 for none; inf where the counts differ)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0
