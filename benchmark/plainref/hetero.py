"""Plain assembly of a heteromer from its kinds' solutions.

The method of the reference (mad/MaD.py:697-711, 748-843) for kinds of
one copy each, whose subcomplexes are their solutions, as plain numpy and
PyTorch; nothing here imports the program:

1. overlap (:func:`overlap32`): each solution's occupancy (its atoms
   simulated at the assembly's 5 A on 2 A voxels, density above the 0.2
   isovalue), the voxels of each pair in common over the row's own, as
   float32 fractions, upper triangular;
2. ranking (:func:`rank`): the full cartesian product of the kinds'
   lists of global indices (the kinds in order, each kind's solutions in
   order), in ``itertools.product`` order; each tuple's sum, std and max
   over the symmetric overlap halved, over every ordered pair of its
   members, the diagonal included (MaD's meshgrid); a stable sort by the
   sum; models taken in that order up to ``max_models``, stopping at the
   first past ``max_overlap`` after the first;
3. scoring (:func:`model_cccs`): each model's atoms simulated together at
   the assembly's ``cc_resolution`` on the map's grid and correlated with
   the map.

``dtype``: the type the volumes are computed in, float32, or bfloat16 for
the control.
"""

from __future__ import annotations

from itertools import product
from typing import List, Sequence

import numpy as np
import torch

from . import sim

# the product's size above which the largest lists are cut to their first
# entries, one at a time (the program's announced restriction)
MAX_COMBINATIONS = 50_000_000
CHUNK = 1 << 16


def padded(coords: Sequence[np.ndarray], masses: Sequence[np.ndarray]):
    """Structures of several atom counts as one batch: (M, N, 3) and
    (M, N), the short ones padded with zero-mass copies of their first
    atom (they add no density and widen no box)."""
    n = max(len(c) for c in coords)
    xyz = np.zeros((len(coords), n, 3))
    mass = np.zeros((len(coords), n), np.float32)
    for i, (c, m) in enumerate(zip(coords, masses)):
        xyz[i, :len(c)] = c
        xyz[i, len(c):] = c[0]
        mass[i, :len(c)] = m
    return xyz, mass


def overlap32(coords, masses, asm: dict, device,
              dtype=torch.float32) -> np.ndarray:
    """(n, n) float32 upper-triangular overlap fractions of n structures
    (``coords`` and ``masses`` lists, one entry a structure)."""
    n = len(coords)
    if n < 2:
        return np.zeros((n, n), np.float32)
    xyz, mass = padded(coords, masses)
    counts = sim.occupancy_counts(xyz, mass, device, asm["sim_resolution"],
                                  asm["sim_voxsp"], asm["sim_isovalue"],
                                  dtype)
    diag = np.diag(counts).astype(np.float32)
    ov = counts.astype(np.float32) / np.maximum(diag, 1)[:, None]
    ov = np.where(diag[:, None] == 0, np.float32(0), ov).astype(np.float32)
    return np.triu(ov, k=1)


def cut(sizes: List[int]) -> List[int]:
    """The lists' lengths once the product is at most MAX_COMBINATIONS:
    the first of the longest lists shortened by one at a time."""
    sizes = list(sizes)
    while int(np.prod(sizes)) > MAX_COMBINATIONS and max(sizes) > 1:
        sizes[int(np.argmax(sizes))] -= 1
    return sizes


def scores(tuples: np.ndarray, ov32: np.ndarray):
    """(sum, std, max) of each tuple over the symmetric overlap halved,
    every ordered pair of members with the diagonal."""
    sym = ov32.astype(np.float64) + ov32.astype(np.float64).T
    k = tuples.shape[1]
    a = tuples[:, np.repeat(np.arange(k), k)]
    b = tuples[:, np.tile(np.arange(k), k)]
    vals = sym[a, b] * 0.5
    return vals.sum(axis=1), vals.std(axis=1), vals.max(axis=1)


def rank(ov32: np.ndarray, sizes: List[int], max_models: int,
         max_overlap: float) -> List[tuple]:
    """The models' tuples of global indices, in rank order."""
    starts = np.cumsum([0] + list(sizes))[:-1]
    lists = [np.arange(s, s + n) for s, n in zip(starts, cut(sizes))]
    tuples = np.array(list(product(*lists)), dtype=np.int64).reshape(
        -1, len(lists))
    sums = np.empty(len(tuples))
    maxs = np.empty(len(tuples))
    for c0 in range(0, len(tuples), CHUNK):
        s, _sd, mx = scores(tuples[c0:c0 + CHUNK], ov32)
        sums[c0:c0 + CHUNK] = s
        maxs[c0:c0 + CHUNK] = mx
    out = []
    for cnt, o in enumerate(np.argsort(sums, kind="stable")[:max_models]):
        if maxs[o] > max_overlap and cnt:
            break
        out.append(tuple(int(i) for i in tuples[o]))
    return out


def model_cccs(vol, origin, voxsp: float, coords, masses, tuples,
               resolution: float, dtype=torch.float32) -> np.ndarray:
    """The CC of each model (a tuple of global indices into ``coords`` and
    ``masses``, its members' atoms together in order) against the map."""
    if not len(tuples):
        return np.zeros(0)
    xyz, mass = padded([np.concatenate([coords[i] for i in t])
                        for t in tuples],
                       [np.concatenate([masses[i] for i in t])
                        for t in tuples])
    vols, origins = sim.simulate(xyz, mass, resolution, voxsp, vol.device,
                                 dtype=dtype)
    return sim.ccc(vol.to(dtype), origin, voxsp, vols, origins)
