"""A plain heteromer assembly for the port's CPU tests, importing neither
mad_tpu nor mad_tpu_torch: a copy of the benchmark's
``plainref/hetero.py`` ranking (mad/MaD.py:697-711, 748-843) with the
plain simulation it needs (``plainref/sim.py``), and the subcomplexes of
a kind of several copies.

- :func:`overlap32`: each structure's occupancy (5 A, 2 A voxels, density
  above the 0.2 isovalue), the voxels of each pair in common over the
  row's own, float32 fractions, upper triangular;
- :func:`subcomplexes`: one kind's ``n_copies``-tuples of its solutions
  in lexicographic order, stably sorted by their largest pair overlap,
  those above ``max_overlap`` left out; one copy: each solution alone;
- :func:`rank`: the full cartesian product of the kinds' lists of global
  indices in ``itertools.product`` order, each tuple's sum, std and max
  over the symmetric overlap halved (every ordered pair, the diagonal
  included), stably sorted by the sum; models taken in that order up to
  ``max_models``, stopping at the first past ``max_overlap`` after the
  first;
- :func:`model_cccs`: each model's atoms simulated together at
  ``resolution`` on the map's grid and correlated with the map.
"""

from __future__ import annotations

import math
from itertools import combinations, product

import numpy as np
import torch


def _bucket(n: int, b: int) -> int:
    return ((int(n) + b - 1) // b) * b


def _conv_full(vol: torch.Tensor, taps: np.ndarray, axis: int):
    k, dim = len(taps), axis + 1
    n = vol.shape[dim]
    shape = list(vol.shape)
    shape[dim] = n + 2 * (k - 1)
    padded = vol.new_zeros(shape)
    padded.narrow(dim, k - 1, n).copy_(vol)
    out = None
    for m in range(k):
        term = padded.narrow(dim, m, n + k - 1) * float(taps[k - 1 - m])
        out = term if out is None else out + term
    return out


def simulate(coords, masses, resolution: float, voxsp: float,
             isovalue: float = 0.0, shape_bucket: int = 16):
    """(M, N, 3) coords and (M, N) masses -> (M, X, Y, Z) float32 volumes
    on one box (trilinear mass scatter, max 1, a full Gaussian blur of
    sigma = resolution / (pi sqrt 2) / voxsp to ceil(3 sigma), max 1,
    zero below ``isovalue``) and each origin (M, 3)."""
    coords = np.asarray(coords, dtype=np.float64)
    M, N = coords.shape[:2]
    mins = voxsp * np.floor(coords.min(axis=1) / voxsp)
    maxs = voxsp * np.ceil(coords.max(axis=1) / voxsp)
    margin = 2
    dims = np.ceil((maxs - mins) / voxsp).astype(int) + 2 * margin + 1
    box = tuple(_bucket(int(d), shape_bucket) for d in dims.max(axis=0))
    f32 = dict(dtype=torch.float32)
    c = torch.as_tensor(coords, **f32)
    w_m = torch.as_tensor(np.asarray(masses, np.float32))
    g = margin + (c - torch.as_tensor(mins, **f32)[:, None, :]) / \
        torch.tensor(voxsp, **f32)
    g0 = torch.floor(g)
    w1 = g - g0
    w0 = 1.0 - w1
    i0 = g0.to(torch.int64)
    sid = torch.arange(M)[:, None].expand(M, N)
    grids = torch.zeros(M * box[0] * box[1] * box[2], **f32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (w_m * (w1[..., 0] if dx else w0[..., 0])
                     * (w1[..., 1] if dy else w0[..., 1])
                     * (w1[..., 2] if dz else w0[..., 2]))
                idx = i0 + torch.as_tensor([dx, dy, dz])
                keep = ((idx >= 0) & (idx < torch.as_tensor(box))).all(-1)
                flat = ((sid * box[0] + idx[..., 0]) * box[1]
                        + idx[..., 1]) * box[2] + idx[..., 2]
                grids.index_add_(0, flat[keep], w[keep])
    grids = grids.reshape((M,) + box)
    sigma = resolution / (math.pi * math.sqrt(2.0)) / voxsp
    radius = int(math.ceil(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-(x * x) / (2.0 * sigma ** 2))
    taps = (taps / taps.sum()).astype(np.float32)
    grids = grids / torch.clamp(grids.amax(dim=(1, 2, 3), keepdim=True),
                                min=1e-30)
    for axis in range(3):
        grids = _conv_full(grids, taps, axis)
    dens = grids / torch.clamp(grids.amax(dim=(1, 2, 3), keepdim=True),
                               min=1e-30)
    if isovalue:
        dens = torch.where(dens < isovalue, torch.zeros_like(dens), dens)
    return dens, mins - (radius + margin) * voxsp


def padded(coords, masses):
    """Structures of several atom counts as one (M, N) batch, the short
    ones padded with zero-mass copies of their first atom."""
    n = max(len(c) for c in coords)
    xyz = np.zeros((len(coords), n, 3))
    mass = np.zeros((len(coords), n), np.float32)
    for i, (c, m) in enumerate(zip(coords, masses)):
        xyz[i, :len(c)] = c
        xyz[i, len(c):] = c[0]
        mass[i, :len(c)] = m
    return xyz, mass


def overlap32(coords, masses, resolution=5.0, voxsp=2.0, isovalue=0.2):
    """(n, n) float32 upper-triangular overlap fractions of n structures."""
    n = len(coords)
    if n < 2:
        return np.zeros((n, n), np.float32)
    dens, origins = simulate(*padded(coords, masses), resolution, voxsp,
                             isovalue=isovalue)
    off = np.rint((origins - origins.min(axis=0)) / voxsp).astype(np.int64)
    box = np.asarray(dens.shape[1:])
    frame = tuple(int(v) for v in (off.max(axis=0) + box))
    occ = torch.zeros((n,) + frame)
    for i, (ox, oy, oz) in enumerate(off.tolist()):
        occ[i, ox:ox + box[0], oy:oy + box[1], oz:oz + box[2]] = (
            dens[i] > 0).float()
    flat = occ.reshape(n, -1).double()
    counts = (flat @ flat.T).numpy()
    diag = np.diag(counts).astype(np.float32)
    ov = counts.astype(np.float32) / np.maximum(diag, 1)[:, None]
    return np.triu(np.where(diag[:, None] == 0, np.float32(0), ov), k=1)


def subcomplexes(coords, masses, n_copies: int, max_overlap: float):
    """(kept tuples, their coords, their masses) of one kind."""
    n = len(coords)
    k = min(n_copies, n)
    if k <= 1:
        tuples = [(i,) for i in range(n)]
    else:
        ov = overlap32(coords, masses)
        every = list(combinations(range(n), k))
        mx = np.array([max(ov[a, b] for a, b in combinations(t, 2))
                       for t in every])
        tuples = [every[o] for o in np.argsort(mx, kind="stable")
                  if not mx[o] > max_overlap]
    return (tuples, [np.concatenate([coords[i] for i in t]) for t in tuples],
            [np.concatenate([masses[i] for i in t]) for t in tuples])


def rank(ov32, sizes, max_models: int, max_overlap: float):
    """The models' tuples of global indices in rank order, and each
    one's (sum, std, max)."""
    sym = ov32.astype(np.float64) + ov32.astype(np.float64).T
    starts = np.cumsum([0] + list(sizes))[:-1]
    tuples = np.array(list(product(*[range(s, s + n) for s, n in
                                     zip(starts, sizes)])), dtype=np.int64)
    k = tuples.shape[1]
    vals = sym[tuples[:, np.repeat(np.arange(k), k)],
               tuples[:, np.tile(np.arange(k), k)]] * 0.5
    sums, stds, maxs = vals.sum(axis=1), vals.std(axis=1), vals.max(axis=1)
    out = []
    for cnt, o in enumerate(np.argsort(sums, kind="stable")[:max_models]):
        if maxs[o] > max_overlap and cnt:
            break
        out.append((tuple(int(i) for i in tuples[o]),
                    (sums[o], stds[o], maxs[o])))
    return out


def model_cccs(vol, origin, voxsp: float, coords, masses, tuples,
               resolution: float = 4.0):
    """The CC of each model against the map ``vol`` (X, Y, Z)."""
    xyz, mass = padded([np.concatenate([coords[i] for i in t])
                        for t in tuples],
                       [np.concatenate([masses[i] for i in t])
                        for t in tuples])
    vols, origins = simulate(xyz, mass, resolution, voxsp)
    vol = torch.as_tensor(np.asarray(vol, np.float32))
    starts = np.rint((origins - np.asarray(origin)) / voxsp).astype(np.int64)
    shape, box = np.asarray(vol.shape), np.asarray(vols.shape[1:])
    out = np.zeros(len(tuples))
    for m, s in enumerate(starts):
        lo, hi = np.maximum(s, 0), np.minimum(s + box, shape)
        if np.any(hi <= lo):
            continue
        a = vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].double()
        b = vols[m, lo[0] - s[0]:hi[0] - s[0], lo[1] - s[1]:hi[1] - s[1],
                 lo[2] - s[2]:hi[2] - s[2]].double()
        out[m] = float((a * b).sum()) / max(
            math.sqrt(float((a * a).sum()) * float((b * b).sum())), 1e-30)
    return out
