"""Combinatorial assembly building from docking solutions (port of
mad_tpu/engine/assemble.py).

Replaces MaD.build_assembly / _build_from_single / _build_models
(mad/MaD.py:192-223, 632-843):
  * per solution, a low-resolution occupancy grid (5 A / 2 A voxels /
    isovalue 0.2), all solutions in one batched simulation (K9 scatter);
  * pairwise overlap fractions in a common lattice frame (K18), kept on
    the device and symmetrized by the heads as they stage it;
  * homomultimers: the C(n_solutions, n_copies) tuples ranked by max pair
    overlap, the head on the device (K19) when the count is large;
  * heteromers: each kind's subcomplexes (its copies' tuples under the
    overlap threshold, ``subcomplexes``), then the cartesian product of the
    kinds' lists ranked by summed overlap, the head on the device (K20)
    when the product is large (``build_heteromer``);
  * models kept while max overlap <= threshold, CC-scored against the map at
    4 A in one batched simulation.

The host parts (tuple statistics, unranking, the host enumeration paths and
the trims, with their MaD> notes) are copied from the original. Left
behind: ``DeferredOverlap`` and ``defer=True`` (a relay sync the TPU
saves), the (8-bucketed) row padding and the 32-bucketed x/y frame of the
overlap program.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from itertools import combinations, product
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.config import AssemblyConfig, bucket
from ..core.grid import DensityGrid
from ..core.structure import Structure
from ..device import resolve
from ..kernels import enumerate as k_enum
from ..kernels import hetero as k_hetero
from ..kernels import overlap as k_overlap
from ..ops.simulate import batched_simulate
from ..utils import profiling
from .score import ccc_structures


@dataclass
class AssemblyModel:
    components: List[int]          # global solution indices
    ccc: float
    sum_overlap: float
    std_overlap: float
    max_overlap: float


# Every enumeration restriction is announced (no silent coverage caps): the
# notes print as MaD> lines and accumulate here so the orchestrator can
# surface them in complex_ranking.csv metadata.
_enum_notes: List[str] = []


def _note(msg: str) -> None:
    print(msg)
    _enum_notes.append(msg)


def pop_enum_notes() -> List[str]:
    """Drain the enumeration-restriction notes recorded since the last call."""
    out = list(_enum_notes)
    _enum_notes.clear()
    return out


def atom_batch(groups: Sequence[Sequence[Structure]]):
    """One row per group of structures, their atoms concatenated:
    (rows, n_max, 3) float64 coords and (rows, n_max) float32 masses,
    short rows padded with zero-mass copies of their first atom."""
    packs = [(np.concatenate([s.coords for s in g]),
              np.concatenate([s.masses for s in g])) for g in groups]
    n_max = max(c.shape[0] for c, _ in packs)
    coords = np.zeros((len(packs), n_max, 3))
    masses = np.zeros((len(packs), n_max), dtype=np.float32)
    for i, (c, w) in enumerate(packs):
        coords[i, : len(c)] = c
        coords[i, len(c):] = c[0]      # zero-mass padding
        masses[i, : len(c)] = w
    return coords, masses


def _solution_densities(structures: Sequence[Structure],
                        cfg: AssemblyConfig, device, isovalue: float):
    """The solutions' low-res densities, (n, X, Y, Z) on ``device``, and
    their lattice-registered origins (n, 3): one batched simulation."""
    coords, masses = atom_batch([[s] for s in structures])
    return batched_simulate(coords, masses, cfg.sim_resolution, cfg.sim_voxsp,
                            device, isovalue=isovalue)


def overlap_inputs(structures: Sequence[Structure], cfg: AssemblyConfig,
                   device):
    """K18's arguments for a solution set: the occupancy densities
    (n, X, Y, Z), their integer lattice offsets (n, 3) in a common frame
    and the frame's extent (z a multiple of 32). ``batched_simulate``
    registers every origin on the voxel lattice, so the offsets reproduce
    the per-pair origin arithmetic of the reference exactly. The boxes are
    checked to fit the frame here, on the host offsets (K18 does not read
    them back from the card)."""
    dens, origins = _solution_densities(structures, cfg, device,
                                        cfg.sim_isovalue)
    off = np.rint((origins - origins.min(axis=0)) / cfg.sim_voxsp).astype(
        np.int32)
    off = np.clip(off, 0, None)
    box = dens.shape[1:]
    frame = (int(box[0] + off[:, 0].max()), int(box[1] + off[:, 1].max()),
             bucket(int(box[2] + off[:, 2].max()), 32))
    k_overlap.check_frame(off, box, frame)
    return dens, torch.as_tensor(off, device=device), frame


@profiling.spanned("assembly.overlap")
def device_overlap(structures: Sequence[Structure], cfg: AssemblyConfig,
                   device) -> torch.Tensor:
    """K18's float32 upper-triangular (n, n) overlap matrix of a solution
    set, left on ``device`` (the heads' input): one batched simulation
    (K9), then K18 on the boxes placed in a common frame."""
    n = len(structures)
    if n < 2:
        return torch.zeros((n, n), dtype=torch.float32, device=device)
    profiling.tag(solutions=n)
    return k_overlap.pack_overlap(*overlap_inputs(structures, cfg, device))


@profiling.spanned("assembly.host_overlap")
def host_overlap(ov: torch.Tensor) -> np.ndarray:
    """The float64 host copy of a device overlap (one pull)."""
    return profiling.pull(ov).numpy().astype(np.float64)


def solution_overlap(structures: Sequence[Structure], cfg: AssemblyConfig,
                     device) -> np.ndarray:
    """Pairwise overlap-fraction matrix of a solution set (parity
    mad/MaD.py:659-668), upper triangular float64 (n, n)."""
    return host_overlap(device_overlap(structures, cfg, device))


def _score_tuples(tuples: np.ndarray, overlap: np.ndarray,
                  chunk: int = 1 << 18):
    """[sum/n, std, max] of pairwise overlaps per tuple.

    Single-pass f32 statistics computed in row chunks — at C(23,10) scale
    the naive fancy-indexed f64 temporaries cost ~10 s on one host core.
    """
    m, n_copies = tuples.shape
    if n_copies == 1:
        z = np.zeros(m)
        return z, z, z
    pair_idx = list(combinations(range(n_copies), 2))
    i0 = np.asarray([p[0] for p in pair_idx])
    i1 = np.asarray([p[1] for p in pair_idx])
    npair = len(pair_idx)
    ov = np.ascontiguousarray(overlap, dtype=np.float32)
    # flat lookup: pair (a, b) -> overlap[a, b]
    nsol = ov.shape[0]
    flat = ov.reshape(-1)
    sums = np.empty(m, np.float64)
    stds = np.empty(m, np.float64)
    maxs = np.empty(m, np.float64)
    for c0 in range(0, m, chunk):
        t = tuples[c0:c0 + chunk]
        idx = t[:, i0].astype(np.int64) * nsol + t[:, i1]
        v = flat[idx]
        s = v.sum(axis=1, dtype=np.float64)
        ss = np.einsum("ij,ij->i", v, v, dtype=np.float64)
        sums[c0:c0 + chunk] = s
        var = np.maximum(ss / npair - (s / npair) ** 2, 0.0)
        stds[c0:c0 + chunk] = np.sqrt(var)
        maxs[c0:c0 + chunk] = v.max(axis=1)
    return sums / n_copies, stds, maxs


@functools.lru_cache(maxsize=512)
def _all_combinations(n: int, k: int) -> np.ndarray:
    """All C(n, k) index tuples as an (M, k) int array in lexicographic
    order, built by the memoized Pascal recurrence in vectorized numpy
    (itertools would materialize millions of Python tuples at this size)."""
    if k == 0:
        return np.zeros((1, 0), dtype=np.int32)
    if k == n:
        return np.arange(n, dtype=np.int32)[None, :]
    # combos(n, k) = [0 + (combos of {1..n-1} choose k-1)] U [combos w/o 0]
    sub = _all_combinations(n - 1, k - 1)
    with_first = np.concatenate(
        [np.zeros((len(sub), 1), np.int32), sub + 1], axis=1)
    without = _all_combinations(n - 1, k) + 1
    out = np.concatenate([with_first, without], axis=0)
    out.setflags(write=False)
    return out


def _unrank_combination(r: int, n: int, k: int) -> list:
    """r-th (0-based) k-combination of {0..n-1} in lexicographic order."""
    out = []
    x = 0
    for i in range(k):
        while math.comb(n - 1 - x, k - 1 - i) <= r:
            r -= math.comb(n - 1 - x, k - 1 - i)
            x += 1
        out.append(x)
        x += 1
    return out


_ENUM_NMAX = 64     # solution frame of the device unranking (uint64 masks)


def _device_overlap(overlap: np.ndarray, overlap_dev, device):
    """The float32 overlap on ``device`` for the heads, which symmetrize
    it as they stage it: the device overlap when the caller kept it
    there."""
    if overlap_dev is None:
        overlap_dev = torch.as_tensor(np.asarray(overlap, dtype=np.float32),
                                      device=device)
    return overlap_dev


@profiling.spanned("assembly.enumerate")
def enumerate_homomultimer(n_solutions: int, n_copies: int,
                           overlap: np.ndarray,
                           max_combinations: int = 5_000_000,
                           head: int = 256, device="cuda",
                           overlap_dev: Optional[torch.Tensor] = None):
    """Head of the candidate-tuple ranking for a homomultimer
    (mad/MaD.py:686-694: all C(n, k) tuples sorted by max pairwise overlap).

    Model building only consumes the head of that ranking (it stops at
    ``max_models`` or at the first clash, mad/MaD.py:730), so beyond
    4 * ``head`` tuples only the ``head`` best are materialized: K19 ranks
    every tuple on ``device``. When C(n_solutions, n_copies) exceeds
    ``max_combinations`` the enumeration restricts to the best-ranked
    solutions (they arrive sorted by RWmCC) and says so (every restriction
    prints + records a note, pop_enum_notes). ``overlap_dev``: the same
    overlap still on ``device`` (``device_overlap``), so that K19 reads it
    without a host round trip.
    """
    device = resolve(device)
    n_orig = n_solutions
    n_copies = min(n_copies, n_solutions)
    while (n_solutions > n_copies
           and math.comb(n_solutions, n_copies) > max_combinations):
        n_solutions -= 1
    if n_solutions < n_orig:
        _note(f"MaD> enumeration restricted to the top {n_solutions} of "
              f"{n_orig} solutions (keeps C(n,{n_copies}) <= "
              f"{max_combinations:,} combinations)")
    if n_copies == 1:
        tuples = np.arange(n_solutions)[:, None]
        z = np.zeros(len(tuples))
        return tuples, z, z, z
    # Host path enumerates ALL C(n, k) tuples; solution counts above the
    # device unranking frame (_ENUM_NMAX) always take it, so no tuple is
    # ever dropped by the frame cap (at n > 64 the max_combinations trim
    # bounds k <= 4, cheap on host).
    if (math.comb(n_solutions, n_copies) <= 4 * head
            or n_solutions > _ENUM_NMAX):
        tuples = _all_combinations(n_solutions, n_copies)
        s, sd, mx = _score_tuples(tuples, overlap)
        order = np.argsort(mx, kind="stable")
        return tuples[order], s[order], sd[order], mx[order]

    _note(f"MaD> enumeration ranking computed on device; materializing the "
          f"best {head} of {math.comb(n_solutions, n_copies):,} tuples "
          "(model building consumes the ranking head only)")
    tab = torch.as_tensor(k_enum.comb_table(n_solutions, n_copies),
                          device=device)
    keys = k_enum.enumerate_head(
        _device_overlap(overlap, overlap_dev, device), tab, head)
    keep, _mx = k_enum.split_keys(keys)
    top = np.asarray([_unrank_combination(int(r), n_solutions, n_copies)
                      for r in keep], dtype=np.int32)
    s, sd, mx2 = _score_tuples(top, overlap)
    order = np.argsort(mx2, kind="stable")
    return top[order], s[order], sd[order], mx2[order]


def _hetero_scores(gather: np.ndarray, overlap: np.ndarray):
    """[sum, std, max] per tuple of global indices; the reference computes
    them over the full meshgrid including the zero diagonal
    (mad/MaD.py:800-805)."""
    sym = overlap + overlap.T
    n = gather.shape[1]
    pair_idx = [(i, j) for i in range(n) for j in range(n)]
    a = gather[:, [p[0] for p in pair_idx]]
    b = gather[:, [p[1] for p in pair_idx]]
    vals = sym[a, b] * 0.5
    return vals.sum(axis=1), vals.std(axis=1), vals.max(axis=1)


@profiling.spanned("assembly.enumerate_hetero")
def enumerate_heteromer(groups: Dict[str, List[int]], overlap: np.ndarray,
                        max_combinations: int = 50_000_000, head: int = 256,
                        device="cuda",
                        overlap_dev: Optional[torch.Tensor] = None):
    """Cartesian product of per-subunit candidate lists (mad/MaD.py:799-805).

    groups maps subunit key -> list of global solution indices (or of
    subcomplex indices). Tuples rank by summed pairwise overlap ascending
    (reference: sorted(key=itemgetter(1)), mad/MaD.py:809); model building
    only consumes the head of that ranking (mad/MaD.py:826-830), so beyond
    a small product size only the ``head`` best tuples are materialized:
    K20 decodes and scores every tuple on ``device``, the full cartesian
    product never exists in host memory. When the product exceeds
    ``max_combinations`` the largest groups trim to their best-ranked
    entries (lists arrive ranking-sorted) and the trim is announced
    (printed + recorded, pop_enum_notes). ``overlap_dev`` as for
    ``enumerate_homomultimer``. Traced, the span tags the tuples ranked
    and whether K20 ranked them; the counters ``hetero_tuples`` and
    ``hetero_device_ranks`` add them up."""
    device = resolve(device)
    lists = [np.asarray(v) for v in groups.values()]
    sizes = [len(v) for v in lists]
    sizes0 = list(sizes)
    while int(np.prod(sizes)) > max_combinations and max(sizes) > 1:
        g = int(np.argmax(sizes))
        sizes[g] -= 1
    if sizes != sizes0:
        trimmed = ", ".join(
            f"{k}: {a}->{b}" for k, a, b in zip(groups, sizes0, sizes)
            if a != b)
        _note(f"MaD> enumeration restricted to the best-ranked entries per "
              f"component ({trimmed}; keeps the cartesian product <= "
              f"{max_combinations:,} combinations)")
    lists = [lv[:s] for lv, s in zip(lists, sizes)]
    m = int(np.prod(sizes))
    on_device = m > 4 * head
    profiling.tag(tuples=m, on_device=int(on_device))
    profiling.count("hetero_tuples", m)
    profiling.count("hetero_device_ranks", int(on_device))

    if not on_device:
        tuples = np.array(list(product(*[range(s) for s in sizes])),
                          dtype=np.int64).reshape(m, len(sizes))
        gather = np.stack([lists[k][tuples[:, k]]
                           for k in range(len(lists))], axis=1)
        s, sd, mx = _hetero_scores(gather, overlap)
        order = np.argsort(s, kind="stable")
        return gather[order], s[order], sd[order], mx[order]

    _note(f"MaD> enumeration ranking computed on device; materializing the "
          f"best {head} of {m:,} tuples (model building consumes the "
          "ranking head only)")
    lists_p = np.zeros((len(sizes), max(sizes)), dtype=np.int32)
    for g, lv in enumerate(lists):
        lists_p[g, : len(lv)] = lv
    keys = k_hetero.hetero_head(
        _device_overlap(overlap, overlap_dev, device),
        torch.as_tensor(lists_p, device=device), sizes, head)
    ridx, _sums = k_enum.split_keys(keys)
    # decode head tuples on host (mixed radix), re-score for [sum, std, max]
    decoded = np.empty((len(ridx), len(sizes)), dtype=np.int64)
    rem = ridx.copy()
    for g in range(len(sizes) - 1, -1, -1):
        decoded[:, g] = rem % sizes[g]
        rem //= sizes[g]
    gather = np.stack([lists[k][decoded[:, k]]
                       for k in range(len(lists))], axis=1)
    s, sd, mx = _hetero_scores(gather, overlap)
    # stable (sum, cartesian-rank) order matches the reference's stable sort
    order = np.lexsort((ridx, s))
    return gather[order], s[order], sd[order], mx[order]


def rank_copies(structures: Sequence[Structure], n_copies: int,
                cfg: AssemblyConfig, device="cuda",
                on_overlap: Optional[Callable[[np.ndarray], None]] = None):
    """The ranked tuples of ``n_copies`` of one kind's solutions and their
    [sum, std, max] overlap (mad/MaD.py:686-694): each solution alone for
    one copy; otherwise K18's overlap of the solutions, handed to
    ``on_overlap`` on the host, then ``enumerate_homomultimer``."""
    n = len(structures)
    if min(n_copies, n) <= 1:
        z = np.zeros(n)
        return np.arange(n)[:, None], z, z, z
    ov_dev = device_overlap(structures, cfg, device)
    overlap = host_overlap(ov_dev)
    if on_overlap is not None:
        on_overlap(overlap)
    return enumerate_homomultimer(n, n_copies, overlap, device=device,
                                  overlap_dev=ov_dev)


def merge_structures(parts: Sequence[Structure]) -> Structure:
    """One structure of ``parts``' atoms in order: the atoms that
    ``write_complex`` writes of them."""
    starts = np.cumsum([0] + [p.n_atoms for p in parts[:-1]])
    return Structure(
        coords=np.concatenate([p.coords for p in parts]),
        masses=np.concatenate([p.masses for p in parts]),
        ca_idx=np.concatenate([p.ca_idx + s for p, s in zip(parts, starts)]),
        bb_idx=np.concatenate([p.bb_idx + s for p, s in zip(parts, starts)]),
        info=[row for p in parts for row in p.info],
        source="+".join(p.source for p in parts))


class Subcomplexes(NamedTuple):
    """One kind's subcomplexes: each kept tuple's place in the kind's
    ranking, the tuples (indices of the kind's solutions) and each
    subcomplex as one structure."""

    ranks: np.ndarray
    tuples: np.ndarray
    structures: List[Structure]


@profiling.spanned("assembly.subcomplexes")
def subcomplexes(structures: Sequence[Structure], n_copies: int,
                 cfg: AssemblyConfig, max_overlap: float, device="cuda",
                 on_overlap: Optional[Callable[[np.ndarray], None]] = None
                 ) -> Subcomplexes:
    """One kind's subcomplexes (mad/MaD.py:697-711): its solutions'
    ``n_copies``-tuples in rank order (``rank_copies``), those whose max
    overlap is above ``max_overlap`` left out; with one copy each solution
    is its own subcomplex."""
    tuples, _s, _sd, maxs = rank_copies(structures, n_copies, cfg, device,
                                        on_overlap)
    ranks = np.flatnonzero(~(maxs > max_overlap))
    tuples = tuples[ranks]
    profiling.tag(solutions=len(structures), copies=tuples.shape[1],
                  subcomplexes=len(tuples))
    return Subcomplexes(ranks, tuples, [
        merge_structures([structures[i] for i in t]) for t in tuples])


def build_heteromer(groups: Dict[str, Sequence[Structure]],
                    dmap: DensityGrid, cfg: AssemblyConfig, max_models: int,
                    max_overlap: float, device="cuda",
                    on_overlap: Optional[Callable[[np.ndarray], None]] = None):
    """A heteromer's models from each kind's subcomplexes
    (mad/MaD.py:748-843): K18's overlap of all of them (handed to
    ``on_overlap`` on the host), ``enumerate_heteromer`` over their global
    indices (the kinds in order), then ``score_models``. Returns the
    models and the flat list of structures their ``components`` index."""
    structures: List[Structure] = []
    index: Dict[str, List[int]] = {}
    for key, subs in groups.items():
        index[key] = list(range(len(structures), len(structures) + len(subs)))
        structures.extend(subs)
    ov_dev = device_overlap(structures, cfg, device)
    overlap = host_overlap(ov_dev)
    if on_overlap is not None:
        on_overlap(overlap)
    tuples, sums, stds, maxs = enumerate_heteromer(
        index, overlap, device=device, overlap_dev=ov_dev)
    return score_models(tuples, sums, stds, maxs, structures, dmap, cfg,
                        max_models, max_overlap), structures


@profiling.spanned("assembly.score_models")
def score_models(tuples: np.ndarray, sums, stds, maxs,
                 structures: Sequence[Structure], dmap: DensityGrid,
                 cfg: AssemblyConfig, max_models: int, max_overlap: float
                 ) -> List[AssemblyModel]:
    """CC-score the accepted models (mad/MaD.py:726-745) on the map's
    device: all accepted model grids simulate in one batch (hetero models
    padded to the largest atom count with zero-mass atoms) and score in one
    call."""
    accepted = []
    for cnt, tup in enumerate(tuples):
        if cnt >= max_models or (maxs[cnt] > max_overlap and cnt):
            break
        accepted.append(cnt)
    if not accepted:
        return []

    cb, mb = atom_batch([[structures[i] for i in tuples[cnt]]
                         for cnt in accepted])
    cccs = ccc_structures(dmap, cb, mb, cfg.cc_resolution)

    out: List[AssemblyModel] = []
    for k, cnt in enumerate(accepted):
        out.append(AssemblyModel(
            components=[int(i) for i in tuples[cnt]], ccc=float(cccs[k]),
            sum_overlap=float(sums[cnt]), std_overlap=float(stds[cnt]),
            max_overlap=float(maxs[cnt])))
    profiling.tag(models=len(out))
    return out
