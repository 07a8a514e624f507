"""Functional API mirroring the reference's legacy ``mad_utils`` surface
(port of mad_tpu/functional.py; host code over the port's entry points).

The reference ships a functional pipeline API (mad/mad_utils.py:28-318)
that is dead code -- its imports reference nonexistent subpackages
(mad/mad_utils.py:17-24). This module provides the same entry points
*working*, including the extras the class API dropped: reference-PDB RMSD
benchmarking (mad/mad_utils.py:474-508) and anchor-repeatability
diagnostics (mad/mad_utils.py:1227-1255). Each entry point that touches
the device takes a keyword-only ``device``, the card unless named.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.spatial import cKDTree

from .core.config import MadConfig
from .core.grid import DensityGrid, read_map
from .core.structure import Structure, parse_pdb
from .engine.pipeline import DescriptorSet, describe_grid, describe_structure
from .engine.docking import dock_structure, Solution


def setup(map_path: str, resolution: float, isovalue: float = 0.0,
          config: Optional[MadConfig] = None, *, device=None):
    """Load + preprocess a map for docking (parity mad/mad_utils.py:28)."""
    grid = read_map(map_path, isovalue=isovalue, device=device).reduce_void()
    return grid, config or MadConfig()


def get_descriptors(target, resolution: float, voxsp: float,
                    cfg: Optional[MadConfig] = None, name: str = "", *,
                    device=None) -> DescriptorSet:
    """Describe a map grid (on its own device unless ``device`` names
    another), a Structure, or a PDB path (parity mad/mad_utils.py:83)."""
    cfg = cfg or MadConfig()
    if isinstance(target, DensityGrid):
        return describe_grid(target, cfg, name=name, device=device)
    if isinstance(target, str):
        target = parse_pdb(target)
    return describe_structure(target, resolution, voxsp, cfg, name=name,
                              device=device)


def match_and_dock(map_set: DescriptorSet, sub_set: DescriptorSet,
                   sub_struct: Structure, dmap: DensityGrid,
                   resolution: float, cfg: Optional[MadConfig] = None,
                   n_copies: int = 1, *, device=None) -> List[Solution]:
    """Full match->filter->refine->score chain
    (parity mad/mad_utils.py:173,555)."""
    return dock_structure(map_set, sub_set, sub_struct, dmap, resolution,
                          cfg or MadConfig(), n_copies=n_copies,
                          verbose=False, device=device)


def benchmark_solutions(solutions: Sequence[Solution],
                        ref_structures: Sequence[Structure]) -> np.ndarray:
    """CA-RMSD of every solution against every reference pose
    (parity mad/mad_utils.py:474-508: per-solution RMSD benchmarking).

    Returns (n_solutions, n_refs); row minima tell which deposited pose a
    solution recovered.
    """
    out = np.full((len(solutions), len(ref_structures)), np.inf)
    for i, sol in enumerate(solutions):
        for j, ref in enumerate(ref_structures):
            out[i, j] = sol.structure.rmsd_ca_with(ref)
    return out


def get_repeatability(set_a: DescriptorSet, set_b: DescriptorSet,
                      radii=(2.0, 4.0, 6.0)) -> Dict[float, float]:
    """Anchor repeatability between two descriptor sets at several radii
    (parity mad/mad_utils.py:1227-1255): % of unique anchors of A with a
    neighbor in B within r."""
    a = np.unique(set_a.subv_coords, axis=0)
    b = np.unique(set_b.subv_coords, axis=0)
    if not len(a) or not len(b):
        return {float(r): 0.0 for r in radii}
    tree = cKDTree(b)
    d, _ = tree.query(a)
    return {float(r): float(100.0 * np.mean(d < r)) for r in radii}
