"""Build the port's stage state from numpy arrays and plain attributes.

The stages pass a ``DensityGrid``, a ``DescriptorSet``, a ``MatchTable``
and ``Structure``s along; these constructors make them from host arrays
(for example another implementation's output pulled to numpy), so any
stage can be fed the exact upstream state it would see in a run.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.grid import DensityGrid
from .core.structure import Structure
from .device import resolve
from .engine.match import MatchTable
from .engine.pipeline import DescriptorSet
from .kernels.gather_norm import gather_norm


def grid_from_numpy(data, origin, voxsp: float, name: str = "",
                    device="cuda") -> DensityGrid:
    """(X, Y, Z) density -> DensityGrid with float32 data on ``device``."""
    return DensityGrid(
        data=torch.tensor(np.asarray(data, dtype=np.float32),
                          device=resolve(device)),
        origin=np.asarray(origin, dtype=np.float64).copy(),
        voxsp=float(voxsp), name=name)


def descriptor_set_from_numpy(desc, coords, map_coords, subv_coords, rfinal,
                              octave, anchor_id, main_bin, sec_bin,
                              eqsp_size: int = 112, subeqsp_size: int = 16,
                              name: str = "", device="cuda") -> DescriptorSet:
    """Rows of a descriptor table -> DescriptorSet. ``desc`` may carry
    trailing padding rows; the row count is that of ``coords``. The unit
    rows come from K8, every row kept."""
    n = int(np.asarray(coords).shape[0])
    dev = resolve(device)
    d, unit = gather_norm(
        [torch.tensor(np.asarray(desc)[:n].astype(np.int16), device=dev)],
        [torch.arange(n, device=dev)])
    return DescriptorSet(
        desc=d, desc_norm=unit,
        coords=np.asarray(coords, dtype=np.float32),
        map_coords=np.asarray(map_coords, dtype=np.float64),
        subv_coords=np.asarray(subv_coords, dtype=np.float64),
        rfinal=np.asarray(rfinal, dtype=np.float32),
        octave=np.asarray(octave, dtype=np.int32),
        anchor_id=np.asarray(anchor_id, dtype=np.int32),
        main_bin=np.asarray(main_bin, dtype=np.int32),
        sec_bin=np.asarray(sec_bin, dtype=np.int32),
        eqsp_size=int(eqsp_size), subeqsp_size=int(subeqsp_size), name=name,
        n_rows=n)


def match_table_from_numpy(cc, repeat, hi_idx, lo_idx, rot, hi_coord,
                           lo_coord, hi_cloud, lo_cloud) -> MatchTable:
    """Per-pair match arrays (sorted by repeatability) -> MatchTable."""
    return MatchTable(
        cc=np.asarray(cc), repeat=np.asarray(repeat),
        hi_idx=np.asarray(hi_idx), lo_idx=np.asarray(lo_idx),
        rot=np.asarray(rot), hi_coord=np.asarray(hi_coord),
        lo_coord=np.asarray(lo_coord), hi_cloud=np.asarray(hi_cloud),
        lo_cloud=np.asarray(lo_cloud))


def structure_from_numpy(coords, masses, ca_idx, bb_idx, info=None,
                         source: str = "") -> Structure:
    """Atom arrays (for example another implementation's docking solution)
    -> Structure: float64 coords, float32 masses, int64 index arrays."""
    return Structure(
        coords=np.asarray(coords, dtype=np.float64).copy(),
        masses=np.asarray(masses, dtype=np.float32).copy(),
        ca_idx=np.asarray(ca_idx, dtype=np.int64).copy(),
        bb_idx=np.asarray(bb_idx, dtype=np.int64).copy(),
        info=list(info) if info is not None else [], source=source)
