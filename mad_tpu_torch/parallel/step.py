"""One whole multi-device docking step over a mesh (port of
mad_tpu/parallel/step.py:25-58).

Runs the port's pipeline with a mesh, the path ``api.MaD(mesh=...)`` takes,
on a small synthetic dimer: the map and the subunit described in capacity
mode (the octave fields in x-slabs over the shards) and the subunit docked
with every stage of the dock sharded (``engine.docking.dock_structure``'s
docstring says how). mad_tpu's own step runs on its virtual CPU mesh;
this one runs on any mesh ``make_mesh`` gives: ``devices=["cpu"] * n`` on
the CPU, ``["cuda:0"] * n`` on one card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .mesh import make_mesh


def multichip_step(n_devices: int, devices=None, n_res: int = 40,
                   seed: int = 3, resolution: float = 8.0,
                   voxsp: float = 2.0) -> int:
    """Describe + dock a small synthetic dimer with every stage sharded
    over an n-shard mesh (``make_mesh(n_devices, devices)``); returns the
    number of solutions found."""
    from ..core.config import MadConfig
    from ..engine.docking import dock_structure
    from ..engine.pipeline import describe_grid
    from ..ops.simulate import simulate_density
    from ..testing import make_assembly

    mesh = make_mesh(n_devices, devices)
    cfg = MadConfig()
    # The dimer's ~200 anchors need no 4096-lane buffer (mad_tpu's setting).
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 max_anchors=1024))
    sub, copies = make_assembly(n_copies=2, n_res=n_res, seed=seed,
                                spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, resolution, voxsp, device=mesh.home,
                            masses=masses, shape_bucket=cfg.shape_bucket)
    sub_grid = simulate_density(sub, resolution, voxsp, device=mesh.home,
                                shape_bucket=cfg.shape_bucket)
    map_dsc = describe_grid(dmap, cfg, name="map", mesh=mesh)
    sub_dsc = describe_grid(sub_grid, cfg, name="sub", mesh=mesh)
    sols = dock_structure(map_dsc, sub_dsc, sub, dmap, resolution, cfg,
                          n_copies=2, verbose=False, mesh=mesh)
    return len(sols)
