"""A homomer: ``n_copies`` copies of one subunit of ``n_res`` residues
(``make_assembly`` of :mod:`plainref.inputs`, on a ring or a shell of
radius ``spread``), simulated at the system's resolution on its grid by
the plain simulation (:mod:`plainref.sim`) and ``reduce_void``-ed. The
builder of every configuration whose ``system`` names no ``builder``."""

import numpy as np

from harness.cell import Component, MapInput
from plainref import inputs, sim


def make_map(system: dict, assembly_seed: int, device) -> MapInput:
    sub, copies, _poses = inputs.make_assembly(
        n_copies=system["n_copies"], n_res=system["n_res"],
        seed=assembly_seed, spread=system["spread"], shell=system["shell"])
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    vol, origins = sim.simulate(coords[None], masses[None],
                                system["resolution"], system["voxsp"],
                                device, shape_bucket=system["map_bucket"])
    vol, origin = sim.reduce_void(vol[0], origins[0], system["voxsp"],
                                  system["void_padding"])
    return MapInput(vol=vol, origin=origin, voxsp=system["voxsp"], sub=sub,
                    components=[Component(0, sub, system["n_copies"])])
