"""A heteromer: the system's ``kinds``, each a subunit of its own
(``make_protein`` of ``n_res`` residues in helices of ``res_per_segment``,
its own seed), centred, turned at random and placed on a ring of radius
``spread``, one place a copy; simulated at the system's resolution on its
grid by the plain simulation (:mod:`plainref.sim`) and ``reduce_void``-ed.
``components`` holds one :class:`Component` a kind, in the system's
order."""

import numpy as np

from harness.cell import Component, MapInput
from plainref import inputs, sim


def rotation(rng) -> np.ndarray:
    """A uniform random rotation (a normalised quaternion's matrix)."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def subunits(system: dict, assembly_seed: int):
    """Each kind's subunit at the origin, as [(kind, Mol, n_copies)]."""
    out = []
    for k, kind in enumerate(system["kinds"]):
        n_res = int(kind["n_res"])
        mol = inputs.make_protein(
            n_res=n_res, seed=1000 * int(assembly_seed) + k,
            n_segments=n_res // int(system["res_per_segment"]))
        out.append((k, mol.with_coords(mol.coords - mol.center()),
                    int(kind["n_copies"])))
    return out


def placed(system: dict, assembly_seed: int):
    """The components and every copy as the map holds it: (components,
    [Mol])."""
    rng = np.random.default_rng(int(assembly_seed))
    kinds = subunits(system, assembly_seed)
    n_places = sum(n for _k, _m, n in kinds)
    copies, place = [], 0
    for _k, mol, n_copies in kinds:
        for _c in range(n_copies):
            ang = 2 * np.pi * place / n_places
            t = system["spread"] * np.array([np.cos(ang), np.sin(ang),
                                             0.15 * rng.normal()])
            copies.append(mol.transformed(rotation(rng), t))
            place += 1
    return [Component(k, m, n) for k, m, n in kinds], copies


def make_map(system: dict, assembly_seed: int, device) -> MapInput:
    components, copies = placed(system, assembly_seed)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    vol, origins = sim.simulate(coords[None], masses[None],
                                system["resolution"], system["voxsp"],
                                device, shape_bucket=system["map_bucket"])
    vol, origin = sim.reduce_void(vol[0], origins[0], system["voxsp"],
                                  system["void_padding"])
    return MapInput(vol=vol, origin=origin, voxsp=system["voxsp"],
                    sub=components[0].mol, components=components)
