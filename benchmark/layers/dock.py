"""The dock: each component's decoy docked by the reference
(:func:`plainref.dock.dock`, with the component's ``n_copies``) on the
described map, and the job's first-round candidates and solutions held
to it (``candidates_differ``, ``solutions_differ``: of the union over the
checked jobs' components, the share on one side only or unequal), and
each solution's CC to its pose simulated and correlated again
(``ccc_gap``, the largest gap)."""

import numpy as np

from plainref import dock as ref_dock
from plainref import judge

NUMBERS = ("candidates_differ", "solutions_differ", "ccc_gap")
PARTS = ("candidates", "solutions")


def _dock(ref, i, comp, dtype):
    d, m = comp["decoy"], ref.m
    return ref_dock.dock(ref.described_map(dtype),
                         ref.described_decoy(i, dtype), d.coords, d.masses,
                         d.ca_idx, m.vol, m.origin, m.voxsp, ref.res,
                         ref.method, comp["n_copies"], dtype=dtype)


def _coords(sols, decoy):
    return (np.stack([s.coords for s in sols]) if sols
            else np.zeros((0,) + decoy.coords.shape))


def control(ref, out):
    for i, comp in enumerate(out["components"]):
        first, sols = _dock(ref, i, comp, ref.LOW)
        comp.update(candidates=first, sol_coords=_coords(sols, comp["decoy"]),
                    sol_weight=[s.weight for s in sols],
                    sol_ccc=[s.ccc for s in sols])


def compare(ref, c):
    out = {"candidates": [], "solutions": [], "ccc_gap": []}
    m = ref.m
    for i, comp in enumerate(c["components"]):
        decoy = comp["decoy"]
        first, sols = _dock(ref, i, comp, ref.F32)
        out["candidates"].append(
            judge.compare_candidates(comp["candidates"], first))
        cmp = judge.compare_solutions(
            comp["sol_coords"], comp["sol_weight"], _coords(sols, decoy),
            [s.weight for s in sols], decoy.ca_idx, ref.pose_tol)
        out["solutions"].append(dict(cmp, candidate=len(comp["sol_coords"]),
                                     reference=len(sols)))
        ccc = ref_dock.solution_cccs(m.vol, m.origin, m.voxsp,
                                     comp["sol_coords"], decoy.masses,
                                     ref.res, ref.method["shape_bucket"],
                                     ref.F32)
        out["ccc_gap"].append(judge.gap(comp["sol_ccc"], ccc))
    return out


def fold(parts):
    # np.max: a NaN gap stays NaN, and fails its limit
    return dict(candidates_differ=judge.share_differ(parts["candidates"]),
                solutions_differ=judge.share_differ(parts["solutions"]),
                ccc_gap=float(np.max([0.0, *parts["ccc_gap"]])))
