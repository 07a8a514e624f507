"""The assembly of a heteromer: the job's models, tuples of global indices
over the solutions of its kinds (the kinds with solutions, in order, each
kind's solutions in order), against the reference's ranking of the full
cartesian product of those same solutions from their overlap worked out
again (:func:`plainref.hetero.rank`; ``models_differ``, the share of
ranks that differ), and each model's CC to its tuple simulated again
(``model_ccc_gap``, the largest gap). Kinds of one copy each: their
subcomplexes are their solutions. A kind of several copies raises
:class:`KindWithCopies`: the checked outputs do not carry the
subcomplexes' composition that the reference would rank."""

import numpy as np

from plainref import hetero, judge

NUMBERS = ("models_differ", "model_ccc_gap")
PARTS = ()


class KindWithCopies(ValueError):
    """A checked job holds a kind of more than one copy."""


def _kinds(c):
    """The checked job's kinds that have solutions, in order."""
    for comp in c["components"]:
        if comp["n_copies"] != 1:
            raise KindWithCopies(
                f"layers/hetero_assembly.py judges kinds of one copy each, "
                f"and kind {comp['kind']} has {comp['n_copies']}: its "
                f"subcomplexes are not in the checked outputs")
        if "sol_coords" not in comp:
            raise KeyError(
                "layers/hetero_assembly.py judges the dock's solutions: the "
                "job's LAYERS have to name 'dock' before 'hetero_assembly'")
    return [comp for comp in c["components"] if len(comp["sol_coords"])]


def _flat(kinds):
    """Each solution's coordinates and its kind's masses, by global index,
    and each kind's solution count."""
    coords = [x for k in kinds for x in k["sol_coords"]]
    masses = [k["decoy"].masses for k in kinds for _x in k["sol_coords"]]
    return coords, masses, [len(k["sol_coords"]) for k in kinds]


def _ranked(ref, kinds, dtype):
    """The reference's model tuples (none below two kinds with solutions,
    as the job builds none)."""
    if len(kinds) < 2:
        return []
    coords, masses, sizes = _flat(kinds)
    ov = hetero.overlap32(coords, masses, ref.method["assembly"],
                          ref.m.vol.device, dtype)
    return hetero.rank(ov, sizes, ref.cell.traffic["max_models"],
                       ref.cell.traffic["max_overlap"])


def _cccs(ref, kinds, tuples, dtype):
    coords, masses, _sizes = _flat(kinds)
    m = ref.m
    return hetero.model_cccs(m.vol, m.origin, m.voxsp, coords, masses,
                             tuples, ref.method["assembly"]["cc_resolution"],
                             dtype)


def control(ref, out):
    kinds = _kinds(out)
    tuples = _ranked(ref, kinds, ref.LOW)
    out["models"] = [dict(components=list(t), ccc=float(c))
                     for t, c in zip(tuples, _cccs(ref, kinds, tuples,
                                                   ref.LOW))]


def compare(ref, c):
    kinds = _kinds(c)
    tuples = [tuple(x["components"]) for x in c["models"]]
    differ = judge.ranks_differ(tuples, _ranked(ref, kinds, ref.F32))
    n = sum(len(k["sol_coords"]) for k in kinds)
    if all(0 <= i < n for t in tuples for i in t):
        gap = judge.gap([x["ccc"] for x in c["models"]],
                        _cccs(ref, kinds, tuples, ref.F32))
    else:       # an index past the solutions: no model to score
        gap = float("inf")
    return {"models_differ": [differ], "model_ccc_gap": [gap]}


def fold(parts):
    return dict(models_differ=max(parts["models_differ"], default=0.0),
                model_ccc_gap=float(np.max([0.0, *parts["model_ccc_gap"]])))
