"""The assembly of a homomer: the job's models, tuples of its one
component's solutions, against the reference's ranking of the tuples of
those same solutions from their overlap worked out again
(:func:`plainref.dock.rank_tuples`; ``models_differ``, the largest share
of ranks that differ), and each model's CC to its tuple simulated again
(``model_ccc_gap``, the largest gap)."""

import numpy as np

from plainref import dock as ref_dock
from plainref import judge

NUMBERS = ("models_differ", "model_ccc_gap")
PARTS = ()


def _one(c):
    """The checked job's one component, with the dock's solutions."""
    if len(c["components"]) != 1:
        raise ValueError(
            f"layers/assembly.py ranks the tuples of one component, and "
            f"this job has {len(c['components'])}: a job of several kinds "
            f"needs an assembly layer of its own")
    (comp,) = c["components"]
    if "sol_coords" not in comp:
        raise KeyError(
            "layers/assembly.py judges the dock's solutions: the job's "
            "LAYERS have to name 'dock' before 'assembly'")
    return comp


def _ranked(ref, comp, dtype):
    """The reference's model tuples of a dock's solutions (none below
    two solutions, as the fit builds none)."""
    coords = comp["sol_coords"]
    if len(coords) < 2:
        return []
    device = ref.cell.maps[0].vol.device
    ov = ref_dock.overlap32(coords, comp["decoy"].masses,
                            ref.method["assembly"], device, dtype)
    return ref_dock.rank_tuples(ov, comp["n_copies"],
                                ref.cell.traffic["max_models"],
                                ref.cell.traffic["max_overlap"], device)


def _cccs(ref, comp, tuples, dtype):
    m = ref.m
    return judge.model_cccs(m.vol, m.origin, m.voxsp, comp["sol_coords"],
                            comp["decoy"].masses, tuples,
                            ref.method["assembly"]["cc_resolution"], dtype)


def control(ref, out):
    comp = _one(out)
    tuples = _ranked(ref, comp, ref.LOW)
    out["models"] = [dict(components=list(t), ccc=float(c))
                     for t, c in zip(tuples, _cccs(ref, comp, tuples,
                                                   ref.LOW))]


def compare(ref, c):
    comp = _one(c)
    tuples = [tuple(x["components"]) for x in c["models"]]
    ref_t = _ranked(ref, comp, ref.F32)
    differ = judge.ranks_differ(tuples, ref_t)
    ccc = _cccs(ref, comp, tuples, ref.F32)
    return {"models_differ": [differ],
            "model_ccc_gap": [judge.gap([x["ccc"] for x in c["models"]],
                                        ccc)]}


def fold(parts):
    return dict(models_differ=max(parts["models_differ"], default=0.0),
                model_ccc_gap=float(np.max([0.0, *parts["model_ccc_gap"]])))
