"""Runs the judge (:mod:`plainref.judge`) over a cell's checked jobs once
the window has closed, and holds each number to its limit.

For each checked job the reference describes the map and the decoy from
the benchmark's own inputs and docks the decoy (:mod:`plainref.dock`);
the job's outputs are held to it layer by layer, the layers that the
job's module names (``LAYERS``): the rows of each described grid, the
dock's solutions, and the assembly, which the reference ranks again from
the overlap of the job's own solutions.

``control=True`` puts the reference, computed in bfloat16, in the
program's place: the map and the decoy described, the dock refined on
the map's gradient field and scored, and the assembly's overlap and CC
worked out, all in bfloat16, then judged as the program is against the
float32 reference. It has to come out as not correct.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from plainref import describe as ref_describe
from plainref import dock as ref_dock
from plainref import judge

# the numbers each layer of a job's outputs gives
NUMBERS = {"rows": ("rows_differ",),
           "dock": ("candidates_differ", "solutions_differ", "ccc_gap"),
           "assembly": ("models_differ", "model_ccc_gap")}


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def required(cell) -> list:
    return [n for layer in cell.job.LAYERS for n in NUMBERS[layer]]


def _rows(d) -> dict:
    return dict(octave=d.octave, subv=d.subv, main=d.main, sec=d.sec,
                desc=d.desc)


def _control(cell, o, m, low_map, method, low):
    """The control's outputs of one checked job: the reference in
    bfloat16."""
    decoy, res = o.checked["decoy"], cell.system["resolution"]
    sub = ref_describe.describe_mol(decoy.coords, decoy.masses, res,
                                    m.voxsp, method, m.vol.device, low)
    first, sols = ref_dock.dock(low_map, sub, decoy.coords, decoy.masses,
                                decoy.ca_idx, m.vol, m.origin, m.voxsp, res,
                                method, cell.system["n_copies"], dtype=low)
    coords = (np.stack([s.coords for s in sols]) if sols
              else np.zeros((0,) + decoy.coords.shape))
    out = dict(decoy=decoy, map_set=_rows(low_map), sub_set=_rows(sub),
               candidates=first, sol_coords=coords,
               sol_weight=[s.weight for s in sols],
               sol_ccc=[s.ccc for s in sols])
    if "assembly" in cell.job.LAYERS:
        tuples = _ranked(cell, coords, decoy.masses, method, low)
        cccs = judge.model_cccs(m.vol, m.origin, m.voxsp, coords,
                                decoy.masses, tuples,
                                method["assembly"]["cc_resolution"], low)
        out["models"] = [dict(components=list(t), ccc=float(c))
                         for t, c in zip(tuples, cccs)]
    return out


def _ranked(cell, coords, masses, method, dtype):
    """The reference's model tuples of a dock's solutions (none below
    two solutions, as the fit builds none)."""
    if len(coords) < 2:
        return []
    ov = ref_dock.overlap32(coords, masses, method["assembly"],
                            cell.maps[0].vol.device, dtype)
    return ref_dock.rank_tuples(ov, cell.system["n_copies"],
                                cell.traffic["max_models"],
                                cell.traffic["max_overlap"],
                                cell.maps[0].vol.device)


def numbers(cell, control: bool = False, log=lambda s: None) -> dict:
    """The numbers compared, over the cell's checked jobs; ``_checked``
    their count and ``_parts`` the counts of each comparison."""
    _no_tf32()
    method = cell.config["method"]
    res = cell.system["resolution"]
    layers = cell.job.LAYERS
    f32, low = torch.float32, torch.bfloat16
    ref_maps, low_maps = {}, {}
    rows, cands, sols = [], [], []
    ccc_gap, models_d, mccc_gap = 0.0, [], 0.0
    pose_tol = cell.config["compare"]["pose_tol"]
    checked = [o for o in cell.outs if o.checked is not None]
    t0 = time.perf_counter()
    for o in checked:
        m = cell.maps[o.map_index]
        decoy = o.checked["decoy"]
        if o.map_index not in ref_maps:
            ref_maps[o.map_index] = ref_describe.describe(
                m.vol, m.origin, m.voxsp, method, f32)
        ref_map = ref_maps[o.map_index]
        ref_sub = ref_describe.describe_mol(decoy.coords, decoy.masses, res,
                                            m.voxsp, method, m.vol.device,
                                            f32)
        if control:
            if o.map_index not in low_maps:
                low_maps[o.map_index] = ref_describe.describe(
                    m.vol, m.origin, m.voxsp, method, low)
            c = _control(cell, o, m, low_maps[o.map_index], method, low)
        else:
            c = o.checked
        if "rows" in layers:
            for part, ref in (("map_set", ref_map), ("sub_set", ref_sub)):
                rows.append(dict(judge.compare_rows(c[part], ref),
                                 part=part))
        if "dock" in layers:
            first, ref = ref_dock.dock(
                ref_map, ref_sub, decoy.coords, decoy.masses, decoy.ca_idx,
                m.vol, m.origin, m.voxsp, res, method,
                cell.system["n_copies"])
            cands.append(judge.compare_candidates(c["candidates"], first))
            ref_coords = (np.stack([s.coords for s in ref]) if ref
                          else np.zeros((0,) + decoy.coords.shape))
            cmp = judge.compare_solutions(
                c["sol_coords"], c["sol_weight"], ref_coords,
                [s.weight for s in ref], decoy.ca_idx, pose_tol)
            sols.append(dict(cmp, candidate=len(c["sol_coords"]),
                             reference=len(ref)))
            ccc = ref_dock.solution_cccs(m.vol, m.origin, m.voxsp,
                                         c["sol_coords"], decoy.masses, res,
                                         method["shape_bucket"], f32)
            ccc_gap = max(ccc_gap, judge.gap(c["sol_ccc"], ccc))
        if "assembly" in layers:
            tuples = [tuple(x["components"]) for x in c["models"]]
            ref_t = _ranked(cell, c["sol_coords"], decoy.masses, method, f32)
            models_d.append(judge.ranks_differ(tuples, ref_t))
            ref_ccc = judge.model_cccs(m.vol, m.origin, m.voxsp,
                                       c["sol_coords"], decoy.masses, tuples,
                                       method["assembly"]["cc_resolution"],
                                       f32)
            mccc_gap = max(mccc_gap, judge.gap(
                [x["ccc"] for x in c["models"]], ref_ccc))
    out = {}
    if "rows" in layers:
        out["rows_differ"] = judge.share_differ(rows)
    if "dock" in layers:
        out.update(candidates_differ=judge.share_differ(cands),
                   solutions_differ=judge.share_differ(sols),
                   ccc_gap=ccc_gap)
    if "assembly" in layers:
        out.update(models_differ=max(models_d, default=0.0),
                   model_ccc_gap=mccc_gap)
    log(f"reference: {len(checked)} checked jobs in "
        f"{time.perf_counter() - t0:.2f} s")
    out["_checked"] = len(checked)
    out["_parts"] = dict(rows=rows, candidates=cands, solutions=sols)
    return out


def verdict(nums: dict, limits: dict, names):
    """(correct, [[name, number, limit], ...]): each of ``names`` at or
    under its limit (a number missing, or with no limit, fails)."""
    rows, ok = [], True
    for name in names:
        v, limit = nums.get(name), limits.get(name)
        passed = (v is not None and limit is not None and np.isfinite(v)
                  and v <= limit)
        ok = ok and passed
        rows.append([name, None if v is None else float(v),
                     None if limit is None else float(limit)])
    return ok, rows
