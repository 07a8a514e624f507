"""Runs the judge (:mod:`plainref.judge`) over a cell's checked jobs once
the window has closed, and holds each number to its limit.

A checked job's outputs are held to the plain reference layer by layer,
the layers that the job's module names (``LAYERS``), each a module
``benchmark/layers/<name>.py`` (:func:`registry.layer`) with

- ``NUMBERS``: the numbers it gives, each held to the configuration's
  limit of that name;
- ``PARTS``: the names of its parts that the run logs (``_parts``);
- ``control(ref, out)``: its outputs of the control, put into ``out`` as
  the program's are in a checked job (after those of the layers before
  it);
- ``compare(ref, c)``: one checked job's outputs ``c`` (the program's, or
  the control's) against the reference: {part name: [entries]};
- ``fold(parts)``: its numbers, from the entries of every checked job
  under each part name (an empty list for a name none gave).

``ref`` is the job's :class:`JobRef`: the map and each component's decoy
as the benchmark made them, and the reference's description of each,
worked out once and shared by the layers (the map's once across jobs).

``control=True`` puts the reference, computed in bfloat16, in the
program's place: each layer's ``control`` gives the outputs it judges
(the map and the decoys described, the dock refined on the map's
gradient field and scored, the assembly's overlap and CC worked out),
then they are judged as the program's are, against the float32
reference. It has to come out as not correct.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from plainref import describe as ref_describe

from . import registry


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def required(cell) -> list:
    return [n for name in cell.job.LAYERS
            for n in registry.layer(name).NUMBERS]


class JobRef:
    """One checked job as the layers see the reference: the cell, its map
    (:class:`harness.cell.MapInput`), the method, and the reference's
    described map and decoys, each worked out once at a dtype (``F32``;
    the control's ``LOW``)."""

    F32, LOW = torch.float32, torch.bfloat16

    def __init__(self, cell, o, maps: dict):
        self.cell = cell
        self.map_index = o.map_index
        self.m = cell.maps[o.map_index]
        self.method = cell.config["method"]
        self.res = cell.system["resolution"]
        self.pose_tol = cell.config["compare"]["pose_tol"]
        self.decoys = [c["decoy"] for c in o.checked["components"]]
        self._maps = maps
        self._subs = {}

    def described_map(self, dtype=F32):
        key = (self.map_index, dtype)
        if key not in self._maps:
            self._maps[key] = ref_describe.describe(
                self.m.vol, self.m.origin, self.m.voxsp, self.method, dtype)
        return self._maps[key]

    def described_decoy(self, i: int, dtype=F32):
        """The decoy of component ``i`` described."""
        if (i, dtype) not in self._subs:
            d = self.decoys[i]
            self._subs[i, dtype] = ref_describe.describe_mol(
                d.coords, d.masses, self.res, self.m.voxsp, self.method,
                self.m.vol.device, dtype)
        return self._subs[i, dtype]


def numbers(cell, control: bool = False, log=lambda s: None) -> dict:
    """The numbers compared, over the cell's checked jobs; ``_checked``
    their count and ``_parts`` the counts of each comparison."""
    _no_tf32()
    layers = [registry.layer(name) for name in cell.job.LAYERS]
    parts = [defaultdict(list) for _ in layers]
    maps = {}
    checked = [o for o in cell.outs if o.checked is not None]
    t0 = time.perf_counter()
    for o in checked:
        ref = JobRef(cell, o, maps)
        c = o.checked
        if control:
            c = dict(components=[
                {k: comp[k] for k in ("kind", "n_copies", "decoy")}
                for comp in o.checked["components"]])
            for layer in layers:
                layer.control(ref, c)
        for layer, got in zip(layers, parts):
            for name, entries in layer.compare(ref, c).items():
                got[name].extend(entries)
    out = {}
    for layer, got in zip(layers, parts):
        out.update(layer.fold(got))
    log(f"reference: {len(checked)} checked jobs in "
        f"{time.perf_counter() - t0:.2f} s")
    out["_checked"] = len(checked)
    out["_parts"] = {name: got[name] for layer, got in zip(layers, parts)
                     for name in layer.PARTS}
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
