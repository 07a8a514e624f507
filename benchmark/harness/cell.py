"""The one generator: a cell's inputs from its configuration, its traffic
and the seed, and the jobs it sends to the program.

Inputs. The configuration's ``system`` gives the assembly, its resolution
and grid, and names the builder of its maps under ``builder``, a module
``benchmark/systems/<builder>.py`` (:func:`registry.system`; ``homomer``
where it names none) with ``make_map(system, assembly_seed, device)``,
which gives a :class:`MapInput`: the map, and each kind of subunit in it
with its copies (``components``). The traffic's ``maps`` gives the size
of the pool of maps, one of each of the configuration's
``assembly_seeds``.

Jobs, one caller, each waiting for the last. The traffic's ``job`` names
the chain of the program's calls that a job makes, a module
``benchmark/jobs/<job>.py`` (:func:`registry.job`) with

- ``LAYERS``: the judge's layers that its outputs are held to, each a
  module ``benchmark/layers/<name>.py`` (:mod:`harness.check`);
- ``groups(cell)``: how many groups the jobs take in turn (maps,
  conformers), job j taking group j mod groups;
- ``setup(cell)``: what the job holds across jobs (a described map);
- ``subunit(cell, group, rng)``: (map index, conformer kind, the
  subunit before its decoy pose), or a list of subunits, one a
  component, each given a decoy pose in turn;
- ``run(cell, map_index, struct, span, timings)``: the calls (``struct``
  a list where ``subunit`` gave one), returning a dict of ``map_set``,
  ``models`` and either ``components``, a list of one dict a kind
  (``kind``, ``n_copies``, ``sub_set``, ``candidates``, ``sols``), or
  those three of one component with the system's ``n_copies``:
  ``sub_set``, ``candidates`` (the dock's first round, through its
  ``on_filtered`` hook) and ``sols``.

Every job's subunit, decoy pose (turns about x, y and z uniform in
[0, 2 pi), the centre ``decoy_shift`` A out in a uniform direction) and
any deformation come from (``--seed``, the job's index) alone, warm-up
jobs from a stream of their own: no job repeats another's inputs. The
seed also draws the checked jobs: one job of each group among the
window's first ``check_rounds`` rounds.

The program is ``mad_tpu_torch``, imported here (:class:`Program`, the
entry points the job modules call) and nowhere in :mod:`plainref`; what
it returns is turned into numpy arrays and tensors for the judge.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from plainref import inputs

from . import registry


def seq(seed: int, *keys) -> np.random.Generator:
    """A generator of its own for (seed, keys...)."""
    return np.random.default_rng([int(seed) % (1 << 63), *keys])


class Component(NamedTuple):
    """One kind of subunit in a map."""

    kind: int
    mol: inputs.Mol            # the subunit at the origin
    n_copies: int


@dataclass
class MapInput:
    vol: torch.Tensor          # (X, Y, Z) float32 on the card
    origin: np.ndarray         # (3,) A
    voxsp: float
    sub: inputs.Mol            # the first component's subunit at the origin
    components: List[Component] = field(default_factory=list)


def program_config(overrides: dict):
    """The program's MadConfig with the configuration's ``program``
    overrides ({section: {field: value}})."""
    from mad_tpu_torch.core.config import MadConfig
    cfg = MadConfig()
    for section, fields in overrides.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **fields)})
    return cfg


def check_method(cfg, method: dict) -> List[str]:
    """The fields where the program's configuration differs from the
    method the reference runs (empty when they agree)."""
    out = []
    for section, fields in method.items():
        if not isinstance(fields, dict):
            if getattr(cfg, section) != fields:
                out.append(f"{section}: {getattr(cfg, section)} != {fields}")
            continue
        have = dataclasses.asdict(getattr(cfg, section))
        for k, v in fields.items():
            if have.get(k) != v:
                out.append(f"{section}.{k}: {have.get(k)} != {v}")
    return out


def to_structure(mol: inputs.Mol):
    from mad_tpu_torch.core.structure import Structure
    n = mol.coords.shape[0]
    return Structure(coords=np.asarray(mol.coords, dtype=np.float64),
                     masses=np.asarray(mol.masses, dtype=np.float32),
                     ca_idx=np.asarray(mol.ca_idx), bb_idx=np.arange(n),
                     info=[], source=mol.source)


def to_grid(m: MapInput, name: str):
    from mad_tpu_torch.core.grid import DensityGrid
    return DensityGrid(data=m.vol, origin=np.asarray(m.origin, np.float64),
                       voxsp=float(m.voxsp), name=name)


def adapt_set(ds) -> dict:
    """A DescriptorSet as the judge reads it (the rows stay on the
    device)."""
    return dict(octave=np.asarray(ds.octave), subv=np.asarray(ds.subv_coords),
                main=np.asarray(ds.main_bin), sec=np.asarray(ds.sec_bin),
                desc=ds.desc)


def checked_component(comp: dict, decoy: inputs.Mol) -> dict:
    """One component's outputs of a checked job as the judge reads them:
    its decoy, rows, first-round candidates and solutions stacked."""
    out = dict(kind=comp["kind"], n_copies=comp["n_copies"], decoy=decoy)
    if "sub_set" in comp:
        out["sub_set"] = adapt_set(comp["sub_set"])
    if "candidates" in comp:
        out["candidates"] = [dict(hi=c.hi_coord, lo=c.lo_coord,
                                  weight=c.weight)
                             for c in comp["candidates"]]
    if "sols" in comp:
        sols = comp["sols"]
        out.update(
            sol_coords=(np.stack([s.structure.coords for s in sols])
                        if sols else np.zeros((0,) + decoy.coords.shape)),
            sol_weight=np.asarray([s.weight for s in sols]),
            sol_ccc=np.asarray([s.ccc for s in sols]))
    return out


@dataclass
class JobOut:
    """What one job leaves for the judge and the readers."""

    map_index: int
    kind: int                               # conformer kind, else 0
    n_solutions: int
    checked: Optional[dict] = None          # full outputs of checked jobs
    stages: Dict[str, float] = field(default_factory=dict)
    map_shape: tuple = ()


class Program:
    """The program's entry points that the jobs call."""

    def __init__(self):
        from mad_tpu_torch.engine import assemble
        from mad_tpu_torch.engine.docking import dock_structure
        from mad_tpu_torch.engine.pipeline import (describe_grid,
                                                   describe_structure)
        self.describe_grid = describe_grid
        self.describe_structure = describe_structure
        self.dock_structure = dock_structure
        self.assemble = assemble


class Cell:
    """A configuration under a traffic mix, for one seed, on a device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 traced: bool = False):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.traced = traced
        self.system = config["system"]
        self.job = registry.job(traffic["job"])
        self.n_maps = int(traffic["maps"])
        self.maps: List[MapInput] = []
        self.reseed(seed)

    @property
    def groups(self) -> int:
        return int(self.job.groups(self))

    def reseed(self, seed: int):
        """What the seed draws: the jobs' inputs and the checked jobs; no
        job run yet."""
        self.seed = int(seed)
        rng = seq(seed, 0)
        g, rounds = self.groups, int(self.traffic.get("check_rounds", 1))
        self.checked = sorted(int(k + g * rng.integers(rounds))
                              for k in range(g))
        self.outs: List[JobOut] = []

    # -- set-up -----------------------------------------------------------

    def setup(self):
        self.program = Program()
        self.cfg = program_config(self.config.get("program", {}))
        bad = check_method(self.cfg, self.config["method"])
        if bad:
            raise RuntimeError("the program's configuration is not the "
                               "method the reference runs: " + "; ".join(bad))
        seeds = self.config["assumed"]["assembly_seeds"][: self.n_maps]
        builder = registry.system(self.system.get("builder", "homomer"))
        self.maps = [builder.make_map(self.system, s, self.device)
                     for s in seeds]
        self.grids = [to_grid(m, f"map{i}") for i, m in enumerate(self.maps)]
        self.job.setup(self)

    # -- one job ----------------------------------------------------------

    def job_inputs(self, j: int):
        """(map index, conformer kind, the decoy as a Mol, or a list of
        them where the job's ``subunit`` gives one) of job j (of warm-up
        job -1 - j where j < 0)."""
        rng = seq(self.seed, 1, j) if j >= 0 else seq(self.seed, 2, -1 - j)
        group = (j if j >= 0 else -1 - j) % self.groups
        mi, kind, mol = self.job.subunit(self, group, rng)
        if isinstance(mol, list):
            return mi, kind, [self.decoy(m, rng) for m in mol]
        return mi, kind, self.decoy(mol, rng)

    def decoy(self, mol: inputs.Mol, rng) -> inputs.Mol:
        """The subunit at a pose drawn from ``rng``."""
        a, b, c = rng.uniform(0.0, 2.0 * np.pi, 3)
        d = rng.normal(size=3)
        t = float(self.traffic["decoy_shift"]) * d / np.linalg.norm(d)
        return inputs.decoy_transform(mol, t, a, b, c)

    @contextlib.contextmanager
    def span(self, name: str, stages: dict):
        """A ``bench.<name>`` span in a traced run (ended by a synchronize,
        its seconds into ``stages``); nothing otherwise."""
        if not self.traced:
            yield
            return
        t = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t

    def run_job(self, j: int, keep: bool = True) -> JobOut:
        mi, kind, mol = self.job_inputs(j)
        many = isinstance(mol, list)
        decoys = mol if many else [mol]
        structs = [to_structure(m) for m in decoys]
        stages: Dict[str, float] = {}
        timings = {} if self.traced else None
        span = lambda name: self.span(name, stages)
        with span("job"):
            got = self.job.run(self, mi, structs if many else structs[0],
                               span, timings)
        stages.update(timings or {})
        comps = got.get("components") or [dict(
            kind=0, n_copies=self.system["n_copies"],
            **{k: got[k] for k in ("sub_set", "candidates", "sols")
               if k in got})]
        out = JobOut(map_index=mi, kind=kind,
                     n_solutions=min(len(c.get("sols", [])) for c in comps),
                     stages=stages, map_shape=tuple(self.grids[mi].shape))
        if keep and j in self.checked:
            out.checked = dict(components=[
                checked_component(c, d)
                for c, d in zip(comps, decoys, strict=True)])
            if "map_set" in got:
                out.checked["map_set"] = adapt_set(got["map_set"])
            if "models" in got:
                out.checked["models"] = [
                    dict(components=list(m.components), ccc=float(m.ccc))
                    for m in got["models"]]
        return out

    def free_program(self):
        """Drop what the program holds (a held map set, the grids) before
        the reference runs."""
        self.held = None
        self.grids = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
