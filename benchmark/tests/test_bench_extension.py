"""A system of two kinds of subunit taken from new files alone: a map
builder (``systems/``), a job that docks each kind against one held
described map (``jobs/``), a judge layer (``layers/``), a configuration, a
mix and an entry of the workloads, all written beside copies of the
benchmark's own files in a directory of the test's, where the registry
looks. The cell runs through ``runner.run_cell`` on the CPU: correct as
it stands, each kind judged by the dock layer, and not correct with the
solutions of one kind left out."""

import copy
import json
import shutil
import time

import pytest

from harness import registry, runner

SYSTEM = '''
"""Two kinds of subunit, one copy each, ``spread`` A apart along x."""
import numpy as np

from harness.cell import Component, MapInput
from plainref import inputs, sim


def make_map(system, assembly_seed, device):
    kinds, placed = [], []
    for k, n_res in enumerate(system["n_res"]):
        mol = inputs.make_protein(n_res=n_res, seed=assembly_seed + k)
        mol = mol.with_coords(mol.coords - mol.center())
        kinds.append(Component(k, mol, 1))
        placed.append(mol.coords + [k * system["spread"], 0.0, 0.0])
    coords = np.concatenate(placed)
    masses = np.concatenate([c.mol.masses for c in kinds])
    vol, origins = sim.simulate(coords[None], masses[None],
                                system["resolution"], system["voxsp"],
                                device, shape_bucket=system["map_bucket"])
    vol, origin = sim.reduce_void(vol[0], origins[0], system["voxsp"],
                                  system["void_padding"])
    return MapInput(vol=vol, origin=origin, voxsp=system["voxsp"],
                    sub=kinds[0].mol, components=kinds)
'''

JOB = '''
"""Each kind described and docked against the map described once."""
LAYERS = ("rows", "dock", "kinds_docked")


def groups(cell):
    return 1


def setup(cell):
    cell.held = cell.program.describe_grid(cell.grids[0], cell.cfg,
                                           name="map", device=cell.device)


def subunit(cell, group, rng):
    return 0, 0, [c.mol for c in cell.maps[0].components]


def run(cell, map_index, structs, span, timings):
    p, cfg, dev = cell.program, cell.cfg, cell.device
    grid = cell.grids[map_index]
    comps = []
    for c, struct in zip(cell.maps[0].components, structs):
        sub_set = p.describe_structure(struct, cell.system["resolution"],
                                       grid.voxsp, cfg, name="subunit",
                                       device=dev)
        cands = []
        sols = p.dock_structure(cell.held, sub_set, struct, grid,
                                cell.system["resolution"], cfg,
                                n_copies=c.n_copies, verbose=False,
                                on_filtered=cands.extend, device=dev)
        comps.append(dict(kind=c.kind, n_copies=c.n_copies, sub_set=sub_set,
                          candidates=cands, sols=sols))
    return dict(map_set=cell.held, components=comps)
'''

LAYER = '''
"""The share of a job's kinds that the reference docks and the job does
not."""
NUMBERS = ("kinds_undocked",)
PARTS = ("kinds",)


def control(ref, out):
    pass


def compare(ref, c):
    return {"kinds": [dict(kind=k["kind"], solutions=len(k["sol_coords"]))
                      for k in c["components"]]}


def fold(parts):
    kinds = parts["kinds"]
    return {"kinds_undocked": sum(k["solutions"] == 0 for k in kinds)
            / max(len(kinds), 1)}
'''


@pytest.fixture
def toy(tiny, tmp_path, monkeypatch):
    """The benchmark's directory with the toy's files added; the cell's
    name and BENCHMARK.json with its entries."""
    bench = tmp_path / "benchmark"
    shutil.copytree(registry.BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        "tests", "harness", "plainref", "_cache", "__pycache__"))
    (bench / "systems" / "two_kinds.py").write_text(SYSTEM)
    (bench / "jobs" / "two_kinds.py").write_text(JOB)
    (bench / "layers" / "kinds_docked.py").write_text(LAYER)
    config = dict(copy.deepcopy(tiny), name="two_kinds")
    config["system"] = dict(builder="two_kinds", n_res=[40, 56], spread=32.0,
                            resolution=10.0, voxsp=1.4, map_bucket=16,
                            void_padding=10)
    config["limits"]["kinds_undocked"] = 0.0
    (bench / "configs" / "two_kinds.json").write_text(json.dumps(config))
    (bench / "traffic" / "two_kinds.json").write_text(json.dumps(dict(
        job="two_kinds", maps=1, decoy_shift=150.0, warmup_jobs=1,
        check_rounds=1)))
    spec = registry.benchmark()
    spec["workloads"].append(dict(name="two_kinds.dock", config="two_kinds",
                                  traffic="two_kinds", chips=1,
                                  why="two kinds docked against one map"))
    for m in spec["end_to_end"]:
        if m["name"] == "dock_s":
            m["workloads"].append("two_kinds.dock")
    monkeypatch.setattr(registry, "BENCH_DIR", bench)
    return spec


def run(spec):
    t0 = time.perf_counter()
    lines = []
    out = runner.run_cell(spec, "two_kinds.dock", 2 ** 31 + 21, 0.5, False,
                          "cpu", lambda: time.perf_counter() - t0,
                          lines.append)
    return out, lines


def test_two_kinds_from_new_files(toy):
    out, lines = run(toy)
    assert out["correct"], out["check"]
    assert set(out["check"]) == {"rows_differ", "candidates_differ",
                                 "solutions_differ", "ccc_gap",
                                 "kinds_undocked"}
    assert set(out["metrics"]) == {"setup_s", "dock_s"}
    # the dock layer judged each kind of the checked job
    (sols,) = [x for x in lines if x.startswith("solutions (")]
    assert len(sols.split(": ", 1)[1].split(", ")) == 2
    assert any(x.startswith("kinds (") for x in lines)


def test_one_kind_undocked_is_not_correct(toy, monkeypatch):
    from mad_tpu_torch.engine import docking
    real = docking.dock_structure
    n_second = 4 * 56

    def drop(map_set, sub_set, struct, *a, **k):
        sols = real(map_set, sub_set, struct, *a, **k)
        return [] if struct.coords.shape[0] == n_second else sols
    monkeypatch.setattr(docking, "dock_structure", drop)
    out, _lines = run(toy)
    assert not out["correct"]
    assert out["check"]["kinds_undocked"]["value"] == 0.5
    assert out["failed"] == out["attempted"]
