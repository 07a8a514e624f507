"""Port parity: the whole dock, the ``MaD`` session and the multi-device
step on a mesh of CPU shards (``make_mesh(n, devices=["cpu"] * n)``)
against the port's single-device runs, with the plain versions of the
kernels.

Required (mad_tpu's gates between its mesh and single-device docks,
tests/test_parallel.py:184-225):
  * ``dock_structure(mesh=)`` on 3 and 8 shards, on the two-copy dimer
    with a rescue round that clusters (n_copies 1 and 10 samples a round,
    so the first round finds one copy and the rescue round the other):
    the same solutions, weights equal, coords within 1e-3 A, and the
    rescue round's exact re-score and clustering ran on the mesh;
  * ``MaD(mesh=)`` on the dimer of tests/test_api_e2e.py: the single-
    device session's solutions (weights equal, coords within 1e-3 A);
    ``MaD(mesh="auto")`` without two cards has no mesh;
  * ``multichip_step`` on 4 shards returns the single-device step's
    solution count, at least one;
  * a ``device`` that is not the mesh's home raises.
The comparison of the port's mesh dock and step with mad_tpu's is in the
slow tier.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.core.grid import write_mrc as jwrite_mrc
from mad_tpu.core.structure import write_pdb as jwrite_pdb
from mad_tpu.engine import docking as jdock
from mad_tpu.engine import pipeline as jpipe
from mad_tpu.ops.simulate import simulate_density as jsimulate
from mad_tpu.parallel.mesh import make_mesh as jmake_mesh
from mad_tpu.testing import make_assembly as jmake_assembly
from mad_tpu_torch.api import MaD
from mad_tpu_torch.core.config import MadConfig
from mad_tpu_torch.engine import docking as tdock
from mad_tpu_torch.engine.pipeline import describe_grid, describe_structure
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.parallel.mesh import auto_mesh, make_mesh
from mad_tpu_torch.parallel.step import multichip_step
from mad_tpu_torch.testing import decoy_transform, make_assembly, recording

torch.set_num_threads(1)

COORD_TOL = 1e-3
RES, VOXSP = 8.0, 2.0


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _rescue_cfg(cls):
    c = cls()
    return c.replace(
        detect=dataclasses.replace(c.detect, max_anchors=1024),
        filter=dataclasses.replace(c.filter, rescue_rounds=1, n_samples=10))


@pytest.fixture(scope="module")
def dimer():
    """The SMALL dimer of chip_smoke.py, described once on one device."""
    cfg = _rescue_cfg(MadConfig)
    sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, RES, VOXSP, device="cpu",
                            masses=masses).reduce_void()
    moved = decoy_transform(sub)
    m = describe_grid(dmap, cfg, name="map", device="cpu")
    s = describe_structure(moved, RES, VOXSP, cfg, name="sub", device="cpu")
    return cfg, dmap, moved, m, s, copies


def _same_solutions(got, want):
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert a.weight == b.weight
        np.testing.assert_allclose(a.structure.coords, b.structure.coords,
                                   rtol=0, atol=COORD_TOL)


@pytest.mark.parametrize("n", [3, 8])
def test_dock_on_shards_with_a_rescue_round(dimer, n):
    cfg, dmap, moved, m, s, copies = dimer
    one = tdock.dock_structure(m, s, moved, dmap, RES, cfg, verbose=False,
                               n_copies=1,
                               device="cpu")
    with recording(tdock, "cluster_select") as cs, \
            recording(tdock, "exact_rescore") as er:
        got = tdock.dock_structure(m, s, moved, dmap, RES, cfg, verbose=False,
                                   n_copies=1,
                                   mesh=cpu_mesh(n))
    assert len(cs) == 2 and len(er) == 1 and er[0][4] is not None
    _same_solutions(got, one)
    for c in copies:
        assert min(x.structure.rmsd_ca_with(c) for x in got) < 4.0


def test_session_on_a_mesh(tmp_path):
    _sub, copies = jmake_assembly(n_copies=2, n_res=60, seed=4, spread=16.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    map_path, sub_path = str(tmp_path / "dimer_map.mrc"), str(
        tmp_path / "subunit.pdb")
    jwrite_mrc(jsimulate(coords, 8.0, 2.0, masses=masses), map_path)
    jwrite_pdb(copies[0], sub_path)
    sols = []
    for kw in (dict(device="cpu"), dict(mesh=cpu_mesh(3))):
        mad = MaD(workdir=str(tmp_path / f"w{len(sols)}"), **kw)
        mad.pose_checkpoint = False
        mad.add_map(map_path, resolution=8.0)
        mad.add_subunit(sub_path, n_copies=2)
        mad.run(transform_subunits=True)
        sols.append(mad.solutions["subunit"])
    assert mad.device == torch.device("cpu") and len(mad.mesh) == 3
    _same_solutions(sols[1], sols[0])


def test_auto_mesh_and_the_home_device(dimer):
    cfg, dmap, moved, m, s, _copies = dimer
    assert auto_mesh() is None          # no cards here
    assert MaD(workdir=".", device="cpu", mesh="auto").mesh is None
    mesh = make_mesh(2, devices=["cpu", "meta"])
    with pytest.raises(ValueError):
        MaD(workdir=".", device="cpu", mesh=make_mesh(2, devices=["meta"]
                                                      * 2))
    with pytest.raises(ValueError):
        tdock.dock_structure(m, s, moved, dmap, RES, cfg, verbose=False,
                             device="meta",
                             mesh=mesh)


def test_multichip_step_on_cpu_shards():
    n = multichip_step(4, devices=["cpu"] * 4)
    assert n >= 1 and n == multichip_step(1, devices=["cpu"])


@pytest.mark.slow
def test_dock_on_shards_equals_mad_tpu_mesh(monkeypatch):
    """The port's mesh dock against mad_tpu's mesh dock on its split path
    (test_fused_dock_mesh_equals_single's case, tests/test_parallel.py:
    184-225; mad_tpu's fused mesh programs fail to trace under the
    installed JAX, ROADMAP Queue 3): the same solution count and weights,
    poses within 0.5 A."""
    monkeypatch.setenv("MAD_TPU_FUSED_DOCK", "0")
    jcfg, tcfg = (JConfig(), MadConfig())
    jcfg, tcfg = [c.replace(
        detect=dataclasses.replace(c.detect, max_anchors=1024),
        filter=dataclasses.replace(c.filter, rescue_rounds=1))
        for c in (jcfg, tcfg)]
    sub, copies = jmake_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    jmap = jsimulate(coords, RES, VOXSP, masses=masses,
                     shape_bucket=jcfg.shape_bucket)
    jsub = jsimulate(sub, RES, VOXSP, shape_bucket=jcfg.shape_bucket)
    js = jdock.dock_structure(
        jpipe.describe_grid(jmap, jcfg, name="map"),
        jpipe.describe_grid(jsub, jcfg, name="sub"), sub, jmap, RES, jcfg,
        n_copies=2, verbose=False, mesh=jmake_mesh(8))
    tsub, _ = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    tmap = simulate_density(coords, RES, VOXSP, device="cpu", masses=masses,
                            shape_bucket=tcfg.shape_bucket)
    tgrid = simulate_density(tsub, RES, VOXSP, device="cpu",
                             shape_bucket=tcfg.shape_bucket)
    ts = tdock.dock_structure(
        describe_grid(tmap, tcfg, name="map", device="cpu"),
        describe_grid(tgrid, tcfg, name="sub", device="cpu"), tsub, tmap,
        RES, tcfg, verbose=False, n_copies=2, mesh=cpu_mesh(8))
    assert len(ts) == len(js) >= 2
    for a, b in zip(ts, js):
        assert a.weight == b.weight
        assert a.structure.rmsd_ca_with(b.structure) <= 0.5


@pytest.mark.slow
def test_multichip_step_equals_mad_tpu():
    from mad_tpu.parallel.step import multichip_step as jstep
    assert multichip_step(4, devices=["cpu"] * 4) == jstep(4) >= 1
