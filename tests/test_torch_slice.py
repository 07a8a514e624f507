"""Port parity: the whole fit slice (simulate -> reduce_void -> describe map
and decoy subunit -> dock with one rescue round -> CC-score) on a small
two-copy self-fit, through mad_tpu and mad_tpu_torch.

mad_tpu runs its split docking path (the semantics the port carries; its
fused path is tested equal to it in tests/test_dock_fused.py).

Required:
  * describe: the same row count, anchor ids and main bins; descriptor
    rows equal in >= 99 % of rows (zone-bound ulps, as in
    test_torch_orient_describe.py);
  * dock: the same number of solutions; per solution, in rank order, the
    port's pose within 0.5 A CA-RMSD of mad_tpu's and CCC within 1e-4;
    the same recovered count (best CA-RMSD < 10 A, bench.py's rule).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu.api import _decoy_transform
from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.engine import docking as jdock
from mad_tpu.engine import pipeline as jpipe
from mad_tpu.ops import simulate as jsim
from mad_tpu.testing import make_assembly as jmake_assembly
from mad_tpu_torch.convert import descriptor_set_from_numpy, grid_from_numpy
from mad_tpu_torch.core.config import MadConfig as TConfig
from mad_tpu_torch.engine import docking as tdock
from mad_tpu_torch.engine import pipeline as tpipe
from mad_tpu_torch.ops import simulate as tsim
from mad_tpu_torch.testing import decoy_transform, make_assembly

torch.set_num_threads(1)

POSE_TOL = 0.5
CCC_TOL = 1e-4
ROWS_EQUAL = 0.99
RES, VOXSP, N_COPIES = 8.0, 2.0, 2


def _cfgs():
    out = []
    for C in (JConfig, TConfig):
        c = C()
        out.append(c.replace(
            detect=dataclasses.replace(c.detect, max_anchors=1024),
            filter=dataclasses.replace(c.filter, rescue_rounds=1)))
    return out


def _fields(ds):
    n = ds.n
    return dict(desc=np.asarray(ds.desc)[:n], coords=ds.coords,
                map_coords=ds.map_coords, subv_coords=ds.subv_coords,
                rfinal=ds.rfinal, octave=ds.octave, anchor_id=ds.anchor_id,
                main_bin=ds.main_bin, sec_bin=ds.sec_bin,
                eqsp_size=ds.eqsp_size, subeqsp_size=ds.subeqsp_size,
                name=ds.name)


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = _cfgs()
    # mad_tpu side
    sub, copies = jmake_assembly(n_copies=N_COPIES, n_res=40, seed=3,
                                 spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    jmap = jsim.simulate_density(coords, RES, VOXSP, masses=masses
                                 ).reduce_void()
    jmoved = _decoy_transform(sub)
    jm = jpipe.describe_grid(jmap, jcfg, name="map")
    js = jpipe.describe_structure(jmoved, RES, VOXSP, jcfg, name="sub")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAD_TPU_FUSED_DOCK", "0")
        jsols = jdock.dock_structure(jm, js, jmoved, jmap, RES, jcfg,
                                     n_copies=N_COPIES, verbose=False)
    # port side, through its own copies of the system builders
    tsub, tcopies = make_assembly(n_copies=N_COPIES, n_res=40, seed=3,
                                  spread=14.0)
    tcoords = np.concatenate([c.coords for c in tcopies])
    tmasses = np.concatenate([c.masses for c in tcopies])
    tmap = tsim.simulate_density(tcoords, RES, VOXSP, device="cpu",
                                 masses=tmasses).reduce_void()
    tmoved = decoy_transform(tsub)
    tm = tpipe.describe_grid(tmap, tcfg, name="map", device="cpu")
    ts = tpipe.describe_structure(tmoved, RES, VOXSP, tcfg, name="sub",
                                  device="cpu")
    tsols = tdock.dock_structure(tm, ts, tmoved, tmap, RES, tcfg,
                                 verbose=False,
                                 n_copies=N_COPIES, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, copies=copies, jmap=jmap, jm=jm,
                js=js, jmoved=jmoved, jsols=jsols, tmap=tmap, tm=tm, ts=ts,
                tsols=tsols)


def test_map_is_the_same(both):
    j, t = both["jmap"], both["tmap"]
    np.testing.assert_array_equal(t.origin, j.origin)
    got, ref = t.host(), np.asarray(j.data)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("which", ["jm", "js"])
def test_descriptor_sets(both, which):
    j = both[which]
    t = both["tm" if which == "jm" else "ts"]
    assert t.n == j.n > 20
    np.testing.assert_array_equal(t.anchor_id, j.anchor_id)
    np.testing.assert_array_equal(t.octave, j.octave)
    np.testing.assert_array_equal(t.main_bin, j.main_bin)
    np.testing.assert_array_equal(t.sec_bin, j.sec_bin)
    np.testing.assert_allclose(t.subv_coords, j.subv_coords, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(t.rfinal, j.rfinal, rtol=0, atol=1e-5)
    dj = np.asarray(j.desc)[:j.n]
    same = (t.desc.numpy() == dj).all(axis=1)
    assert same.mean() >= ROWS_EQUAL


def _compare_solutions(tsols, jsols):
    assert len(tsols) == len(jsols) > 0
    for a, b in zip(tsols, jsols):
        assert a.structure.rmsd_ca_with(b.structure) <= POSE_TOL
        assert abs(a.ccc - b.ccc) <= CCC_TOL
        assert a.weight == b.weight


def _recovered(sols, copies):
    return sum(min(s.structure.rmsd_ca_with(c) for s in sols) < 10.0
               for c in copies)


def test_docking_solutions(both):
    _compare_solutions(both["tsols"], both["jsols"])
    n = _recovered(both["tsols"], both["copies"])
    assert n == _recovered(both["jsols"], both["copies"]) == N_COPIES


def test_docking_fed_mad_tpu_descriptors(both):
    """The dock stage alone, fed mad_tpu's own map, descriptor sets and
    decoy through mad_tpu_torch.convert: same solutions."""
    jmap = both["jmap"]
    tmap = grid_from_numpy(np.asarray(jmap.data), jmap.origin, jmap.voxsp,
                           device="cpu")
    tm = descriptor_set_from_numpy(device="cpu", **_fields(both["jm"]))
    ts = descriptor_set_from_numpy(device="cpu", **_fields(both["js"]))
    sols = tdock.dock_structure(tm, ts, both["jmoved"], tmap, RES,
                                both["tcfg"], verbose=False, n_copies=N_COPIES,
                                device="cpu")
    _compare_solutions(sols, both["jsols"])


def test_stage_timings_are_collected(both):
    timings = {}
    tdock.dock_structure(both["tm"], both["ts"], decoy_transform(
        make_assembly(n_copies=N_COPIES, n_res=40, seed=3, spread=14.0)[0]),
        both["tmap"], RES, both["tcfg"], verbose=False,
        n_copies=N_COPIES, device="cpu",
        timings=timings)
    assert {"match", "cluster", "refine", "post", "score"} <= set(timings)
    assert all(v >= 0 for v in timings.values())
