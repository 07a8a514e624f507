"""The matching cache (``dock_structure(match_cache=)``,
mad_tpu_torch/cache.py) against mad_tpu's, on the two-copy dimer of
tests/test_torch_slice.py.

  * ``matching_filename`` is mad_tpu's key string over a grid of settings;
  * the port's round trip (the case of tests/test_misc_components.py's
    ``test_matching_cache_roundtrip``);
  * a table mad_tpu wrote is read by the port bit for bit, and one the port
    wrote by mad_tpu, with mad_tpu's datasets;
  * with h5py unimportable the port writes and reads ``.npz``;
  * ``dock_structure(match_cache=)``: a miss writes the table that
    ``match_descriptors`` returned; a hit gives the miss's solutions bit
    for bit without matching again;
  * mad_tpu, docking from the port's file, gives the solutions it gives
    without the cache, within the slice test's gates.
"""

import dataclasses
import itertools
import os
import sys

import h5py
import numpy as np
import pytest
import torch

from mad_tpu import cache as jcache
from mad_tpu.api import _decoy_transform
from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.engine import docking as jdock
from mad_tpu.engine import pipeline as jpipe
from mad_tpu.engine.match import MatchTable as JTable
from mad_tpu.engine.match import match_descriptors as jmatch
from mad_tpu.ops import simulate as jsim
from mad_tpu.testing import make_assembly as jmake_assembly
from mad_tpu_torch import cache as tcache
from mad_tpu_torch.core.config import MadConfig as TConfig
from mad_tpu_torch.engine import docking as tdock
from mad_tpu_torch.engine import match as tmatch
from mad_tpu_torch.engine import pipeline as tpipe
from mad_tpu_torch.engine.match import MatchTable as TTable
from mad_tpu_torch.ops import simulate as tsim
from mad_tpu_torch.testing import decoy_transform, make_assembly

torch.set_num_threads(1)

POSE_TOL = 0.5          # tests/test_torch_slice.py's gates
CCC_TOL = 1e-4
RES, VOXSP, N_COPIES = 8.0, 2.0, 2
TABLE_FIELDS = ("cc", "repeat", "hi_idx", "lo_idx", "rot", "hi_coord",
                "lo_coord", "hi_cloud", "lo_cloud")
DATASETS = {"cc", "repeat", "hi_idx", "lo_idx", "rot", "hi_coord",
            "lo_coord", "map_anchors", "comp_anchors"}


def _cfg(C):
    c = C()
    return c.replace(
        detect=dataclasses.replace(c.detect, max_anchors=1024),
        filter=dataclasses.replace(c.filter, rescue_rounds=1))


@pytest.fixture(scope="module")
def dimer():
    """Both packages' map, descriptor sets and decoy of the dimer, and each
    package's match table of them."""
    jcfg, tcfg = _cfg(JConfig), _cfg(TConfig)
    sub, copies = jmake_assembly(n_copies=N_COPIES, n_res=40, seed=3,
                                 spread=14.0)
    jmap = jsim.simulate_density(
        np.concatenate([c.coords for c in copies]), RES, VOXSP,
        masses=np.concatenate([c.masses for c in copies])).reduce_void()
    jmoved = _decoy_transform(sub)
    jm = jpipe.describe_grid(jmap, jcfg, name="map")
    js = jpipe.describe_structure(jmoved, RES, VOXSP, jcfg, name="sub")
    tsub, tcopies = make_assembly(n_copies=N_COPIES, n_res=40, seed=3,
                                  spread=14.0)
    tmap = tsim.simulate_density(
        np.concatenate([c.coords for c in tcopies]), RES, VOXSP,
        device="cpu", masses=np.concatenate([c.masses for c in tcopies])
    ).reduce_void()
    tmoved = decoy_transform(tsub)
    tm = tpipe.describe_grid(tmap, tcfg, name="map", device="cpu")
    ts = tpipe.describe_structure(tmoved, RES, VOXSP, tcfg, name="sub",
                                  device="cpu")
    n_samples = tcfg.filter.n_samples * N_COPIES
    jtable = jmatch(jm, js, jmap.shape, jmap.origin, jmap.voxsp, jcfg.match,
                    min_exact=n_samples)
    ttable = tmatch.match_descriptors(tm, ts, tmap.shape, tmap.origin,
                                      tmap.voxsp, tcfg.match,
                                      min_exact=n_samples, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jmap=jmap, jm=jm, js=js,
                jmoved=jmoved, tmap=tmap, tm=tm, ts=ts, tmoved=tmoved,
                jtable=jtable, ttable=ttable)


def _same_table(a, b):
    for f in TABLE_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                      err_msg=f)


def _same_solutions(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.structure.coords, y.structure.coords)
        assert (x.repeat, x.weight, x.ccc, x.score) == (
            y.repeat, y.weight, y.ccc, y.score)
        np.testing.assert_array_equal(x.corresp_anchors, y.corresp_anchors)


def _close_solutions(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.structure.rmsd_ca_with(y.structure) <= POSE_TOL
        assert abs(x.ccc - y.ccc) <= CCC_TOL
        assert x.weight == y.weight


def test_matching_filename_is_mad_tpus(tmp_path):
    grid = itertools.product(("sub", "conf_3", "a.b"), (0.0, 0.5, 0.745,
                                                       0.8, 1.0),
                             (0, 3, 12), (1, 20, 600))
    for key, cc, w, n in grid:
        assert tcache.matching_filename(str(tmp_path), key, cc, w, n) == \
            jcache.matching_filename(str(tmp_path), key, cc, w, n)


def test_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    t = TTable(
        cc=rng.random(5), repeat=rng.random(5) * 100,
        hi_idx=np.arange(5), lo_idx=np.arange(5)[::-1].copy(),
        rot=np.broadcast_to(np.eye(3), (5, 3, 3)).copy(),
        hi_coord=rng.random((5, 3)), lo_coord=rng.random((5, 3)),
        hi_cloud=rng.random((7, 3)), lo_cloud=rng.random((9, 3)))
    path = str(tmp_path / "m.h5")
    tcache.save_matching(t, path)
    _same_table(tcache.load_matching(path), t)


def test_each_package_reads_the_others_table(dimer, tmp_path):
    """mad_tpu's table of the dimer read by the port, and the port's read
    by mad_tpu, bit for bit, with mad_tpu's datasets."""
    jpath = str(tmp_path / "j.h5")
    jcache.save_matching(dimer["jtable"], jpath)
    got = tcache.load_matching(jpath)
    assert isinstance(got, TTable) and got.n > 100
    _same_table(got, jcache.load_matching(jpath))
    tpath = str(tmp_path / "t.h5")
    tcache.save_matching(dimer["ttable"], tpath)
    with h5py.File(tpath, "r") as hf:
        assert set(hf) == DATASETS
    back = jcache.load_matching(tpath)
    assert isinstance(back, JTable)
    _same_table(back, dimer["ttable"])
    # the two packages' tables of the dimer: the same pairs
    j, t = dimer["jtable"], dimer["ttable"]
    assert t.n == j.n
    assert set(zip(t.hi_idx, t.lo_idx)) == set(zip(j.hi_idx, j.lo_idx))


def test_npz_without_h5py(dimer, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py as _  # noqa: F401
    path = tcache.matching_filename(str(tmp_path), "sub", 0.75, 3, 20)
    assert path == jcache.matching_filename(
        str(tmp_path), "sub", 0.75, 3, 20)[:-3] + ".npz"
    tcache.save_matching(dimer["ttable"], path)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    with np.load(path) as f:
        assert set(f.files) == DATASETS
    _same_table(tcache.load_matching(path), dimer["ttable"])


def test_dock_miss_writes_hit_skips_matching(dimer, tmp_path, monkeypatch,
                                             capsys):
    d = dimer
    path = tcache.matching_filename(str(tmp_path), "sub",
                                    d["tcfg"].match.cc_threshold,
                                    d["tcfg"].filter.weight_threshold, 20)
    args = (d["tm"], d["ts"], d["tmoved"], d["tmap"], RES, d["tcfg"],
            N_COPIES)
    seen = []
    real = tdock.match_descriptors

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tdock, "match_descriptors", spy)
    miss = tdock.dock_structure(*args, False, path, device="cpu")
    assert seen == [1] and os.path.exists(path)
    _same_table(tcache.load_matching(path), d["ttable"])

    def refuse(*a, **k):
        raise AssertionError("matched again on a cache hit")

    monkeypatch.setattr(tdock, "match_descriptors", refuse)
    capsys.readouterr()
    hit = tdock.dock_structure(*args, True, path, device="cpu")
    assert (f"MaD> Loaded matched descriptor pairs from {path}"
            in capsys.readouterr().out)
    _same_solutions(hit, miss)
    # an empty table: a hit returns no solution
    tcache.save_matching(d["ttable"].take(np.zeros(0, int)), path)
    assert tdock.dock_structure(*args, False, path, device="cpu") == []


def test_mad_tpu_docks_from_the_ports_table(dimer, tmp_path, monkeypatch):
    """mad_tpu's dock (its split path, as tests/test_torch_slice.py runs
    it) from the port's file gives the solutions it gives without the
    cache, within the slice test's gates; so does the port's dock from
    mad_tpu's file against the port's own."""
    d = dimer
    monkeypatch.setenv("MAD_TPU_FUSED_DOCK", "0")
    jargs = (d["jm"], d["js"], d["jmoved"], d["jmap"], RES, d["jcfg"],
             N_COPIES, False)
    ref = jdock.dock_structure(*jargs)
    tpath = str(tmp_path / "port.h5")
    tcache.save_matching(d["ttable"], tpath)
    _close_solutions(jdock.dock_structure(*jargs, match_cache=tpath), ref)
    jpath = str(tmp_path / "mad_tpu.h5")
    jcache.save_matching(d["jtable"], jpath)
    targs = (d["tm"], d["ts"], d["tmoved"], d["tmap"], RES, d["tcfg"],
             N_COPIES, False)
    _close_solutions(tdock.dock_structure(*targs, jpath, device="cpu"),
                     tdock.dock_structure(*targs, device="cpu"))
