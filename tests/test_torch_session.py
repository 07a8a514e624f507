"""Port parity: the ``MaD`` session (mad_tpu_torch/api.py) against
mad_tpu/api.py on the self-fit dimer of tests/test_api_e2e.py
(make_assembly(2, 60, seed 4, spread 16), 8 A at 2 A, decoy transform),
each session in its own workdir, the port on the CPU.

Required:
  * the same number of refined solutions; each of the port's within
    0.5 A CA-RMSD of mad_tpu's at the same rank (the two describe and
    refine in other float orders, and mad_tpu docks through its fused
    programs); Solutions_refined_*.csv weights equal, repeatability within
    0.5 (percent of anchors: one anchor of the ~200 may flip at the
    1.5-voxel hit radius) and mCC within 1e-3;
  * the same model components from build_assembly, homomultimer and
    heteromer;
  * a second run() in the same workdir loads both caches (dsc_db and
    pose_db) and gives the same solutions;
  * the caches' file names (``.h5``, h5py being installed) and the
    checkpoint digest are mad_tpu's, letter for letter;
  * with save_pre_solutions, the same pre_solutions/ files and
    Solutions_filtered_*.csv IDs and weights.
"""

import contextlib
import csv
import io
import os

import numpy as np
import pytest
import torch

from mad_tpu import cache as jcache
from mad_tpu.api import MaD as JMaD
from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.core.grid import write_mrc as jwrite_mrc
from mad_tpu.core.structure import parse_pdb as jparse_pdb
from mad_tpu.core.structure import write_pdb as jwrite_pdb
from mad_tpu.ops.simulate import simulate_density as jsimulate
from mad_tpu.testing import make_assembly
from mad_tpu_torch import cache as tcache
from mad_tpu_torch.api import MaD as TMaD
from mad_tpu_torch.convert import grid_from_numpy
from mad_tpu_torch.core.structure import parse_pdb
from mad_tpu_torch.engine.assemble import enumerate_homomultimer

torch.set_num_threads(1)

POSE_TOL, REPEAT_TOL, MCC_TOL = 0.5, 0.5, 1e-3
KEY = "subunit"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    _sub, copies = make_assembly(n_copies=2, n_res=60, seed=4, spread=16.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    map_path = str(root / "dimer_map.mrc")
    jwrite_mrc(jsimulate(coords, 8.0, 2.0, masses=masses), map_path)
    sub_path = str(root / f"{KEY}.pdb")
    jwrite_pdb(copies[0], sub_path)
    return map_path, sub_path, copies


def _session(mad, map_path, sub_path):
    mad.save_pre_solutions = True
    mad.add_map(map_path, resolution=8.0)
    mad.add_subunit(sub_path, n_copies=2)
    mad.run(transform_subunits=True)
    mad.build_assembly()
    return mad


def _rows(mad):
    with open(os.path.join(mad.out_folder,
                           f"Solutions_refined_{KEY}.csv")) as fh:
        return list(csv.DictReader(fh))


def _models(mad):
    with open(os.path.join(mad.out_folder, "complex_ranking.csv")) as fh:
        return [r["Composition"] for r in csv.DictReader(
            line for line in fh if not line.startswith("# "))]


@pytest.fixture(scope="module")
def sessions(inputs, tmp_path_factory):
    map_path, sub_path, _copies = inputs
    jmad = _session(JMaD(workdir=str(tmp_path_factory.mktemp("jax")),
                         config=JConfig(warm_start=False)),
                    map_path, sub_path)
    twork = str(tmp_path_factory.mktemp("torch"))
    tmad = _session(TMaD(workdir=twork, device="cpu"), map_path, sub_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        again = _session(TMaD(workdir=twork, device="cpu"), map_path,
                         sub_path)
    return jmad, tmad, again, out.getvalue()


def test_solutions_and_csv_match(sessions, inputs):
    jmad, tmad, _again, _log = sessions
    js, ts = jmad.solutions[KEY], tmad.solutions[KEY]
    assert len(ts) == len(js) >= 2
    for a, b in zip(ts, js):
        assert a.structure.rmsd_ca_with(b.structure) <= POSE_TOL
    for c in inputs[2]:
        assert min(s.structure.rmsd_ca_with(c) for s in ts) < 4.0
    jr, tr = _rows(jmad), _rows(tmad)
    assert [r["ID"] for r in tr] == [r["ID"] for r in jr]
    for a, b in zip(tr, jr):
        assert a["Weight"] == b["Weight"]
        assert abs(float(a["Repeatability"])
                   - float(b["Repeatability"])) <= REPEAT_TOL
        assert abs(float(a["mCC"]) - float(b["mCC"])) <= MCC_TOL
    sols = sorted(os.listdir(os.path.join(tmad.out_folder,
                                          "individual_solutions")))
    assert sols == sorted(os.listdir(os.path.join(
        jmad.out_folder, "individual_solutions")))
    for f in [f for f in sols if f.startswith("sol_")]:
        a = parse_pdb(os.path.join(tmad.out_folder, "individual_solutions",
                                   f))
        b = jparse_pdb(os.path.join(jmad.out_folder, "individual_solutions",
                                    f))
        assert a.info == b.info and a.rmsd_ca_with(b) <= POSE_TOL
    # the pre-refinement artifacts (save_pre_solutions): the same files
    # and Solutions_filtered_*.csv rows
    pre = [sorted(os.listdir(os.path.join(m.out_folder, "pre_solutions")))
           for m in (tmad, jmad)]
    assert pre[0] == pre[1] and pre[0]
    filt = []
    for m in (tmad, jmad):
        with open(os.path.join(m.out_folder,
                               f"Solutions_filtered_{KEY}.csv")) as fh:
            filt.append(list(csv.DictReader(fh)))
    assert [(r["ID"], r["Weight"]) for r in filt[0]] == \
        [(r["ID"], r["Weight"]) for r in filt[1]]


def test_same_models(sessions):
    jmad, tmad, _again, _log = sessions
    assert _models(tmad) == _models(jmad) and _models(tmad)
    for mad in (jmad, tmad):
        m1 = parse_pdb(os.path.join(mad.out_folder, "assembly_models",
                                    "Model_1.pdb"))
        assert {row[3] for row in m1.info} == {"A", "B"}


def test_heteromer_models(sessions):
    """Two components built from the docked solutions (the subcomplex +
    cartesian-product path, mad/MaD.py:216-222, 748-843)."""
    got = []
    for mad in sessions[:2]:
        files = mad.buildable_subunits[KEY][1]
        mad.buildable_subunits = {"subA": [1, [files[0], files[1]]],
                                  "subB": [1, list(files)]}
        mad.build_assembly()
        assert any(f.startswith("SubComplexsubA") for f in os.listdir(
            os.path.join(mad.out_folder, "subcomplexes")))
        got.append(_models(mad))
    assert got[0] == got[1] and got[0]


def test_second_run_uses_both_caches(sessions):
    _jmad, tmad, again, log = sessions
    assert "found in database" in log and "found in pose checkpoint" in log
    assert "Processing map" not in log and "Matching descriptors" not in log
    a, b = again.solutions[KEY], tmad.solutions[KEY]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.structure.coords, y.structure.coords)
        assert (x.repeat, x.weight, x.ccc) == (y.repeat, y.weight, y.ccc)
    np.testing.assert_array_equal(again.map_dsc.desc.numpy(),
                                  tmad.map_dsc.desc.numpy())


def test_cache_names_and_digest_are_mad_tpus(sessions):
    jmad, tmad, _again, _log = sessions
    for mod, mad in ((jcache, jmad), (tcache, tmad)):
        db = os.path.join(mad.workdir, "dsc_db")
        assert sorted(os.listdir(db)) == sorted(
            os.path.basename(mod.cache_filename(
                db, n, 8.0, 0.0, 2.0, 1.0, 16, 112, 16, 64))
            for n in ("dimer_map", KEY))
        assert all(f.endswith(".h5") for f in os.listdir(db))
    assert (sorted(os.listdir(os.path.join(jmad.workdir, "dsc_db")))
            == sorted(os.listdir(os.path.join(tmad.workdir, "dsc_db"))))
    sub = jparse_pdb(jmad.processed_subunits[KEY][0])
    jh = jcache.dock_state_hash(sub.coords, 2, 8.0, 0.0, jmad.config)
    th = tcache.dock_state_hash(sub.coords, 2, 8.0, 0.0, tmad.config)
    assert jh == th
    jp = sorted(os.listdir(os.path.join(jmad.workdir, "pose_db")))
    tp = sorted(os.listdir(os.path.join(tmad.workdir, "pose_db")))
    assert jp == tp and jh in tp[0] and tp[0].endswith(".h5")


@pytest.mark.parametrize("call", ["session", "grid", "enumerate"])
def test_entry_points_default_to_the_card(call, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without a card")
    fn = {"session": lambda: TMaD(workdir=str(tmp_path)),
          "grid": lambda: grid_from_numpy(np.zeros((4, 4, 4)), [0, 0, 0],
                                          1.0),
          "enumerate": lambda: enumerate_homomultimer(
              3, 2, np.zeros((3, 3)))}[call]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn()
