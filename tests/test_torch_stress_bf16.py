"""The bfloat16 gradient field (octaves above ``BF16_VOXELS``, mad_tpu's
scale-stress path) through the port against mad_tpu, with both gates
forced to 1 as tests/test_lazy_octaves.py forces mad_tpu's: the
descriptors of a small map, a small fit's recovered copies, and the two
large documented workloads' runners (``testing.run_stress``,
``run_ensemble_bench``) at a reduced size on the CPU.

Required: describe_grid's coords bit for bit and its rows within K7's
tolerance (1 % of rows may differ, by an L1 of at most 8); the fit
recovers the same copies as mad_tpu; the runners print mad_tpu's lines
and meet its pass conditions (the stress: every copy recovered at this
size, its octaves' fields bfloat16; the ensemble: conf_0 first by
RWmCC).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from mad_tpu.api import _decoy_transform
from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.engine import docking as jdock
from mad_tpu.engine import pipeline as jpipe
from mad_tpu.ops import simulate as jsim
from mad_tpu.ops.scalespace import LazyOctave
from mad_tpu.testing import make_assembly as jmake_assembly
from mad_tpu_torch import testing as T
from mad_tpu_torch.convert import grid_from_numpy
from mad_tpu_torch.core.config import MadConfig as TConfig
from mad_tpu_torch.engine import docking as tdock
from mad_tpu_torch.engine import pipeline as tpipe
from mad_tpu_torch.ops import scalespace

torch.set_num_threads(1)

ROWS_EQUAL, ROW_L1 = 0.99, 8          # K7's tolerance (ROADMAP Queue 3)
RES, VOXSP = 8.0, 2.0
FIT = dict(n_copies=3, n_res=40, seed=1, spread=16.0)


@pytest.fixture
def bf16_gates(monkeypatch):
    """Both packages store every octave's gradient field as bfloat16.
    mad_tpu's describe_grid runs an octave of at most FUSE_OCTAVE_VOXELS
    (250 M, the bfloat16 gate's value) as one fused program whose field
    is float32 whatever the gate (mad_tpu/engine/pipeline.py:197, 338), so
    its split path, where the gate applies, is forced too."""
    monkeypatch.setattr(LazyOctave, "BF16_VOXELS", 1)
    monkeypatch.setattr(jpipe, "FUSE_OCTAVE_VOXELS", 0)
    monkeypatch.setattr(scalespace, "BF16_VOXELS", 1)


def _cfgs(rescue_rounds=0):
    out = []
    for C in (JConfig, TConfig):
        c = C()
        out.append(c.replace(
            detect=dataclasses.replace(c.detect, max_anchors=1024),
            filter=dataclasses.replace(c.filter,
                                       rescue_rounds=rescue_rounds)))
    return out


def _jmap(n_copies, n_res, seed, spread):
    sub, copies = jmake_assembly(n_copies=n_copies, n_res=n_res, seed=seed,
                                 spread=spread, shell=True)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    jmap = jsim.simulate_density(coords, RES, VOXSP, masses=masses
                                 ).reduce_void()
    tmap = grid_from_numpy(np.asarray(jmap.data), jmap.origin, jmap.voxsp,
                           device="cpu")
    return sub, copies, jmap, tmap


@pytest.fixture
def field_dtypes(monkeypatch):
    """The gradient field dtype of every octave the port describes."""
    seen, fn = [], tpipe.octave_lanes

    def spy(octv, *a, **k):
        lanes = fn(octv, *a, **k)
        seen.append(lanes.grad.dtype)
        return lanes

    monkeypatch.setattr(tpipe, "octave_lanes", spy)
    return seen


def test_describe_grid_bf16_field(bf16_gates, field_dtypes):
    jcfg, tcfg = _cfgs()
    _sub, _copies, jmap, tmap = _jmap(2, 40, 3, 14.0)
    j = jpipe.describe_grid(jmap, jcfg, name="map")
    t = tpipe.describe_grid(tmap, tcfg, name="map", device="cpu")
    assert field_dtypes == [torch.bfloat16] * 2
    assert t.n == j.n > 20
    assert t.coords.tobytes() == np.asarray(j.coords)[:j.n].tobytes()
    np.testing.assert_array_equal(t.anchor_id, j.anchor_id)
    np.testing.assert_array_equal(t.main_bin, j.main_bin)
    np.testing.assert_array_equal(t.sec_bin, j.sec_bin)
    dj = np.asarray(j.desc)[:j.n].astype(np.int64)
    dt = t.desc.numpy().astype(np.int64)
    l1 = np.abs(dt - dj).sum(axis=1)
    assert (l1 == 0).mean() >= ROWS_EQUAL
    assert l1.max() <= ROW_L1


def _recovered(sols, copies):
    return [bool(min((s.structure.rmsd_ca_with(c) for s in sols),
                     default=np.inf) < 10.0) for c in copies]


def test_small_fit_recovers_mad_tpus_copies(bf16_gates, field_dtypes):
    jcfg, tcfg = _cfgs(rescue_rounds=1)
    sub, copies, jmap, tmap = _jmap(**FIT)
    moved = _decoy_transform(sub)
    jm = jpipe.describe_grid(jmap, jcfg, name="map")
    js = jpipe.describe_structure(moved, RES, VOXSP, jcfg, name="sub")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAD_TPU_FUSED_DOCK", "0")
        jsols = jdock.dock_structure(jm, js, moved, jmap, RES, jcfg,
                                     n_copies=FIT["n_copies"], verbose=False)
    tmoved = T.decoy_transform(T.make_assembly(**FIT, shell=True)[0])
    assert tmoved.coords.tobytes() == moved.coords.tobytes()
    tm = tpipe.describe_grid(tmap, tcfg, name="map", device="cpu")
    ts = tpipe.describe_structure(tmoved, RES, VOXSP, tcfg, name="sub",
                                  device="cpu")
    tsols = tdock.dock_structure(tm, ts, tmoved, tmap, RES, tcfg,
                                 verbose=False, n_copies=FIT["n_copies"],
                                 device="cpu")
    assert set(field_dtypes) == {torch.bfloat16}
    assert _recovered(tsols, copies) == _recovered(jsols, copies) \
        == [True] * FIT["n_copies"]


def test_run_stress_reduced(bf16_gates):
    lines = []
    r = T.run_stress(**FIT, resolution=RES, voxsp=VOXSP, passes=1,
                     device="cpu", log=lines.append)
    assert re.fullmatch(r"stress> map \(\d+, \d+, \d+\) \(\d+ M vox\) built"
                        r" in [\d.]+s; octaves .*", lines[0])
    assert [d for _s, d in r["fields"]] == [torch.bfloat16] * 2
    assert re.fullmatch(r"stress> pass 0: [\d.]+s, \d+ solutions, \d+ "
                        r"models, 3/3 recovered, median best CA-RMSD "
                        r"[\d.]+ A", lines[1])
    p, = r["passes"]
    assert p["recovered"] == FIT["n_copies"] and p["models"]
    assert p["peak"] is None                     # no device memory on a CPU
    assert all(np.isfinite(s.structure.coords).all() and np.isfinite(s.ccc)
               for s in p["sols"])


def test_run_ensemble_bench_reduced(tmp_path):
    lines = []
    r = T.run_ensemble_bench(str(tmp_path), n_copies=3, n_res=60,
                             spread=20.0, seed=3, resolution=RES,
                             voxsp=VOXSP, scales=(5.0, 12.0), device="cpu",
                             log=lines.append)
    assert lines[0].startswith("ens-bench> system built in")
    assert re.search(r"ladder: 0\.00, [\d.]+, [\d.]+ A$", lines[0])
    assert re.fullmatch(r"ens-bench> run [\d.]+s, score_ensembles [\d.]+s",
                        lines[1])
    assert [ln.split()[3].rstrip(":") for ln in lines[2:6]] == list(
        T.ENSEMBLE_SCORES)
    assert [r[0] for r in r["rows"]] == ["conf_0", "conf_1", "conf_2"]
    assert r["ok"] and r["top"]["RWmCC"] == "conf_0"
    assert lines[6].startswith("ens-bench> true conformer first by MaD "
                               "score: True")
