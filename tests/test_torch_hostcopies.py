"""mad_tpu_torch's host-side copies equal their mad_tpu originals, the
geometry and grid ports agree with the JAX versions, and the port imports
neither JAX nor mad_tpu.

The copies (core/config.py, core/eqsp.py, core/structure.py,
core/mrc_io.py, testing.py, engine/cluster.py, the writers of
core/grid.py) are numpy code carried over without their JAX imports (and,
for core/structure.py, without the native parser), so they are held to
exact equality. The filter_pairs copy, the geometry port, the convert
constructors and the writers (byte-identical files) are held in
tests/test_torch_hostcopies_writers.py: no port test file holds more than
8 tests (ROADMAP, "Known race").
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mad_tpu.core.config as jconfig
from mad_tpu.api import _decoy_transform
from mad_tpu.core.eqsp import get_eqsp as jget_eqsp
from mad_tpu.core.grid import read_map as jread_map
from mad_tpu.core.grid import write_mrc as jwrite_mrc
from mad_tpu.core.structure import _parse_pdb_python, write_pdb
from mad_tpu.testing import make_assembly as jmake_assembly
from mad_tpu.testing import make_protein as jmake_protein
import mad_tpu_torch.core.config as tconfig
from mad_tpu_torch import testing as ttesting
from mad_tpu_torch.core.eqsp import get_eqsp as tget_eqsp
from mad_tpu_torch.core.grid import read_map
from mad_tpu_torch.core.structure import parse_pdb

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_mad_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mad_tpu_torch\n"
        "for m in pkgutil.walk_packages(mad_tpu_torch.__path__,\n"
        "                               'mad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'mad_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules\n"
        "           if k.startswith('mad_tpu_torch.')]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_config_defaults_are_the_same():
    assert dataclasses.asdict(tconfig.MadConfig()) == \
        dataclasses.asdict(jconfig.MadConfig())
    kw = dict(detect_sigma=1.5, dsc_subregions=27, n_samples=30)
    assert dataclasses.asdict(tconfig.MadConfig.from_run_kwargs(**kw)) == \
        dataclasses.asdict(jconfig.MadConfig.from_run_kwargs(**kw))
    assert tconfig.bucket(130, 32) == jconfig.bucket(130, 32) == 160


@pytest.mark.parametrize("size", [16, 112, 30])
def test_eqsp_is_the_same(size):
    a, b = tget_eqsp(size), jget_eqsp(size)
    for attr in ("bounds", "p_centers", "c_centers", "belt_of_zone",
                 "belt_first_theta"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    for x, y in zip(a.zone_lookup_tables(), b.zone_lookup_tables()):
        np.testing.assert_array_equal(x, y)
    v = np.random.default_rng(size).normal(size=(200, 3))
    np.testing.assert_array_equal(a.zone_of_vectors(v), b.zone_of_vectors(v))


def test_synthetic_systems_are_the_same():
    p, q = ttesting.make_protein(50, seed=4), jmake_protein(50, seed=4)
    np.testing.assert_array_equal(p.coords, q.coords)
    np.testing.assert_array_equal(p.masses, q.masses)
    np.testing.assert_array_equal(p.ca_idx, q.ca_idx)
    assert p.info == q.info
    (s1, c1), (s2, c2) = (ttesting.make_assembly(4, 40, seed=1, shell=True),
                          jmake_assembly(4, 40, seed=1, shell=True))
    np.testing.assert_array_equal(s1.coords, s2.coords)
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(ttesting.decoy_transform(s1).coords,
                                  _decoy_transform(s2).coords)


def test_pdb_parser_is_the_same(tmp_path):
    path = str(tmp_path / "p.pdb")
    write_pdb(jmake_protein(30, seed=2), path)
    a, b = parse_pdb(path), _parse_pdb_python(path)
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.masses, b.masses)
    np.testing.assert_array_equal(a.ca_idx, b.ca_idx)
    np.testing.assert_array_equal(a.bb_idx, b.bb_idx)
    assert a.info == b.info
    assert a.rmsd_ca_with(a.with_coords(a.coords + 1.0)) == pytest.approx(
        np.sqrt(3.0))


def test_mrc_reader_is_the_same(tmp_path):
    from mad_tpu.core.grid import DensityGrid
    rng = np.random.default_rng(0)
    g = DensityGrid(data=rng.random((12, 9, 7)).astype(np.float32),
                    origin=np.array([3.0, -4.2, 10.5]), voxsp=1.4)
    path = str(tmp_path / "m.mrc")
    jwrite_mrc(g, path)
    a = read_map(path, isovalue=0.2, device="cpu")
    b = jread_map(path, isovalue=0.2)
    np.testing.assert_array_equal(a.origin, b.origin)
    assert a.voxsp == b.voxsp and a.name == b.name
    np.testing.assert_array_equal(a.host(), np.asarray(b.data))
