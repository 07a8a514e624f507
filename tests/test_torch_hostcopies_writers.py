"""mad_tpu_torch's host-side copies, second part: the ``filter_pairs``
copy (engine/cluster.py), the geometry port against the JAX versions, the
``convert`` constructors and the writers of core/structure.py and
core/grid.py (byte-identical files). The first part is
tests/test_torch_hostcopies.py; the two are split so that no port test
file holds more than 8 tests (ROADMAP, "Known race").
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mad_tpu.core.config as jconfig
import mad_tpu.core.geometry as jgeo
from mad_tpu.core.grid import write_mrc as jwrite_mrc
from mad_tpu.core.structure import write_pdb
from mad_tpu.core.structure import write_complex as jwrite_complex
from mad_tpu.core.structure import write_pseudo_pdb as jwrite_pseudo_pdb
from mad_tpu.engine.cluster import filter_pairs as jfilter
from mad_tpu.engine.match import MatchTable as JTable
from mad_tpu.testing import make_assembly as jmake_assembly
import mad_tpu_torch.core.config as tconfig
import mad_tpu_torch.core.geometry as tgeo
from mad_tpu_torch.convert import (descriptor_set_from_numpy,
                                   grid_from_numpy, match_table_from_numpy)
from mad_tpu_torch.core import grid as tgrid
from mad_tpu_torch.core import structure as tstructure
from mad_tpu_torch.core.structure import parse_pdb
from mad_tpu_torch.engine.cluster import filter_pairs as tfilter

torch.set_num_threads(1)


def test_filter_pairs_copy_is_the_same():
    rng = np.random.default_rng(2)
    n = 200
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rot = np.stack([jgeo.axis_angle_mat(jnp.asarray(v[1:] / np.linalg.norm(
        v[1:])), 2 * np.arccos(v[0])) for v in q]).astype(np.float64)
    rot[::3] = rot[0]                       # clusters of equal poses
    cloud = rng.normal(size=(40, 3)) * 10
    hi = cloud[rng.integers(0, 40, n)]
    lo = rng.normal(size=(n, 3)) * 30
    lo[::3] = lo[0] + rng.normal(scale=0.5, size=(len(lo[::3]), 3))
    rep = np.sort(rng.uniform(0, 80, n))[::-1]
    fields = dict(cc=rng.uniform(0.6, 1, n), repeat=rep,
                  hi_idx=np.arange(n), lo_idx=np.arange(n), rot=rot,
                  hi_coord=hi, lo_coord=lo, hi_cloud=cloud, lo_cloud=lo)
    bins = np.arange(n) % 7
    cj = jfilter(JTable(**fields), bins, bins, jconfig.FilterConfig(), 120)
    ct = tfilter(match_table_from_numpy(**fields), bins, bins,
                 tconfig.FilterConfig(), 120)
    assert len(cj) == len(ct) > 0
    for a, b in zip(ct, cj):
        assert (a.weight, a.repeat, a.score) == (b.weight, b.repeat, b.score)
        np.testing.assert_array_equal(a.rot, b.rot)
        np.testing.assert_array_equal(np.asarray(a.members),
                                      np.asarray(b.members))


def test_geometry_matches_jax():
    rng = np.random.default_rng(3)
    axis = rng.normal(size=(20, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    axis[0] = [0, 0, -1.0]
    angle = rng.uniform(-3, 3, size=20).astype(np.float32)
    tol = dict(rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        tgeo.axis_angle_mat(torch.tensor(axis), torch.tensor(angle)).numpy(),
        np.asarray(jgeo.axis_angle_mat(jnp.asarray(axis),
                                       jnp.asarray(angle))), **tol)
    np.testing.assert_allclose(
        tgeo.rotation_to_pole(torch.tensor(axis)).numpy(),
        np.asarray(jgeo.rotation_to_pole(jnp.asarray(axis))), **tol)
    np.testing.assert_allclose(
        tgeo.rotation_about_z(torch.tensor(angle)).numpy(),
        np.asarray(jgeo.rotation_about_z(jnp.asarray(angle))), **tol)
    for got, ref in zip(tgeo.spherical_angles(torch.tensor(axis)),
                        jgeo.spherical_angles(jnp.asarray(axis))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    v = np.concatenate([axis * 3, np.zeros((1, 3), np.float32)])
    np.testing.assert_allclose(tgeo.unit(torch.tensor(v)).numpy(),
                               np.asarray(jgeo.unit(jnp.asarray(v))), **tol)
    x = rng.normal(size=(2, 5, 3)).astype(np.float32)
    R = np.asarray(jgeo.rotation_about_z(jnp.asarray([0.3, 1.2])))
    T = rng.normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.apply_rigid(torch.tensor(x), torch.tensor(R),
                         torch.tensor(T)).numpy(),
        np.asarray(jgeo.apply_rigid(jnp.asarray(x), jnp.asarray(R),
                                    jnp.asarray(T))), **tol)


def test_convert_builds_stage_state():
    rng = np.random.default_rng(4)
    g = grid_from_numpy(rng.random((4, 5, 6)), [1, 2, 3], 1.4, name="g",
                        device="cpu")
    assert g.data.dtype == torch.float32 and g.shape == (4, 5, 6)
    assert g.origin.dtype == np.float64 and g.voxsp == 1.4
    n = 5
    desc = rng.integers(0, 9, size=(n + 3, 1024))     # trailing padding rows
    desc[1] = 0
    ds = descriptor_set_from_numpy(
        desc, rng.random((n, 3)), rng.random((n, 3)), rng.random((n, 3)),
        np.tile(np.eye(3), (n, 1, 1)), np.zeros(n), np.arange(n),
        np.arange(n), np.zeros(n), name="d", device="cpu")
    assert ds.n == n and ds.desc.dtype == torch.int16
    norms = ds.desc_norm.norm(dim=1).numpy()
    np.testing.assert_allclose(norms[[0, 2, 3, 4]], 1.0, rtol=1e-6)
    assert norms[1] == 0.0


@pytest.mark.parametrize("writer", ["pdb", "complex", "pseudo", "mrc"])
def test_writers_are_the_same(tmp_path, writer):
    """The port's PDB and MRC writers write mad_tpu's bytes."""
    from mad_tpu.core.grid import DensityGrid
    _sub, copies = jmake_assembly(3, 30, seed=5)
    rng = np.random.default_rng(6)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    if writer == "pdb":
        write_pdb(copies[1], a)
        tstructure.write_pdb(parse_pdb(a), b)
    elif writer == "complex":
        jwrite_complex(copies, a)
        tstructure.write_complex(copies, b)
    elif writer == "pseudo":
        xyz = rng.normal(size=(17, 3)) * 40
        bf = np.arange(17) / 17
        jwrite_pseudo_pdb(xyz, a, res_name="ANC", chain="A", bfactors=bf,
                          elem="C")
        tstructure.write_pseudo_pdb(xyz, b, res_name="ANC", chain="A",
                                    bfactors=bf, elem="C")
    else:
        data = rng.random((9, 7, 5)).astype(np.float32)
        origin = np.array([3.0, -4.2, 10.5])
        jwrite_mrc(DensityGrid(data=data, origin=origin, voxsp=1.4), a)
        tgrid.write_mrc(grid_from_numpy(data, origin, 1.4, device="cpu"), b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        ba, bb = fa.read(), fb.read()
    assert ba == bb and len(ba) > 100
