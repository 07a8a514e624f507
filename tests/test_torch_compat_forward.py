"""The port's compat records, functional API and one-octave forward pass
against mad_tpu's.

compat: records, their text and the anchor dump (``.npy`` and ``.pdb``)
byte for byte with mad_tpu's on the same DescriptorSet fields.
functional: ``get_repeatability`` equal; setup -> get_descriptors ->
match_and_dock on the CPU recovers both copies of a small dimer.
forward: on ``__graft_entry__.entry()``'s protein the valid rows equal
mad_tpu's ``build_forward`` rows within K7's standing tolerance (ROADMAP
Queue 3: at most 1 % of rows differ, each by an L1 of at most 8), with the
same anchor voxels and frames within 1e-6.
"""

import numpy as np
import pytest
import torch

from mad_tpu import compat as jcompat
from mad_tpu import functional as jfunc
from mad_tpu.engine.pipeline import DescriptorSet as JSet
from mad_tpu_torch import compat as tcompat
from mad_tpu_torch import functional as tfunc
from mad_tpu_torch.core.config import MadConfig
from mad_tpu_torch.core.grid import write_mrc
from mad_tpu_torch.core.structure import write_pdb
from mad_tpu_torch.engine.forward import build_forward
from mad_tpu_torch.engine.pipeline import DescriptorSet as TSet
from mad_tpu_torch.testing import decoy_transform, make_assembly

torch.set_num_threads(1)

ROW_L1 = 8            # K7's standing tolerance
ROW_SHARE = 0.01
FRAME_TOL = 1e-6


def _sets(n, seed, subv=None):
    rng = np.random.default_rng(seed)
    f = dict(coords=rng.random((n, 3)).astype(np.float32),
             map_coords=rng.random((n, 3)) * 10,
             subv_coords=(rng.random((n, 3)) * 10 if subv is None
                          else np.asarray(subv, float)),
             rfinal=np.broadcast_to(np.eye(3, dtype=np.float32),
                                    (n, 3, 3)).copy(),
             octave=rng.integers(0, 2, n).astype(np.int32),
             anchor_id=np.arange(n, dtype=np.int32),
             main_bin=rng.integers(0, 112, n).astype(np.int32),
             sec_bin=rng.integers(0, 4, n).astype(np.int32))
    desc = rng.integers(0, 30, (n, 1024)).astype(np.int16)
    norm = (desc / np.linalg.norm(desc, axis=1, keepdims=True)).astype(
        np.float32)
    t = TSet(desc=torch.as_tensor(desc), desc_norm=torch.as_tensor(norm),
             **f)
    j = JSet(desc=desc, desc_norm=norm, **f)
    return t, j


def test_records_and_their_text():
    t, j = _sets(5, 0)
    a, b = tcompat.to_records(t), jcompat.to_records(j)
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        for k in ("index", "oct_scale", "main_bin", "sec_bin", "eqsp_size",
                  "subeqsp_size"):
            assert getattr(x, k) == getattr(y, k)
        for k in ("coords", "map_coords", "subv_map_coords", "rfinal",
                  "lin_ar_subeqsp"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
        assert x.show() == y.show()
        assert x.show_suboccupancy() == y.show_suboccupancy()


def test_anchor_dump_round_trip(tmp_path):
    t, j = _sets(6, 3)
    for regular in (False, True):
        tcompat.write_anchors(t, str(tmp_path / "t"), save_regular=regular)
        jcompat.write_anchors(j, str(tmp_path / "j"), save_regular=regular)
        for ext in ("_data.npy", ".pdb"):
            assert (tmp_path / f"t{ext}").read_bytes() == \
                (tmp_path / f"j{ext}").read_bytes()
        rec = tcompat.load_anchors(str(tmp_path / "t_data.npy"))
        ref = jcompat.load_anchors(str(tmp_path / "j_data.npy"))
        np.testing.assert_array_equal(rec, ref)
        np.testing.assert_array_equal(rec["subv_map_coords"], t.subv_coords)
        lines = (tmp_path / "t.pdb").read_text().splitlines()
        assert len(lines) == (2 if regular else 1) * t.n


def test_get_repeatability():
    a = _sets(3, 1, [[0, 0, 0], [10, 0, 0], [20, 0, 0]])
    b = _sets(3, 2, [[1, 0, 0], [10.5, 0, 0], [100, 0, 0]])
    got = tfunc.get_repeatability(a[0], b[0], radii=(0.6, 2.0, 90.0))
    assert got == jfunc.get_repeatability(a[1], b[1],
                                          radii=(0.6, 2.0, 90.0))
    assert got[2.0] == pytest.approx(100.0 * 2 / 3)
    empty = _sets(0, 4)
    assert tfunc.get_repeatability(empty[0], a[0]) == {2.0: 0.0, 4.0: 0.0,
                                                       6.0: 0.0}


def test_functional_chain_on_the_cpu(tmp_path):
    sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    from mad_tpu_torch.ops.simulate import simulate_density
    path = str(tmp_path / "dimer.mrc")
    write_mrc(simulate_density(coords, 8.0, 2.0, masses=masses,
                               device="cpu"), path)
    moved = decoy_transform(sub)
    pdb = str(tmp_path / "sub.pdb")
    write_pdb(moved, pdb)
    dmap, cfg = tfunc.setup(path, 8.0, device="cpu")
    assert dmap.device == torch.device("cpu") and isinstance(cfg,
                                                             MadConfig)
    map_set = tfunc.get_descriptors(dmap, 8.0, dmap.voxsp, cfg, name="map")
    sub_set = tfunc.get_descriptors(pdb, 8.0, dmap.voxsp, cfg, name="sub",
                                    device="cpu")
    sols = tfunc.match_and_dock(map_set, sub_set, moved, dmap, 8.0, cfg,
                                n_copies=2, device="cpu")
    table = tfunc.benchmark_solutions(sols, copies)
    np.testing.assert_array_equal(table,
                                  jfunc.benchmark_solutions(sols, copies))
    assert table.shape == (len(sols), 2)
    assert (table.min(axis=0) < 5.0).all(), table


def test_forward_matches_build_forward():
    import __graft_entry__
    jfn, (jgrid,) = __graft_entry__.entry()
    jdesc, jvalid, jcoords, jrf = (np.asarray(a) for a in jfn(jgrid))
    grid = torch.as_tensor(np.array(jgrid))
    fn = build_forward(tuple(grid.shape), MadConfig(), max_anchors=128,
                       max_desc=512)
    desc, valid, coords, rfinal = fn(grid)
    assert desc.shape[0] == valid.shape[0] == coords.shape[0] <= 512
    v = valid.numpy()
    got, ref = desc.numpy()[v].astype(int), jdesc[jvalid].astype(int)
    assert got.shape == ref.shape and got.shape[0] > 0
    np.testing.assert_array_equal(coords.numpy()[v], jcoords[jvalid])
    assert np.abs(rfinal.numpy()[v] - jrf[jvalid]).max() <= FRAME_TOL
    l1 = np.abs(got - ref).sum(axis=1)
    assert (l1 > 0).mean() <= ROW_SHARE and l1.max() <= ROW_L1, l1.max()
    # mad_tpu's lanes past the valid ones are padding
    assert not jvalid[len(v):].any()
