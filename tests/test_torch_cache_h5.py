"""The session caches (mad_tpu_torch/cache.py) as mad_tpu's HDF5 files.

  * With h5py installed, a ``dsc_db`` file written by
    ``mad_tpu.cache.save_descriptors`` is read by the port bit for bit, and
    one written by the port is read by mad_tpu bit for bit, under the same
    file name; the port's file holds mad_tpu's datasets with their types
    (``dsc`` int16 of exactly n rows, ``info`` uint16, ``coords`` and
    ``rot`` float64).
  * The same for the ``pose_db`` checkpoint (``save_solutions`` /
    ``load_solutions``), an empty solution list included.
  * Where h5py does not import (made unimportable here), the port names
    its files ``.npz`` and reads back what it wrote.
  * A damaged ``.h5`` file raises; nothing falls back to ``.npz``.
"""

import os
import sys

import h5py
import numpy as np
import pytest

from mad_tpu import cache as jcache
from mad_tpu.core.structure import Structure as JStructure
from mad_tpu.engine.docking import Solution as JSolution
from mad_tpu.engine.pipeline import DescriptorSet as JSet
from mad_tpu_torch import cache as tcache
from mad_tpu_torch.convert import descriptor_set_from_numpy
from mad_tpu_torch.engine.docking import Solution as TSolution
from mad_tpu_torch.testing import make_protein

KEY = ("dimer_map", 8.0, 0.0, 2.0, 1.0, 16, 112, 16, 64)
SET_FIELDS = ("coords", "map_coords", "subv_coords", "rfinal", "octave",
              "anchor_id", "main_bin", "sec_bin")


def _fields(n=37, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return dict(
        desc=rng.integers(0, 300, size=(n, 1024)).astype(np.int16),
        coords=rng.normal(size=(n, 3)).astype(np.float32) * 40,
        map_coords=rng.normal(size=(n, 3)) * 40,
        subv_coords=rng.normal(size=(n, 3)) * 40, rfinal=q,
        octave=rng.integers(0, 2, n).astype(np.int32),
        anchor_id=np.arange(n, dtype=np.int32),
        main_bin=rng.integers(0, 112, n).astype(np.int32),
        sec_bin=rng.integers(0, 16, n).astype(np.int32))


def _same_set(a, b, desc_a, desc_b):
    np.testing.assert_array_equal(desc_a, desc_b)
    for f in SET_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                      err_msg=f)
    assert (a.eqsp_size, a.subeqsp_size, a.name) == (
        b.eqsp_size, b.subeqsp_size, b.name)


def test_port_reads_mad_tpus_dsc_db(tmp_path):
    f = _fields()
    norm = f["desc"].astype(np.float32)
    norm /= np.linalg.norm(norm, axis=1, keepdims=True)
    path = jcache.cache_filename(str(tmp_path), *KEY)
    assert tcache.cache_filename(str(tmp_path), *KEY) == path
    jcache.save_descriptors(JSet(desc_norm=norm, name="m", **f), path)
    got = tcache.load_descriptors(path, device="cpu")
    want = jcache.load_descriptors(path)
    _same_set(got, want, got.desc.numpy(), want.desc)
    # the unit rows are not stored: each package normalizes on load, numpy
    # and K8 summing the squares in other orders
    np.testing.assert_allclose(got.desc_norm.numpy(), want.desc_norm,
                               rtol=1e-6, atol=0)


def test_mad_tpu_reads_the_ports_dsc_db(tmp_path):
    ds = descriptor_set_from_numpy(name="m", device="cpu", **_fields(seed=1))
    path = tcache.cache_filename(str(tmp_path), *KEY)
    assert path.endswith(".h5")
    tcache.save_descriptors(ds, path)
    want = jcache.load_descriptors(path)
    again = tcache.load_descriptors(path, device="cpu")
    _same_set(want, again, want.desc, again.desc.numpy())
    np.testing.assert_array_equal(want.desc, ds.desc.numpy())
    with h5py.File(path, "r") as hf:
        assert sorted(hf) == ["coords", "dsc", "info", "rot"]
        assert [hf[k].dtype for k in ("dsc", "info", "coords", "rot")] == [
            np.int16, np.uint16, np.float64, np.float64]
        assert hf["dsc"].shape == (ds.n, 1024)


def _solutions(struct, n, seed):
    rng = np.random.default_rng(seed)
    return [dict(structure=struct.with_coords(struct.coords
                                              + rng.normal(size=(1, 3))),
                 corresp_anchors=rng.normal(size=(k + 1, 3)),
                 repeat=float(rng.random() * 100), weight=int(k + 2),
                 ccc=float(rng.random()), score=float(rng.random() * 50),
                 members=[rng.normal(size=8) for _ in range(k + 1)])
            for k in range(n)]


def _same_solutions(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.structure.coords, y.structure.coords)
        np.testing.assert_array_equal(x.corresp_anchors, y.corresp_anchors)
        assert (x.repeat, x.weight, x.ccc, x.score) == (
            y.repeat, y.weight, y.ccc, y.score)
        np.testing.assert_array_equal(np.asarray(x.members),
                                      np.asarray(y.members))


@pytest.mark.parametrize("n", [3, 0])
def test_pose_db_both_ways(tmp_path, n):
    struct = make_protein(n_res=20, seed=2)
    jstruct = JStructure(**{k: getattr(struct, k) for k in
                            struct.__dataclass_fields__})
    name = jcache.solutions_filename(str(tmp_path), "map", "sub",
                                     "0123456789ab")
    assert tcache.solutions_filename(str(tmp_path), "map", "sub",
                                     "0123456789ab") == name
    sols = _solutions(struct, n, seed=3)
    jcache.save_solutions([JSolution(**s) for s in sols], name)
    _same_solutions(tcache.load_solutions(name, struct),
                    jcache.load_solutions(name, jstruct))
    os.remove(name)
    tcache.save_solutions([TSolution(**s) for s in sols], name)
    _same_solutions(jcache.load_solutions(name, jstruct),
                    tcache.load_solutions(name, struct))
    with h5py.File(name, "r") as hf:
        assert int(hf.attrs["n"]) == n


def test_npz_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py as _  # noqa: F401
    path = tcache.cache_filename(str(tmp_path), *KEY)
    assert path == jcache.cache_filename(str(tmp_path), *KEY)[:-3] + ".npz"
    ds = descriptor_set_from_numpy(name="m", device="cpu", **_fields(seed=4))
    tcache.save_descriptors(ds, path)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    again = tcache.load_descriptors(path, "m", device="cpu")
    _same_set(ds, again, ds.desc.numpy(), again.desc.numpy())
    struct = make_protein(n_res=20, seed=2)
    name = tcache.solutions_filename(str(tmp_path), "map", "sub", "abc")
    assert name.endswith(".npz")
    sols = [TSolution(**s) for s in _solutions(struct, 2, seed=5)]
    tcache.save_solutions(sols, name)
    _same_solutions(tcache.load_solutions(name, struct), sols)


def test_damaged_h5_raises(tmp_path):
    path = tcache.cache_filename(str(tmp_path), *KEY)
    with open(path, "wb") as fh:
        fh.write(b"not an HDF5 file")
    with pytest.raises(OSError):
        tcache.load_descriptors(path, device="cpu")
