"""The port's map files and grid-space scores against mad_tpu's, on the
cases of tests/test_grid.py and tests/test_misc_components.py:50-66
(disjoint boxes included): files written by either package byte for byte
and read back bit for bit, scores equal to the last bit (the same float64
numpy in both), masks on the grid's own device.
"""

import numpy as np
import pytest
import torch

from mad_tpu.core import grid as jg
from mad_tpu_torch.core import grid as tg

torch.set_num_threads(1)


def _pair(data, origin=(0, 0, 0), voxsp=2.0):
    data = np.asarray(data, np.float32)
    origin = np.asarray(origin, float)
    return (tg.DensityGrid(torch.as_tensor(data), origin.copy(), voxsp),
            jg.DensityGrid(data=data, origin=origin.copy(), voxsp=voxsp))


@pytest.mark.parametrize("ext", [".mrc", ".sit"])
def test_files_round_trip(tmp_path, ext):
    rng = np.random.default_rng(0)
    for shape, origin, voxsp in (((6, 5, 4), (10.0, -4.0, 2.0), 1.5),
                                 ((4, 3, 5), (2.0, 4.0, 6.0), 2.0),
                                 ((13, 7, 9), (-3.5, 0.0, 7.25), 1.2)):
        t, j = _pair(rng.random(shape), origin, voxsp)
        write = {".mrc": (tg.write_mrc, jg.write_mrc),
                 ".sit": (tg.write_sit, jg.write_sit)}[ext]
        pt, pj = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
        write[0](t, pt)
        write[1](j, pj)
        assert open(pt, "rb").read() == open(pj, "rb").read()
        for norm in (False, True):
            a = tg.read_map(pt, normalize=norm, device="cpu")
            b = jg.read_map(pj, normalize=norm)
            np.testing.assert_array_equal(a.host(), np.asarray(b.host()))
            np.testing.assert_array_equal(a.origin, b.origin)
            assert a.voxsp == b.voxsp and a.shape == shape
        # mad_tpu's round-trip gates (tests/test_grid.py)
        back = tg.read_map(pt, normalize=False, device="cpu")
        np.testing.assert_allclose(back.host(), t.host(),
                                   atol=1e-6 if ext == ".mrc" else 1e-5)


def test_ccc_and_overlap_cases():
    rng = np.random.default_rng(2)
    d = rng.random((8, 8, 8)).astype(np.float32)
    box = np.zeros((10, 10, 10), np.float32)
    box[4:6, 4:6, 4:6] = 1.0
    half = np.zeros((10, 10, 10), np.float32)
    half[:5] = 1.0
    full = np.ones((10, 10, 10), np.float32)
    cases = [(d, (0, 0, 0), d, (0, 0, 0), 1.0),
             (box, (0, 0, 0), box, (4.0, 0, 0), 2.0),
             (box, (0, 0, 0), box, (0.0, 0, 0), 2.0),
             (d, (0, 0, 0), box, (3.0, -2.0, 1.0), 1.0),
             (half, (0, 0, 0), full, (0, 0, 0), 1.0),
             (full, (0, 0, 0), half, (0, 0, 0), 1.0),
             (d, (0, 0, 0), d, (100.0, 0, 0), 1.0)]      # disjoint
    for a, oa, b, ob, v in cases:
        for iso in (0.0, 0.3):
            assert tg.ccc_grids(torch.as_tensor(a), oa, b, ob, v,
                                isovalue=iso) == \
                jg.ccc_grids(a, oa, b, ob, v, isovalue=iso)
        assert tg.overlap_fraction(a, oa, torch.as_tensor(b), ob, v) == \
            jg.overlap_fraction(a, oa, b, ob, v)
    assert tg.overlap_boxes((0, 0, 0), (4, 4, 4), (100, 0, 0), (4, 4, 4),
                            1.0) is None
    assert tg.ccc_grids(d, (0, 0, 0), d, (0, 0, 0), 1.0) == \
        pytest.approx(1.0)
    assert tg.overlap_fraction(full, (0, 0, 0), half, (0, 0, 0), 1.0) == \
        pytest.approx(0.5)


def test_grid_methods():
    rng = np.random.default_rng(3)
    t1, j1 = _pair(np.ones((6, 6, 6)), voxsp=1.0)
    mdat = np.zeros((6, 6, 6), np.float32)
    mdat[2:4] = 1.0
    tm, jm = _pair(mdat, voxsp=1.0)
    got = t1.mask_with(tm)
    assert got.device == t1.device and got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.host(), np.asarray(j1.mask_with(jm)
                                                         .data))
    assert float(got.data.sum()) == mdat.sum()
    far, jfar = _pair(mdat, origin=(50.0, 0, 0), voxsp=1.0)
    assert float(t1.mask_with(far).data.abs().sum()) == 0.0
    np.testing.assert_array_equal(t1.mask_with(far).host(),
                                  j1.mask_with(jfar).data)
    with pytest.raises(ValueError):
        t1.mask_with(_pair(mdat, voxsp=2.0)[0])
    a, ja = _pair(rng.random((9, 8, 7)), (1.0, 2.0, 3.0), 1.5)
    b, jb = _pair(rng.random((6, 9, 5)), (4.0, 0.5, 6.0), 1.5)
    for x, y in ((a.overlap_box_with(b), ja.overlap_box_with(jb)),
                 (a.overlap_box_with(far), ja.overlap_box_with(jfar))):
        assert (x is None) == (y is None)
        if x is not None:
            for u, w in zip(x, y):
                np.testing.assert_array_equal(u, w)
    assert a.ccc_with(b) == ja.ccc_with(jb)
    assert a.ccc_with(b, isovalue=0.5) == ja.ccc_with(jb, isovalue=0.5)
    c = a.copy()
    c.data[0, 0, 0] = -1.0
    c.origin[0] = 99.0
    assert float(a.data[0, 0, 0]) != -1.0 and a.origin[0] == 1.0


def test_ccc_maps_scaled_cases():
    rng = np.random.default_rng(0)
    d = rng.random((8, 8, 8)).astype(np.float32)
    t, j = _pair(d, voxsp=1.0)
    assert tg.ccc_maps_scaled(t, t) == pytest.approx(1.0, abs=1e-5)
    sparse = d * (d > 0.6)
    for other, origin in ((d, (0, 0, 0)), (sparse, (2.0, -1.0, 0.0)),
                          (sparse, (40.0, 0, 0))):
        t2, j2 = _pair(other, origin, 1.0)
        for iso in (0.0, 0.4):
            assert tg.ccc_maps_scaled(t, t2, iso) == \
                jg.ccc_maps_scaled(j, j2, iso)
    with pytest.raises(ValueError):
        tg.ccc_maps_scaled(t, _pair(d, voxsp=2.0)[0])
