"""Port parity of K21 (kernels/select_exact.py), K22 and K23
(kernels/crop_pad.py) on the CPU: their plain versions and the port's
functions that call them against mad_tpu's bodies on the same numpy
inputs (JAX on the CPU).

  * K21's plain version against ``_compiled_select_exact(p, pe)``: the
    first n_use rows of ``top`` and of the three gathers bit for bit, with
    ties, NaN, -inf, repeatabilities of 0 and -0.0 (so -rep is -0.0 and
    +0.0), and padding rows (n_rows < p) whose -inf sorts before a NaN;
    and at n_use = P = 40,000 against numpy's stable argsort.
  * K22's plain version against ``_compiled_axis_any``: an empty volume,
    one voxel, NaN (occupied) and -0.0 (not).
  * The port's ``reduce_void`` against mad_tpu's device branch
    (``_compiled_axis_any``, ``_compiled_crop_pad``): data and origin bit
    for bit; an empty volume returns itself.
  * The port's ``prepare`` against ``_compiled_prepare_pad(in_shape, pad,
    real)`` (no bucket padding) at map_padding 0 and 9, bit for bit.
  * The port's ``match_descriptors`` (K12, K21 and K13 with one pull)
    against mad_tpu's on a small table: every pair's repeatability equal
    off the exact score's 4 A edge, the same pair set, in the port's order
    repeatability descending and, within a repeatability, cosines
    descending up to swaps within 1e-6 (ROADMAP's similarity-order
    tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mad_tpu.core.config import MatchConfig as JMatch
from mad_tpu.core.grid import DensityGrid as JGrid
from mad_tpu.core.grid import _compiled_axis_any
from mad_tpu.engine import match as jm
from mad_tpu.engine.pipeline import DescriptorSet as JSet
from mad_tpu.ops.scalespace import _compiled_prepare_pad
from mad_tpu_torch.convert import descriptor_set_from_numpy
from mad_tpu_torch.core.config import MatchConfig as TMatch
from mad_tpu_torch.core.config import ScaleSpaceConfig as TScale
from mad_tpu_torch.core.grid import DensityGrid as TGrid
from mad_tpu_torch.engine import match as tm
from mad_tpu_torch.kernels import crop_pad as k23
from mad_tpu_torch.kernels import select_exact as k21
from mad_tpu_torch.ops.scalespace import prepare

torch.set_num_threads(1)

DIST_EDGE = 1e-4            # A, pairs at the exact score's radius
CC_SWAP = 1e-6              # cosines that may swap between the two sums


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])


def _reps(rng, p):
    """Quantized repeatabilities (many ties) with 0, -0.0, NaN and -inf."""
    rep = (rng.integers(0, 12, p) * 6.25).astype(np.float32)
    rep[rng.random(p) < 0.1] = 0.0
    rep[rng.random(p) < 0.1] = -0.0
    rep[rng.random(p) < 0.03] = np.nan
    rep[rng.random(p) < 0.03] = -np.inf
    return rep


def _poses(rng, p):
    return (rng.normal(size=(p, 3, 3)).astype(np.float32),
            rng.normal(size=(p, 3)).astype(np.float32),
            rng.normal(size=(p, 3)).astype(np.float32))


@pytest.mark.parametrize("case", ["padded", "whole"])
def test_k21_plain_equals_select_exact(case):
    """padded: 700 real rows in a frame of 832 (mad_tpu's padding rows at
    -inf), n_use 448 within the rows above NaN; whole: every row real,
    n_use = p, NaN and -inf rows included."""
    rng = np.random.default_rng(21)
    p, n_rows, n_use = {"padded": (832, 700, 448),
                        "whole": (640, 640, 640)}[case]
    rep = _reps(rng, p)
    rot, hc, lc = _poses(rng, p)
    assert np.count_nonzero(~np.isnan(rep[:n_rows])) > n_use or n_use == p
    got = k21.select_exact(*(torch.as_tensor(a[:n_rows])
                             for a in (rep, rot, hc, lc)), n_use)
    want = jm._compiled_select_exact(p, n_use)(
        jnp.asarray(rep), jnp.asarray(rot), jnp.asarray(hc), jnp.asarray(lc),
        np.int32(n_rows), np.int32(n_use))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()),
                                      _bits(np.asarray(w)[:n_use]))
    np.testing.assert_array_equal(got[0].numpy(), np.argsort(
        -rep[:n_rows], kind="stable")[:n_use])


def test_k21_plain_at_n_use_p_above_shared_memory():
    """40,000 keys (320 KB) are more than one block's shared memory holds:
    every row in numpy's stable order."""
    rng = np.random.default_rng(5)
    p = 40_000
    rep = _reps(rng, p)
    rot, hc, lc = _poses(rng, p)
    top, er, eh, el = k21.select_exact(
        *(torch.as_tensor(a) for a in (rep, rot, hc, lc)), p)
    order = np.argsort(-rep, kind="stable")
    np.testing.assert_array_equal(top.numpy(), order)
    for g, a in ((er, rot), (eh, hc), (el, lc)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(a[order]))


def _volumes():
    rng = np.random.default_rng(22)
    vols = {"empty": np.zeros((5, 6, 7), np.float32)}
    one = np.zeros((9, 4, 11), np.float32)
    one[6, 1, 3] = 0.5
    vols["one voxel"] = one
    v = np.zeros((13, 10, 17), np.float32)
    v[3:9, 2:7, 4:15] = rng.random((6, 5, 11))
    v[1, 8, 16] = np.nan           # occupies x 1, y 8, z 16
    v[11, 0, 0] = -0.0             # occupies nothing
    v[5, 5, 0] = -0.0
    vols["nan and -0.0"] = v
    return vols


def test_k22_plain_equals_axis_any():
    for name, v in _volumes().items():
        got = k23.axis_flags(torch.as_tensor(v)).numpy()
        want = np.concatenate([np.asarray(a) for a in _compiled_axis_any(
            v.shape)(jnp.asarray(v))]).astype(np.uint8)
        np.testing.assert_array_equal(got, want, err_msg=name)
    flags = k23.axis_flags(torch.as_tensor(_volumes()["nan and -0.0"]))
    x, y, z = np.split(flags.numpy(), [13, 23])
    assert x[1] and y[8] and z[16] and not x[11] and not z[0]


def test_reduce_void_equals_mad_tpus_device_branch():
    origin = np.array([-3.5, 10.25, 7.0])
    for name, v in _volumes().items():
        for p in (0, 4):
            data = torch.as_tensor(v)
            got = TGrid(data=data, origin=origin, voxsp=1.5).reduce_void(p)
            want = JGrid(data=jnp.asarray(v), origin=origin,
                         voxsp=1.5).reduce_void(p)
            np.testing.assert_array_equal(_bits(got.data.numpy()),
                                          _bits(np.asarray(want.data)),
                                          err_msg=f"{name}, pad {p}")
            np.testing.assert_array_equal(got.origin, want.origin)
            assert (got.data is data) == (name == "empty")


@pytest.mark.parametrize("pad", [0, 9])
def test_prepare_equals_prepare_pad(pad):
    v = _volumes()["nan and -0.0"]
    v[0, 0, 1] = -2.5
    grid = TGrid(data=torch.as_tensor(v), origin=np.array([1.0, 2.0, 3.0]),
                 voxsp=2.0)
    data, origin = prepare(grid, TScale(map_padding=pad))
    real = tuple(s + 2 * pad for s in v.shape)
    want = _compiled_prepare_pad(v.shape, pad, real)(jnp.asarray(v))
    np.testing.assert_array_equal(_bits(data.numpy()),
                                  _bits(np.asarray(want)))
    np.testing.assert_array_equal(origin, grid.origin - pad * grid.voxsp)


def _sets(rng, n, name):
    """The same descriptor table as a mad_tpu and a port DescriptorSet,
    anchors on a 0.25 A lattice (so clouds deduplicate)."""
    dens = rng.uniform(0.5, 1.0, size=(n, 1))
    desc = (rng.integers(0, 40, size=(n, 1024))
            * (rng.random((n, 1024)) < dens)).astype(np.int16)
    coords = np.round((rng.normal(size=(n, 3)) * 10 + 50) * 4) / 4
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rfinal = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        -1).reshape(n, 3, 3).astype(np.float32)
    fields = dict(desc=desc, coords=coords.astype(np.float32),
                  map_coords=coords, subv_coords=coords, rfinal=rfinal,
                  octave=np.zeros(n, np.int32),
                  anchor_id=np.arange(n, dtype=np.int32),
                  main_bin=np.arange(n, dtype=np.int32) % 112,
                  sec_bin=np.zeros(n, np.int32))
    norm = desc.astype(np.float32)
    norm /= np.linalg.norm(norm, axis=1, keepdims=True)
    return (JSet(desc_norm=norm, name=name, **fields),
            descriptor_set_from_numpy(name=name, device="cpu", **fields))


def test_match_descriptors_equals_mad_tpus():
    rng = np.random.default_rng(16)
    jmap, tmap = _sets(rng, 80, "map")
    jsub, tsub = _sets(rng, 60, "sub")
    shape, origin, voxsp = (56, 52, 54), np.array([4.1, 6.07, 5.03]), 2.0
    # 64 pairs scored exactly at exact_top 64, and with min_exact 200 a
    # prefix of 256 rows
    for exact_top, min_exact in ((64, 0), (64, 200)):
        jt = jm.match_descriptors(jmap, jsub, shape, origin, voxsp,
                                  JMatch(exact_top=exact_top),
                                  min_exact=min_exact)
        tt = tm.match_descriptors(tmap, tsub, shape, origin, voxsp,
                                  TMatch(exact_top=exact_top),
                                  min_exact=min_exact, device="cpu")
        assert tt.n == jt.n > 300
        d = np.linalg.norm(
            (np.einsum("pad,ped->pae", jt.hi_cloud[None]
                       - jt.hi_coord[:, None], jt.rot)
             + jt.lo_coord[:, None])[:, :, None] - jt.lo_cloud[None, None],
            axis=-1).min(axis=-1)
        edge = (np.abs(d - 4.0) < DIST_EDGE).any(axis=1)
        rj = {(int(h), int(l)): r for h, l, r in
              zip(jt.hi_idx, jt.lo_idx, jt.repeat)}
        rt = {(int(h), int(l)): r for h, l, r in
              zip(tt.hi_idx, tt.lo_idx, tt.repeat)}
        assert rt.keys() == rj.keys()
        keys = [(int(h), int(l)) for h, l, e in
                zip(jt.hi_idx, jt.lo_idx, edge) if not e]
        assert len(keys) > 0.95 * jt.n
        np.testing.assert_array_equal([rt[k] for k in keys],
                                      [rj[k] for k in keys])
        assert (np.diff(tt.repeat) <= 0).all()
        same = np.diff(tt.repeat) == 0
        assert (np.diff(tt.cc)[same] <= CC_SWAP).all()
        np.testing.assert_array_equal(tt.hi_cloud, jt.hi_cloud)
        np.testing.assert_array_equal(tt.lo_cloud, jt.lo_cloud)
