"""Port parity: the plain versions of K10's head (kernels/pairs.py), K11
(kernels/field.py) and K12 (kernels/approx.py) against mad_tpu's bodies on
the CPU, with numpy inputs made from a seed.

Required:
  * the pair head equals ``_compiled_similarity``'s pairs (cosines, rows,
    columns, in order) exactly. The test feeds it the cosines S as S @ I:
    with an identity map side the product is S itself, on a grid of 1/64
    steps (exact in every precision), so that rows hold more than
    ``row_cap`` survivors, cosines tie exactly and ``max_pairs`` cuts;
  * the field equals ``_compiled_field`` bit for bit, anchors at the
    border included;
  * the approximate repeatabilities equal ``_compiled_approx_repeat``'s,
    except pairs with a moved anchor within 1e-4 voxel of a .5 rounding
    edge (the JAX body sums the pose by an einsum, the port as
    ``rows_times``).
"""

import numpy as np
import pytest
import torch

from mad_tpu.engine import match as jm
from mad_tpu_torch.kernels import approx as k12
from mad_tpu_torch.kernels import field as k11
from mad_tpu_torch.kernels import pairs as k10
from mad_tpu_torch.testing import pose_table

torch.set_num_threads(1)

EDGE = 1e-4


@pytest.mark.parametrize("dh,dl,row_cap,max_pairs,threshold", [
    (20, 300, 16, 150, 0.6),      # > row_cap survivors a row, global cut
    (64, 1000, 128, 65536, 0.6),  # every head kept
    (12, 40, 64, 400, -0.25),     # row_cap > dl, threshold below 0
    (8, 50, 16, 64, 0.99),        # no survivor
])
def test_pair_head_equals_compiled_similarity(dh, dl, row_cap, max_pairs,
                                              threshold):
    rng = np.random.default_rng(dh + dl)
    S = (rng.integers(-32, 64, (dh, dl)) / 64).astype(np.float32)
    S[1] = -0.5                                   # a row with no survivor
    gv, gr, gc, ok = jm._compiled_similarity(dh, dl, row_cap, max_pairs,
                                             threshold)(
        S, np.eye(dl, dtype=np.float32))
    ok = np.asarray(ok)
    want = (np.asarray(gv)[ok], np.asarray(gr)[ok], np.asarray(gc)[ok])
    keys = k10.pair_head(torch.as_tensor(S), row_cap, max_pairs, threshold)
    assert keys.shape == (k10.head_length(dh, dl, row_cap, max_pairs),)
    got = k10.split_pair_keys(keys.numpy(), dl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if threshold < 0.99:
        assert len(want[0]) > 0 and 1 not in set(want[1].tolist())
    else:
        assert len(got[0]) == 0 and (keys == -1).all()


@pytest.mark.parametrize("radius", [3, 2])
def test_field_equals_compiled_field(radius):
    rng = np.random.default_rng(radius)
    shape = (41, 37, 45)
    vox = rng.integers(0, shape, size=(120, 3)).astype(np.int32)
    vox[:5] = [[0, 0, 0], [40, 36, 44], [0, 36, 0], [40, 0, 44],
               [1, 18, 43]]                        # at the border
    valid = np.ones(len(vox), bool)
    want = np.asarray(jm._compiled_field(shape, radius)(vox, valid))
    got = k11.anchor_field(shape, torch.as_tensor(vox), radius)
    assert got.dtype == torch.int8 and k11.launches == 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def _edge(hi_cloud, origin, voxsp, rot, hi, lo):
    y = (np.einsum("pad,ped->pae", hi_cloud[None] - hi[:, None], rot)
         + lo[:, None])
    v = (y - origin) / voxsp
    return (np.abs(v - np.floor(v) - 0.5) < EDGE).any(axis=(1, 2))


def test_approx_repeat_equals_compiled_approx_repeat():
    t = pose_table(512, 12, 5)
    shape, voxsp = (90, 80, 100), 1.4
    origin = np.array([-60.3, -55.1, -70.7], np.float32)
    lo_vox = np.clip(np.round((t["lo_cloud"] - origin) / voxsp), 0,
                     np.asarray(shape) - 1).astype(np.int32)
    field = np.array(jm._compiled_field(shape, 3)(
        lo_vox, np.ones(len(lo_vox), bool)))
    rot = t["rot"]
    hi = t["hi_coord"].astype(np.float32)
    # off the anchor lattice, so that few moved anchors sit on a .5 edge
    lo = (t["lo_coord"] + np.random.default_rng(6).normal(
        size=(512, 3)) * 0.01).astype(np.float32)
    lo[:3] += [[400.0, 0, 0], [0, -300.0, 0], [0, 0, 2.0]]   # off the map
    cloud = t["hi_cloud"].astype(np.float32)
    inv = np.float32(1.0 / voxsp)
    want = np.asarray(jm._compiled_approx_repeat(
        shape, cloud.shape[0], 512, 256)(
            field, cloud, np.ones(cloud.shape[0], bool), origin, inv, rot,
            hi, lo))
    got = k12.approx_repeat(torch.as_tensor(field), torch.as_tensor(lo_vox),
                            3, torch.as_tensor(cloud),
                            torch.as_tensor(origin), float(inv),
                            torch.as_tensor(rot), torch.as_tensor(hi),
                            torch.as_tensor(lo)).numpy()
    keep = ~_edge(cloud.astype(np.float64), origin, voxsp, rot, hi, lo)
    assert keep.sum() > 450 and k12.launches == 0
    np.testing.assert_array_equal(got[keep], want[keep])
    assert got[0] == got[1] == 0 and got.max() > 50


def test_cpu_tensors_take_the_plain_versions():
    k10.launches = k11.launches = k12.launches = 0
    sim = torch.tensor([[0.9, 0.7, 0.1], [0.2, 0.95, 0.95]])
    keys = k10.pair_head(sim, 1, 10, 0.6)
    ccs, rows, cols = k10.split_pair_keys(keys.numpy(), 3)
    np.testing.assert_array_equal(rows, [1, 0])
    np.testing.assert_array_equal(cols, [1, 0])      # the tie: column 1
    np.testing.assert_array_equal(ccs, np.float32([0.95, 0.9]))
    f = k11.anchor_field((4, 4, 4), torch.tensor([[0, 0, 0]]), 1)
    assert int(f.sum()) == 4
    assert k10.launches == k11.launches == k12.launches == 0
