"""Port parity: matching (mad_tpu_torch/engine/match.py with kernel K13,
mad_tpu_torch/kernels/repeat.py) and clustering (engine/cluster.py) against
mad_tpu on the same numpy inputs.

Required:
  * similarity pairs equal, except pairs whose cosine lies within 1e-5 of
    the 0.6 threshold, and in the same order up to swaps of cosines within
    1e-6 of each other (float32 dot products summed in another order);
  * approximate and exact repeatabilities equal, except pairs with a moved
    anchor within 1e-4 of a decision boundary (4 A for the exact score, a
    .5 voxel rounding edge for the approximate one);
  * the pose data of ``match_pairs`` (anchor clouds worked out once a
    distinct row, relative rotations on the device) bit for bit the
    per-pair formula it replaces and mad_tpu's, on one device and on CPU
    shards; the host sort and unique helpers bit for bit numpy's.
"""

import numpy as np
import pytest
import torch

from mad_tpu.core.config import MatchConfig as JMatch
from mad_tpu.engine import match as jm
from mad_tpu.engine.cluster import filter_pairs as jfilter
from mad_tpu.engine.pipeline import DescriptorSet as JSet
from mad_tpu_torch.convert import (descriptor_set_from_numpy,
                                   match_table_from_numpy)
from mad_tpu_torch.core.config import MatchConfig as TMatch
from mad_tpu_torch.engine import match as tm
from mad_tpu_torch.kernels import repeat as k13
from mad_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

CC_EDGE = 1e-5
DIST_EDGE = 1e-4


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        -1).reshape(n, 3, 3).astype(np.float32)


def _sets(rng, n, name):
    """The same descriptor table as a mad_tpu and a port DescriptorSet.
    Anchor coordinates sit on a 0.25 A lattice, so clouds deduplicate."""
    # per-row sample densities spread the cosines around the threshold
    dens = rng.uniform(0.5, 1.0, size=(n, 1))
    desc = (rng.integers(0, 40, size=(n, 1024))
            * (rng.random((n, 1024)) < dens)).astype(np.int16)
    coords = np.round((rng.normal(size=(n, 3)) * 12 + 60) * 4) / 4
    rfinal = _rotations(rng, n)
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


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(0)
    jmap, tmap = _sets(rng, 90, "map")
    jsub, tsub = _sets(rng, 70, "sub")
    return jmap, tmap, jsub, tsub


def _cc_key(p):
    return list(zip(p["rows"].tolist(), p["cols"].tolist()))


@pytest.mark.parametrize("row_cap,max_pairs", [(128, 65536), (5, 120)])
def test_similarity_pairs(sets, row_cap, max_pairs):
    jmap, tmap, jsub, tsub = sets
    jc = JMatch(row_cap=row_cap, max_pairs=max_pairs)
    tc = TMatch(row_cap=row_cap, max_pairs=max_pairs)
    pj = jm.match_pairs(jmap, jsub, jc)
    pt = tm.match_pairs(tmap, tsub, tc)
    edge_j = np.abs(pj["ccs"] - 0.6) < CC_EDGE
    edge_t = np.abs(pt["ccs"] - 0.6) < CC_EDGE
    kj = [k for k, e in zip(_cc_key(pj), edge_j) if not e]
    kt = [k for k, e in zip(_cc_key(pt), edge_t) if not e]
    assert set(kt) == set(kj) and len(kj) > 100
    cc_j = dict(zip(_cc_key(pj), pj["ccs"].tolist()))
    in_port_order = np.asarray([cc_j[k] for k in kt])
    assert (np.diff(in_port_order) <= 1e-6).all()
    cc_t = dict(zip(_cc_key(pt), pt["ccs"].tolist()))
    np.testing.assert_allclose([cc_t[k] for k in kj], [cc_j[k] for k in kj],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pt["hi_cloud"], pj["hi_cloud"])
    np.testing.assert_array_equal(pt["lo_cloud"], pj["lo_cloud"])
    rot_t = dict(zip(_cc_key(pt), pt["rot"]))
    rot_j = dict(zip(_cc_key(pj), pj["rot"]))
    np.testing.assert_allclose([rot_t[k] for k in kj], [rot_j[k] for k in kj],
                               rtol=0, atol=1e-6)


def _moved(table):
    """(P, A_hi, 3) float64 moved subunit clouds of a table's pairs."""
    x = table.hi_cloud[None] - table.hi_coord[:, None]
    return np.einsum("pad,ped->pae", x, table.rot) + table.lo_coord[:, None]


def _exact_edge(table):
    d = np.linalg.norm(_moved(table)[:, :, None] - table.lo_cloud[None, None],
                       axis=-1).min(axis=-1)
    return (np.abs(d - 4.0) < DIST_EDGE).any(axis=1)


def _approx_edge(table, origin, voxsp):
    v = (_moved(table) - origin) / voxsp
    frac = v - np.floor(v)
    return (np.abs(frac - 0.5) < DIST_EDGE).any(axis=(1, 2))


def _by_pair(table):
    return {(int(h), int(l)): r
            for h, l, r in zip(table.hi_idx, table.lo_idx, table.repeat)}


@pytest.mark.parametrize("exact_top", [0, 4096])
def test_match_repeatabilities(sets, exact_top):
    jmap, tmap, jsub, tsub = sets
    # origin off the 0.25 A anchor lattice: no anchor rounds from .5 exactly
    shape, origin, voxsp = (64, 60, 62), np.array([4.1, 6.07, 5.03]), 2.0
    jt = jm.match_descriptors(jmap, jsub, shape, origin, voxsp,
                              JMatch(exact_top=exact_top))
    tt = tm.match_descriptors(tmap, tsub, shape, origin, voxsp,
                              TMatch(exact_top=exact_top), device="cpu")
    assert tt.n == jt.n > 100
    edge = (_exact_edge(jt) if exact_top else
            _approx_edge(jt, origin, voxsp))
    rj, rt = _by_pair(jt), _by_pair(tt)
    keys = [(int(h), int(l)) for h, l, e in zip(jt.hi_idx, jt.lo_idx, edge)
            if not e]
    assert len(keys) > 0.9 * jt.n
    np.testing.assert_array_equal([rt[k] for k in keys],
                                  [rj[k] for k in keys])
    assert max(rj.values()) > 0


def test_exact_rescore(sets):
    jmap, _tmap, jsub, _tsub = sets
    jt = jm.match_descriptors(jmap, jsub, (64, 60, 62), (4.0, 6.0, 5.0), 2.0,
                              JMatch(exact_top=0))
    tt = match_table_from_numpy(jt.cc, jt.repeat, jt.hi_idx, jt.lo_idx,
                                jt.rot, jt.hi_coord, jt.lo_coord,
                                jt.hi_cloud, jt.lo_cloud)
    rows = np.asarray([0, 3, 17, jt.n - 1, 5, 50, 77])
    got = tm.exact_rescore(tt, rows, 4.0, "cpu")
    want = jm.exact_rescore(jt, rows, 4.0)
    keep = ~_exact_edge(jt.take(rows))
    np.testing.assert_array_equal(got[keep], want[keep])


def test_filter_pairs_on_a_port_table(sets):
    """The clustering copy, run on the port's table, equals the original
    run on mad_tpu's table."""
    jmap, tmap, jsub, tsub = sets
    jt = jm.match_descriptors(jmap, jsub, (64, 60, 62), (4.0, 6.0, 5.0), 2.0,
                              JMatch())
    tt = tm.match_descriptors(tmap, tsub, (64, 60, 62), (4.0, 6.0, 5.0), 2.0,
                              TMatch(), device="cpu")
    from mad_tpu.core.config import FilterConfig as JF
    from mad_tpu_torch.core.config import FilterConfig as TF
    from mad_tpu_torch.engine.cluster import filter_pairs as tfilter
    cj = jfilter(jt, jsub.main_bin[jt.hi_idx], jmap.main_bin[jt.lo_idx],
                 JF(weight_threshold=1), 60)
    ct = tfilter(tt, tsub.main_bin[tt.hi_idx], tmap.main_bin[tt.lo_idx],
                 TF(weight_threshold=1), 60)
    assert [(c.weight, c.repeat) for c in ct] == \
        [(c.weight, c.repeat) for c in cj]


def test_cpu_tensor_takes_the_plain_version(sets):
    k13.launches = 0
    jmap, _t, jsub, _s = sets
    hc = torch.tensor(jsub.subv_coords[:20], dtype=torch.float32)
    lc = torch.tensor(jmap.subv_coords[:30], dtype=torch.float32)
    rot = torch.tensor(_rotations(np.random.default_rng(1), 4))
    out = k13.exact_repeat(hc, lc, rot, hc[:4], lc[:4], 4.0)
    assert out.shape == (4,) and k13.launches == 0
    # pair k moves hi_k onto lo_k: that anchor is always a hit
    assert (out >= 100.0 / 20).all()


GROUP_DIMS = 28        # a group's block of descriptor columns (36 in 1,024)


def _group_sets(rng, sub_groups, map_groups, sub_coords, map_coords):
    """A mad_tpu and a port DescriptorSet each (map, subunit) whose
    descriptors live on their group's block of columns: a pair's cosine is
    above 0.95 within a group and 0 across groups, so the pairs are the
    same-group pairs (at most 128 map rows a group), far from any edge.
    The first rows' frames are signed permutations, whose products give
    exact zeros of both signs."""

    def mkset(groups, coords, name):
        n = len(groups)
        desc = np.zeros((n, 1024), np.int16)
        for i, g in enumerate(groups):
            block = slice(g * GROUP_DIMS, (g + 1) * GROUP_DIMS)
            desc[i, block] = (rng.integers(20, 40, GROUP_DIMS)
                              + rng.integers(0, 3, GROUP_DIMS))
        rfinal = _rotations(rng, n)
        k = min(n, 8)
        rfinal[:k] = np.eye(3, dtype=np.float32)[rng.permutation(3)] * \
            rng.choice([-1.0, 1.0], size=(k, 3, 1)).astype(np.float32)
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

    jmap, tmap = mkset(map_groups, map_coords, "map")
    jsub, tsub = mkset(sub_groups, sub_coords, "sub")
    return jmap, tmap, jsub, tsub


def _lattice(rng, n, step=1.0):
    return np.round((rng.normal(size=(n, 3)) * 12 + 60) / step) * step


def _pose_case(case):
    """The sets of one case of test_pose_data_per_distinct_row."""
    rng = np.random.default_rng(11)
    if case in ("bench", "mesh"):
        # the bench fit's table: 366 x 4,588 rows, every subunit row with
        # 127-128 pairs; anchors on a 1 A lattice, and rows 0-5 on one
        sub, mp = _lattice(rng, 366), _lattice(rng, 4588)
        sub[1:6], mp[1:6] = sub[0], mp[0]
        return _group_sets(rng, np.arange(366) % 36, np.arange(4588) % 36,
                           sub, mp)
    if case == "single_pair":
        return _group_sets(rng, [0, 1, 2, 3], [3, 4, 5, 6, 7, 8],
                           _lattice(rng, 4), _lattice(rng, 6))
    if case == "one_subunit_row":
        return _group_sets(rng, np.arange(30), [0] * 100 + [30] * 100,
                           _lattice(rng, 30), _lattice(rng, 200))
    if case == "equal_coords":
        # 60 and 400 rows on 5 and 7 distinct anchors
        return _group_sets(rng, np.arange(60) % 12, np.arange(400) % 12,
                           _lattice(rng, 5)[np.arange(60) % 5],
                           _lattice(rng, 7)[np.arange(400) % 7])
    # case "nan_signed_zero": rows whose anchor has a NaN, and rows equal
    # but for the sign of a zero, each taken by several pairs
    sub, mp = _lattice(rng, 60), _lattice(rng, 400)
    for c in (sub, mp):
        c[0:3] = (np.nan, 5.0, 5.0)
        c[3], c[4] = (0.0, 5.0, 5.0), (-0.0, 5.0, 5.0)
        c[5:7] = (7.0, -0.0, 1.0)
    return _group_sets(rng, np.arange(60) % 12, np.arange(400) % 12, sub, mp)


POSE_CASES = ["bench", "single_pair", "one_subunit_row", "equal_coords",
              "nan_signed_zero", "mesh"]


@pytest.mark.parametrize("case", POSE_CASES)
def test_pose_data_per_distinct_row(case):
    """``match_pairs``' hi_cloud and lo_cloud, worked out once a distinct
    row, and rot, worked out on the device, are bit for bit the per-pair
    formula (np.unique over the pairs' anchors, np.einsum of the pairs'
    frames) and mad_tpu's."""
    jmap, tmap, jsub, tsub = _pose_case(case)
    mesh = make_mesh(3, devices=["cpu"] * 3) if case == "mesh" else None
    got = tm.match_pairs(tmap, tsub, TMatch(), mesh)
    got["rot"] = got["rot"].cpu().numpy()     # worked out on the device
    rows, cols = got["rows"], got["cols"]
    want = dict(
        hi_cloud=np.unique(tsub.subv_coords[rows], axis=0),
        lo_cloud=np.unique(tmap.subv_coords[cols], axis=0),
        rot=np.einsum("pji,pjk->pik", tmap.rfinal[cols], tsub.rfinal[rows]))
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    for k, s, i in (("hi_xyz", tsub, rows), ("lo_xyz", tmap, cols)):
        assert got[k].cpu().numpy().tobytes() == np.ascontiguousarray(
            s.subv_coords[i], np.float32).tobytes(), k
    sizes = {"bench": 46648, "mesh": 46648, "single_pair": 1,
             "one_subunit_row": 100}
    assert len(rows) == sizes.get(case, len(rows)) > 0
    if case in ("one_subunit_row", "single_pair"):
        assert len(np.unique(rows)) == 1

    ref = jm.match_pairs(jmap, jsub, JMatch())
    key = lambda d: d["rows"].astype(np.int64) * 1_000_000 + d["cols"]
    og, orf = np.argsort(key(got)), np.argsort(key(ref))
    np.testing.assert_array_equal(key(got)[og], key(ref)[orf])
    for k in ("hi_cloud", "lo_cloud"):
        assert got[k].tobytes() == ref[k].tobytes(), k
    assert got["rot"][og].tobytes() == ref["rot"][orf].tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_unique_rows_and_descending_order_are_numpys(seed):
    """``_unique_rows`` is ``np.unique(axis=0)`` and ``_descending`` is
    ``np.argsort(-rep, kind="stable")``, byte for byte, on rows with
    repeats and near repeats, and on scores with ties, both zeros and
    both signs; a NaN score takes the stable argsort itself."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 7, 3000):
        rows = rng.integers(-20, 20, (n, 3)) * 0.6
        rows[rng.random((n, 3)) < 0.05] += 1e-9
        rows[rows == 0] = 0.0
        want = np.unique(rows, axis=0)
        got = tm._unique_rows(rows)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()

        rep = (rng.integers(0, 40, n) * rng.choice([-1, 1], n)).astype(
            np.float32) * np.float32(0.37)
        rep[rng.random(n) < 0.1] = -0.0
        rep[rng.random(n) < 0.1] = rng.normal()
        np.testing.assert_array_equal(tm._descending(rep),
                                      np.argsort(-rep, kind="stable"))
        if n > 1:
            rep[n // 2] = np.nan
            np.testing.assert_array_equal(tm._descending(rep),
                                          np.argsort(-rep, kind="stable"))
