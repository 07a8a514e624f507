"""Port parity: matching (mad_tpu_torch/engine/match.py with kernel K13,
mad_tpu_torch/kernels/repeat.py) and clustering (engine/cluster.py) against
mad_tpu on the same numpy inputs.

Required:
  * similarity pairs equal, except pairs whose cosine lies within 1e-5 of
    the 0.6 threshold, and in the same order up to swaps of cosines within
    1e-6 of each other (float32 dot products summed in another order);
  * approximate and exact repeatabilities equal, except pairs with a moved
    anchor within 1e-4 of a decision boundary (4 A for the exact score, a
    .5 voxel rounding edge for the approximate one).
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
