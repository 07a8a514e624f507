"""Port parity: K14's plain version (kernels/cluster.py, through
engine/docking.cluster_candidates on CPU tensors) against mad_tpu's
``engine.cluster.filter_pairs`` (float64, the split path) and
``engine.dock_fused._cluster_select_body`` (float32, jit on the CPU), on
the same match tables.

Required, in every case: the same founding rows, weights, repeats and
candidate order; against filter_pairs also the candidates' poses, cc,
scores and members. Cases: the first round, a rescue round with
``best_override``, n_scan above the table's length, one cluster only,
every pair its own cluster, the weight gate leaving nothing, and a table
from matched descriptors.
"""

import jax
import numpy as np
import pytest
import torch

from mad_tpu.core.config import FilterConfig as JF
from mad_tpu.engine.cluster import filter_pairs as jfilter
from mad_tpu.engine.dock_fused import _cluster_select_body, cloud_moments
from mad_tpu.engine.match import MatchTable as JTable
from mad_tpu_torch.convert import match_table_from_numpy
from mad_tpu_torch.core.config import FilterConfig as TF
from mad_tpu_torch.engine.docking import cluster_candidates
from mad_tpu_torch.kernels import cluster as k14
from mad_tpu_torch.testing import pose_table

torch.set_num_threads(1)


def _bins(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 112, n).astype(np.int32),
            rng.integers(0, 112, n).astype(np.int32))


def _fused(t, fkw, n_samples, best_override):
    """_cluster_select_body's founding rows, weights and candidate rows."""
    p = len(t["repeat"])
    n_scan = min(n_samples, p)
    f = JF(**fkw)
    run = jax.jit(_cluster_select_body(
        p, n_scan, n_scan, 112, f.rmsd_cloud, f.weight_threshold,
        f.min_repeat, f.repeat_frac))
    mu, M = cloud_moments(t["hi_cloud"])
    sel, _starts, _frozen = run(
        t["repeat"], t["rot"], t["hi_coord"].astype(np.float32),
        t["lo_coord"].astype(np.float32), np.int32(p), np.int32(n_samples),
        np.float32(best_override), mu, M,
        t["hi_cloud"].astype(np.float32))
    order, _assign, found_i, weights, _gate, cand_order, n_cands, _r = (
        np.asarray(x) for x in sel)
    oi = order[:n_scan]
    cands = cand_order[:int(n_cands)]
    return oi[found_i[cands]], weights[cands]


def _check(t, fkw, n_samples, best_repeat=None, seed=0):
    """The port's candidates against filter_pairs' and the fused body's;
    returns them."""
    hb, lb = _bins(len(t["repeat"]), seed)
    jt = JTable(**t)
    tt = match_table_from_numpy(**t)
    want = jfilter(jt, hb, lb, JF(**fkw), n_samples, best_repeat=best_repeat)
    k14.launches = 0
    got = cluster_candidates(tt, hb, lb, TF(**fkw), n_samples, "cpu",
                             best_repeat=best_repeat)
    assert k14.launches == 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("hi_coord", "lo_coord", "rot"):
            np.testing.assert_array_equal(getattr(g, key), getattr(w, key))
        assert (g.cc, g.weight, g.repeat, g.score) == \
            (w.cc, w.weight, w.repeat, w.score)
        assert len(g.members) == len(w.members)
        for a, b in zip(g.members, w.members):
            np.testing.assert_array_equal(a, b)
    rows, weights = _fused(t, fkw, n_samples,
                           -1.0 if best_repeat is None else best_repeat)
    row_of = {tuple(np.asarray(t["lo_coord"][r]).tolist())
              + tuple(np.asarray(t["hi_coord"][r]).tolist()): r
              for r in range(len(t["repeat"]))}
    got_rows = [row_of[tuple(g.lo_coord.tolist()) + tuple(g.hi_coord.tolist())]
                for g in got]
    assert got_rows == rows.tolist()
    assert [g.weight for g in got] == weights.tolist()
    return got


def test_first_round():
    got = _check(pose_table(400, 30, 1, noise=0.6), {}, 240)
    assert 3 < len(got) <= 30


def test_rescue_round_best_override():
    t = pose_table(300, 25, 2, noise=0.6)
    first = _check(t, {}, 200)
    # a best above the table's own raises the repeat gate
    best = float(t["repeat"][0]) * 3.2
    rescued = _check(t, {}, 200, best_repeat=best)
    assert 0 < len(rescued) < len(first)


def test_n_scan_above_table_length():
    got = _check(pose_table(150, 12, 3, noise=0.6), {}, 1000)
    assert sum(c.weight for c in got) <= 150 and got


def test_one_cluster_only():
    got = _check(pose_table(80, 1, 4, noise=0.02), {}, 60)
    assert len(got) == 1 and got[0].weight == 60


def test_every_pair_its_own_cluster():
    fkw = dict(rmsd_cloud=1e-3, weight_threshold=1, min_repeat=0.0,
               repeat_frac=0.0)
    got = _check(pose_table(90, 30, 5, noise=0.6), fkw, 90)
    assert len(got) == 90 and all(c.weight == 1 for c in got)


def test_weight_gate_leaves_nothing():
    assert _check(pose_table(120, 8, 6), dict(weight_threshold=10 ** 6),
                  120) == []


def test_table_from_matched_descriptors():
    """A match table of random descriptor sets (the tables of
    tests/test_torch_match.py): poses scatter, most pairs found clusters."""
    from test_torch_match import _sets
    from mad_tpu.core.config import MatchConfig as JMatch
    from mad_tpu.engine import match as jm
    rng = np.random.default_rng(0)
    jmap, _tmap = _sets(rng, 90, "map")
    jsub, _tsub = _sets(rng, 70, "sub")
    jt = jm.match_descriptors(jmap, jsub, (64, 60, 62), (4.0, 6.0, 5.0), 2.0,
                              JMatch())
    t = {k: getattr(jt, k) for k in ("cc", "repeat", "hi_idx", "lo_idx",
                                     "rot", "hi_coord", "lo_coord",
                                     "hi_cloud", "lo_cloud")}
    got = _check(t, dict(weight_threshold=1), 60)
    assert len(got) > 5
