"""K14 (csrc/cluster.cu: near pairs over the grid, a one-warp founder
scan, a warp per row's assignment) and K16's five stage entries
(csrc/post.cu) against their plain PyTorch versions on the card. Every
test here needs a CUDA card and skips without one; the file imports
neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cluster_post_cuda.py

Tolerances: K14's selection vector equal, at 1, 33, 600 and 4,000 rows
and with every row its own cluster or one cluster; K16's dedup, point,
row and compaction outputs equal, the lane stage's hits and counts equal
and its moved anchors within 1e-12 A (the centroid is summed in another
order; ROADMAP Queue 3), at the bench's shapes (28 lanes of 1,040 atoms,
260 RMSD atoms, 32 subunit and 414 map anchors, 46,848 table rows), on
ragged (start, count) ranges with earlier solutions, with the dedup's
RMSDs too many for shared memory, and with NaN anchors and atoms. The
plain versions are held against mad_tpu on the CPU by
tests/test_torch_cluster_select.py, tests/test_torch_post.py and
tests/test_torch_cluster_post_layout.py.
"""

import numpy as np
import pytest
import torch

from mad_tpu_torch.convert import match_table_from_numpy
from mad_tpu_torch.core.config import FilterConfig
from mad_tpu_torch.engine.docking import selection_args
from mad_tpu_torch.kernels import build
from mad_tpu_torch.kernels import cluster as k14
from mad_tpu_torch.kernels import post as k16
from mad_tpu_torch.testing import pose_table

pytestmark = pytest.mark.cuda

ANCHOR_TOL = 1e-12
POST = build.constants("post.cu")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _k14(cuda, n, rmsd_cloud=10.0, seed=3):
    """The kernel's and the plain version's selection of n rows of a
    pose table around n / 15 centre poses; the call's three kernels
    launched once each."""
    t = match_table_from_numpy(**pose_table(n, max(1, n // 15), seed,
                                            noise=0.6))
    args = selection_args(t, FilterConfig(rmsd_cloud=rmsd_cloud), n, cuda)
    before = k14.launches
    got = k14.cluster_select(*args)
    assert k14.launches == before + 3
    want = k14.cluster_select_plain(*args)
    assert torch.equal(got, want)
    return k14.split_selection(got.cpu().numpy(), n)


@pytest.mark.parametrize("n", [1, 33, 600, 4000])
def test_k14_matches_plain(cuda, n):
    _assign, found, _w, _c, _n = _k14(cuda, n)
    assert 1 <= len(found) <= n


def test_k14_extreme_rmsd(cuda):
    """Every row its own cluster (rmsd_cloud 1e-3) and one cluster (1e9),
    at 600 and 4,000 rows."""
    for n in (600, 4000):
        assert len(_k14(cuda, n, 1e-3)[1]) == n
        assert len(_k14(cuda, n, 1e9)[1]) == 1


def _round(cuda, S, seed, C=28, N=1040, n=260, A=32, B=414, P=46848):
    """One docking round's K16 inputs at the bench's shapes: C lanes near
    six base poses (so that some merge), S earlier solutions, three lanes
    failed, the map-anchor cloud from np.unique on a 0.5 A lattice and P
    table rows on it, 30 of them off it."""
    rng = np.random.default_rng(seed)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=cuda)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    x0 = rng.normal(size=(N, 3)) * 12
    base = rng.normal(size=(6, 1, 3)) * 30 + x0
    coords = base[rng.integers(0, 6, C)] + rng.normal(size=(C, N, 3)) * \
        rng.choice([0.3, 4.0], size=(C, 1, 1))
    prev = base[rng.integers(0, 6, S)] + rng.normal(size=(S, N, 3))
    failed = np.zeros(C, bool)
    failed[rng.choice(C, 3, replace=False)] = True
    q, _r = np.linalg.qr(rng.normal(size=(C, 3, 3)))
    cloud = np.unique(np.round(rng.normal(size=(B, 3)) * 40) / 2, axis=0)
    rows = cloud[rng.integers(0, len(cloud), P)]
    rows[rng.choice(P, 30, replace=False)] += 0.25
    hi_cloud = x0[rng.choice(N, A, replace=False)]
    idx = torch.as_tensor(np.sort(rng.choice(N, n, replace=False)),
                          device=cuda)
    return (f32(np.eye(3) + rng.normal(size=(C, 3, 3)) * 1e-3),
            f32(rng.normal(size=(C, 3))), f32(coords),
            torch.as_tensor(failed, device=cuda), f64(q),
            f64(rng.normal(size=(C, 3)) * 5), f64(rng.normal(size=(C, 3)) * 5),
            f64(x0.astype(np.float32)), f64(hi_cloud), f64(cloud), f64(prev),
            idx, 20.0, 6.0, f64(rows), 4.0, 600)


def _stages(args, ragged):
    """Each stage entry against its plain version, each stage's inputs
    from the plain stages before it; the lane, point and row stages on
    (3, count - 5) when ``ragged``. Returns the accepted lanes and the
    rows taken."""
    (rot_m, trans_m, coords_m, failed, cand_rot, cand_hi, cand_lo, x0,
     hi_cloud, lo_cloud, prev, idx, hit, dedup, lo_rows, ad, n_top) = args
    C, B, P = coords_m.shape[0], lo_cloud.shape[0], lo_rows.shape[0]
    cut = (lambda m: (3, m - 5)) if ragged else (lambda m: (0, m))
    la = (rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo, x0, hi_cloud,
          lo_cloud, hit)
    g, w = k16.post_lanes(*la, *cut(C)), k16.post_lanes_plain(*la, *cut(C))
    assert torch.equal(g[1], w[1]) and torch.equal(g[2], w[2])
    assert float((g[0] - w[0]).abs().max()) <= ANCHOR_TOL
    counts = k16.post_lanes_plain(*la, 0, C)[2]
    da = (coords_m, failed, counts, prev, idx, dedup)
    g, w = k16.post_dedup(*da), k16.post_dedup_plain(*da)
    assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    acc = w[0]
    pa = (lo_cloud, prev, coords_m, acc, ad)
    assert torch.equal(k16.post_points(*pa, *cut(B)),
                       k16.post_points_plain(*pa, *cut(B)))
    elig = k16.post_points_plain(*pa, 0, B)
    ra = (lo_rows, lo_cloud, elig, prev, coords_m, acc, ad)
    assert torch.equal(k16.post_rows(*ra, *cut(P)),
                       k16.post_rows_plain(*ra, *cut(P)))
    flags = k16.post_rows_plain(*ra, 0, P)
    for f in (flags, flags[1:], flags[:0]):     # an offset view, no rows
        for top in (n_top, 0, P):
            assert torch.equal(k16.post_compact(f, top),
                               k16.post_compact_plain(f, top))
    return acc, k16.post_compact_plain(flags, n_top)


def test_k16_stages_bench_shape(cuda):
    counters = ("lane_launches", "launches", "point_launches",
                "row_launches", "compact_launches")
    before = [getattr(k16, c) for c in counters]
    acc, taken = _stages(_round(cuda, 0, 5), False)
    assert all(getattr(k16, c) > b for c, b in zip(counters, before))
    assert 0 < int(acc.sum()) < 25 and int(taken[0]) > 0


def test_k16_stages_ragged_with_earlier_solutions(cuda):
    acc, taken = _stages(_round(cuda, 16, 6, P=46848 - 9), True)
    assert int(taken[0]) > 0


def test_k16_unstaged_dedup_and_nan_atoms(cuda):
    """The dedup scan on rmat in global memory (C (S + C) above the 3
    kStage RMSDs the last block stages: 64 lanes and no earlier solution,
    28 lanes and 120), every stage against its plain version; then NaN
    as the plain versions take it: a NaN map anchor leaves every lane
    hitless, a NaN atom of an accepted lane makes every point and row
    eligible, one of a rejected lane changes nothing."""
    for S, C, seed, ragged in ((0, 64, 7, False), (120, 28, 8, True)):
        assert C * (S + C) > 3 * POST["kStage"]
        acc, taken = _stages(_round(cuda, S, seed, C=C), ragged)
        assert 0 < int(acc.sum()) < C and int(taken[0]) > 0
    (rot_m, trans_m, coords_m, failed, cand_rot, cand_hi, cand_lo, x0,
     hi_cloud, lo_cloud, prev, idx, hit, dedup, lo_rows, ad,
     _n_top) = _round(cuda, 4, 9)
    cloud = lo_cloud.clone()
    cloud[5, 1] = float("nan")
    la = (rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo, x0, hi_cloud,
          cloud, hit, 0, coords_m.shape[0])
    g, w = k16.post_lanes(*la), k16.post_lanes_plain(*la)
    assert torch.equal(g[1], w[1]) and torch.equal(g[2], w[2])
    assert int(w[2].sum()) == 0
    counts = k16.post_lanes_plain(*la[:8], lo_cloud, hit, *la[-2:])[2]
    acc = k16.post_dedup_plain(coords_m, failed, counts, prev, idx, dedup)[0]
    B, P = lo_cloud.shape[0], lo_rows.shape[0]
    for accepted in (True, False):
        lane = int(torch.nonzero(acc if accepted else acc == 0)[0])
        coords = coords_m.clone()
        coords[lane, 7, 0] = float("nan")
        pa = (lo_cloud, prev, coords, acc, ad, 0, B)
        elig = k16.post_points_plain(*pa)
        assert torch.equal(k16.post_points(*pa), elig)
        ra = (lo_rows, lo_cloud, elig, prev, coords, acc, ad, 0, P)
        flags = k16.post_rows_plain(*ra)
        assert torch.equal(k16.post_rows(*ra), flags)
        assert bool(flags.all()) == accepted and bool(elig.all()) == accepted
