"""K12 (csrc/approx.cu: a pair a lane behind a coarse occupancy map in
shared memory) and K16's lane blocks and their fold into the dedup launch
(csrc/post.cu) against their plain PyTorch versions on the card. Every
test here needs a CUDA card and skips without one; the file imports
neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_approx_lanes_cuda.py

Tolerances: K12 equal on every pair (it rounds as the plain version does:
anchors on .5 edges both ways, poses off the grid, NaN), with clouds of
33, 70 and 600 subunit anchors (more than the kernel stages at a time),
warps over several tiles, pose views off 16-byte alignment, and a field of
600^3 voxels (cells of edge 32); K16's lane entry and the fold: hits,
counts, accepted flags and slots equal to the plain stages', moved anchors
within 1e-12 A of them (the plain version sums the center in another
order) and the fold's moved anchors equal to the lane entry's bit for bit,
at 1, 28 and 100 lanes (33 and 70 subunit anchors) with failed lanes, NaN
map anchors and NaN atoms.
The renderings and the plain versions are held against mad_tpu on the CPU
by tests/test_torch_approx_lanes.py.
"""

import numpy as np
import pytest
import torch

from mad_tpu_torch.kernels import approx as k12
from mad_tpu_torch.kernels import field as k11
from mad_tpu_torch.kernels import post as k16
from mad_tpu_torch.parallel.mesh import make_mesh
from mad_tpu_torch.testing import pose_table

pytestmark = pytest.mark.cuda

ANCHOR_TOL = 1e-12


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _k12_inputs(cuda, shape, voxsp, n_pairs, a_hi, seed, exact=False):
    """K12's arguments: a pose table's poses and clouds (its map anchors
    made voxels, K11's field at radius 3); with ``exact`` signed
    permutation rotations and integer coordinates at 2 A voxels, so that
    moved anchors sit on .5 edges. Poses 0-4 off the grid and NaN."""
    rng = np.random.default_rng(seed)
    t = pose_table(n_pairs, max(1, n_pairs // 40), seed, a_hi=a_hi)
    origin = np.array([-60.0, -55.0, -70.0], np.float32)
    if exact:
        perms = np.array([np.eye(3)[list(p)] for p in
                          ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0),
                           (2, 0, 1), (2, 1, 0))])
        t["rot"] = perms[rng.integers(0, 6, n_pairs)] * rng.choice(
            [-1.0, 1.0], size=(n_pairs, 1, 3))
        t["hi_cloud"] = rng.integers(-12, 13, size=(a_hi, 3)) * 1.0
        t["hi_coord"] = t["hi_cloud"][rng.integers(0, a_hi, n_pairs)]
        t["lo_coord"] = np.round(t["lo_coord"])
        origin = np.zeros(3, np.float32)
    lo = np.asarray(t["lo_coord"], np.float32).copy()
    lo[:5] = [[1e9, 0, 0], [0, -1e9, 0], [3e38, 0, 0], [np.nan, 0, 0],
              [0, 0, np.nan]]
    vox = np.clip(np.round((t["lo_cloud"] - origin) / voxsp), 0,
                  np.asarray(shape) - 1).astype(np.int32)
    vox_d = torch.as_tensor(vox, device=cuda)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    return (k11.anchor_field(shape, vox_d, 3), vox_d, 3, f32(t["hi_cloud"]),
            f32(origin), float(np.float32(1.0 / voxsp)), f32(t["rot"]),
            f32(t["hi_coord"]), f32(lo))


def _k12_equal(args):
    before = k12.launches
    got = k12.approx_repeat(*args)
    assert k12.launches == before + 1
    want = k12.approx_repeat_plain(*args)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("case", ["edges", "clouds", "tiles"])
def test_k12_equals_plain(cuda, case):
    if case == "edges":             # .5 edges both ways, exact arithmetic
        args = _k12_inputs(cuda, (90, 80, 100), 2.0, 3000, 32, 1, True)
        v = ((args[6][5:, None] @ (args[3][None, :, :, None]
                                   - args[7][5:, None, :, None]))[..., 0]
             + args[8][5:, None] - args[4]) * args[5]
        assert int((v - torch.floor(v) == 0.5).sum()) > 1000
        got = _k12_equal(args)
        assert float(got[5:].max()) > 50
    elif case == "clouds":          # 33, 70 and 600 (> kCloud) anchors
        for a_hi in (33, 70, 600):
            _k12_equal(_k12_inputs(cuda, (90, 80, 100), 1.4, 2000 + a_hi,
                                   a_hi, a_hi))
    else:                           # several tiles a warp, unaligned views
        args = _k12_inputs(cuda, (273, 276, 262), 1.4, 150001, 32, 3)
        got = _k12_equal(args)
        view = list(args)
        for i in (6, 7, 8):             # 4 bytes past a 16-byte boundary
            buf = torch.empty(args[i].numel() + 1, dtype=torch.float32,
                              device=cuda)
            buf[1:] = args[i].reshape(-1)
            view[i] = buf[1:].view(args[i].shape)
        assert view[6].data_ptr() % 16 != 0
        assert torch.equal(k12.approx_repeat(*view), got)
        assert (got[:5] >= 0).all() and float(got.max()) > 50


def test_k12_large_grid(cuda):
    """A 600^3 field: the launcher takes cells of edge 32."""
    shape = (600, 600, 600)
    assert k12.coarse_shift(shape) == 5
    args = _k12_inputs(cuda, shape, 0.25, 4096, 32, 4)
    got = _k12_equal(args)
    assert float(got.max()) > 50
    cells = k12.coarse_cells(shape, args[1], 3)
    assert cells.shape == (19, 19, 19) and not bool(cells.all())


def _lanes_round(cuda, C, seed, S=4, N=520, n=130, A=33, B=414):
    """One round's lane and dedup inputs: C lanes near six base poses,
    S earlier solutions, about a tenth of the lanes failed (the first
    always)."""
    rng = np.random.default_rng(seed)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=cuda)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    x0 = rng.normal(size=(N, 3)) * 12
    base = rng.normal(size=(6, 1, 3)) * 30 + x0
    coords = base[rng.integers(0, 6, C)] + rng.normal(size=(C, N, 3)) * \
        rng.choice([0.3, 4.0], size=(C, 1, 1))
    prev = base[rng.integers(0, 6, S)] + rng.normal(size=(S, N, 3))
    failed = rng.random(C) < 0.1
    failed[0] = True
    q, _r = np.linalg.qr(rng.normal(size=(C, 3, 3)))
    cloud = np.unique(np.round(rng.normal(size=(B, 3)) * 40) / 2, axis=0)
    idx = torch.as_tensor(np.sort(rng.choice(N, n, replace=False)),
                          device=cuda)
    return dict(
        rot_m=f32(np.eye(3) + rng.normal(size=(C, 3, 3)) * 1e-3),
        trans_m=f32(rng.normal(size=(C, 3))), coords_m=f32(coords),
        failed=torch.as_tensor(failed, device=cuda), cand_rot=f64(q),
        cand_hi=f64(rng.normal(size=(C, 3)) * 5),
        cand_lo=f64(rng.normal(size=(C, 3)) * 5),
        x0=f64(x0.astype(np.float32)),
        hi_cloud=f64(x0[rng.choice(N, A, replace=False)]),
        lo_cloud=f64(cloud), prev=f64(prev), idx=idx, hit=20.0, dedup=6.0)


def _fold_args(r):
    return tuple(r[k] for k in (
        "rot_m", "trans_m", "coords_m", "failed", "cand_rot", "cand_hi",
        "cand_lo", "x0", "hi_cloud", "lo_cloud", "prev", "idx", "hit",
        "dedup"))


def _lane_args(r):
    return tuple(r[k] for k in (
        "rot_m", "trans_m", "failed", "cand_rot", "cand_hi", "cand_lo", "x0",
        "hi_cloud", "lo_cloud", "hit"))


@pytest.mark.parametrize("C", [1, 28, 100])
def test_k16_lane_entry_and_fold(cuda, C):
    for variant in ("plain", "nan cloud", "nan atom"):
        # 70 anchors: clusters of 8 blocks whose warps take two anchors
        r = _lanes_round(cuda, C, C, A=70 if C == 100 else 33)
        if variant == "nan cloud":
            r["lo_cloud"][5, 1] = float("nan")          # every lane hitless
        la = _lane_args(r)
        for a, e in ((0, C), (C // 3, C), (0, (C + 1) // 2)):
            before = k16.lane_launches
            got = k16.post_lanes(*la, a, e - a)
            assert k16.lane_launches == before + (e > a)
            want = k16.post_lanes_plain(*la, a, e - a)
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[2], want[2])
            if e > a:
                assert float((got[0] - want[0]).abs().max()) <= ANCHOR_TOL
        lanes = k16.post_lanes(*la, 0, C)
        if variant == "nan atom" and C > 1:
            ok = torch.nonzero(~r["failed"] & (lanes[2] > 0))
            if len(ok):
                r["coords_m"][int(ok[0]), int(r["idx"][3]), 0] = float("nan")
        dedup = k16.post_dedup(r["coords_m"], r["failed"], lanes[2],
                               r["prev"], r["idx"], r["dedup"])
        fa = _fold_args(r)
        before = (k16.fold_launches, k16.lane_launches, k16.launches)
        got = k16.post_lanes_dedup(*fa)
        assert (k16.fold_launches, k16.lane_launches, k16.launches) == (
            before[0] + 1, before[1], before[2])
        for g, w in zip(got, lanes + dedup):            # the two launches
            assert torch.equal(g, w)
        want = k16.post_lanes_dedup_plain(*fa)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
        assert float((got[0] - want[0]).abs().max()) <= ANCHOR_TOL
        assert not bool(got[1][r["failed"]].any())
        if variant == "nan cloud":
            assert int(got[2].sum()) == 0 and not bool(got[3].any())


def test_k16_launches_on_one_device_and_on_a_mesh(cuda):
    """Through the round (``post``): on one device the fold, once, and no
    lane or dedup launch; on two shards of the card a lane launch a shard
    and the dedup once, no fold."""
    r = _lanes_round(cuda, 28, 5)
    rows = r["lo_cloud"][torch.arange(0, r["lo_cloud"].shape[0], 3)]
    args = _fold_args(r) + (rows, 4.0, 16)
    count = lambda: (k16.fold_launches, k16.lane_launches, k16.launches)
    before = count()
    one = k16.post(*args)
    assert count() == (before[0] + 1, before[1], before[2])
    before = count()
    two = k16.post(*args, mesh=make_mesh(2, devices=[cuda] * 2))
    assert count() == (before[0], before[1] + 2, before[2] + 1)
    assert torch.equal(one, two)
    want = k16.post_plain(*args)
    C, A = 28, r["hi_cloud"].shape[0]
    g = k16.split_post(one.cpu().numpy(), C, A, 16)
    w = k16.split_post(want.cpu().numpy(), C, A, 16)
    assert all(np.array_equal(x, y) for x, y in zip(g[1:], w[1:]))
    assert np.abs(g[0] - w[0]).max() <= ANCHOR_TOL
