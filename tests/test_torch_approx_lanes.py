"""Renderings of K12's coarse map and K16's lane blocks (csrc/approx.cu,
csrc/post.cu) and the plain version of K16's fold (the lanes and the dedup
in one launch) against mad_tpu on the CPU, with numpy inputs made from a
seed. Required:
  * a numpy rendering of K12's coarse map (a byte a cell, set in every
    cell of each map anchor voxel's box [u - r, u + r] clipped to the grid)
    holds every voxel that mad_tpu's ``_field_body`` sets, at r 1 and 3,
    with anchors on every face and corner, grid sides that are not
    multiples of the cell and a grid smaller than one cell; it equals
    ``approx.coarse_cells`` at the cell edge the launcher picks;
  * a numpy rendering of K12's decision (in the grid, then the cell, then
    the field) equals ``_compiled_approx_repeat`` and the plain version bit
    for bit on poses whose arithmetic is exact (signed permutations,
    integer coordinates, 2 A voxels): anchors on .5 edges rounding both
    ways, poses off the grid and NaN (a NaN coordinate is voxel 0 there,
    as XLA's int32 convert makes it);
  * a numpy rendering of K16's lane blocks: every block of a lane holds
    the center of the earlier order (one block a lane) bit for bit, its
    anchor split covers every anchor once (A = 1, 7, 8, 9, 32, 33, 70), the
    hits and counts equal ``post_lanes_plain``'s and the moved anchors
    lie within 1e-12 A of them (the plain version sums the center in
    another order);
  * the fold's plain version equals the two plain stages, and the port's
    merge through ``_round`` on one device (which takes the fold) gives
    mad_tpu's ``_merge_refined`` solutions.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.engine import docking as jdock
from mad_tpu.engine import match as jm
from mad_tpu_torch.core.config import MadConfig as TConfig
from mad_tpu_torch.engine import docking as tdock
from mad_tpu_torch.kernels import approx as k12
from mad_tpu_torch.kernels import build
from mad_tpu_torch.kernels import post as k16
from mad_tpu_torch.testing import post_round, post_scenario

torch.set_num_threads(1)

ANCHOR_TOL = 1e-12
POST = build.constants("post.cu")
WARPS, THREADS, LANE_BLOCKS = (POST["kWarps"], POST["kThreads"],
                               POST["kLaneBlocks"])


def _render_map(shape, vox, r, s):
    """The kernel's map of cells of edge 2 ** s, a byte a cell, as a bool
    array: per anchor, every cell of its clipped box in cell units, each
    an (anchor, cell) of the span^3 that a thread takes."""
    dims = np.asarray(shape)
    side = -(-dims // (1 << s))
    cells = np.zeros(int(np.prod(side)), np.uint8)
    span = ((2 * r) >> s) + 2
    for u in vox:
        lo, hi = np.maximum(u - r, 0), np.minimum(u + r, dims - 1)
        if (lo > hi).any():
            continue
        lo, hi = lo >> s, hi >> s
        for c in range(span ** 3):
            cx = lo[0] + c // (span * span)
            cy = lo[1] + (c // span) % span
            cz = lo[2] + c % span
            if cx <= hi[0] and cy <= hi[1] and cz <= hi[2]:
                cells[(cx * side[1] + cy) * side[2] + cz] = 1
    return cells.reshape(tuple(side)).astype(bool)


def _anchors(rng, shape, n):
    """n anchor voxels inside the grid, the first 14 on its corners and
    face centres."""
    d = np.asarray(shape) - 1
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                        for z in (0, 1)]) * d
    faces = np.array([[0, .5, .5], [1, .5, .5], [.5, 0, .5], [.5, 1, .5],
                      [.5, .5, 0], [.5, .5, 1]]) * d
    inner = rng.integers(0, np.asarray(shape), size=(n - 14, 3))
    return np.concatenate([corners, faces.astype(int), inner]).astype(
        np.int32)


def test_coarse_map_holds_the_field():
    rng = np.random.default_rng(20)
    for shape in ((101, 91, 71), (161, 150, 141), (5, 7, 6)):
        vox = _anchors(rng, shape, 40)
        for r in (1, 3):
            field = np.asarray(jm._compiled_field(shape, r)(
                vox, np.ones(len(vox), bool))) > 0
            x, y, z = np.nonzero(field)
            picked = k12.coarse_shift(shape)
            for s in sorted({picked, 4}):        # 4: cells of edge 16
                cells = _render_map(shape, vox, r, s)
                assert cells[x >> s, y >> s, z >> s].all()
                if s == picked:
                    np.testing.assert_array_equal(
                        k12.coarse_cells(shape, torch.as_tensor(vox), r)
                        .numpy(), cells)
            assert field.any() and (shape[0] < 8 or not field.all())
    assert k12.coarse_shift((101, 91, 71)) == 2
    assert k12.coarse_shift((161, 150, 141)) == 3
    assert k12.coarse_shift((273, 276, 262)) == 3          # the bench's
    assert k12.coarse_shift((600, 600, 600)) == 5


def _exact_poses(rng, P, A, shape):
    """Poses whose float32 arithmetic is exact: signed permutation
    rotations, integer subunit anchors, pair anchors and shifts, so that at
    2 A voxels a moved anchor lands on a .5 edge whenever its coordinate is
    odd."""
    perms = np.array([np.eye(3)[list(p)] for p in
                      ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0),
                       (2, 0, 1), (2, 1, 0))])
    rot = perms[rng.integers(0, 6, P)] * rng.choice([-1.0, 1.0],
                                                    size=(P, 1, 3))
    cloud = rng.integers(-12, 13, size=(A, 3)).astype(np.float32)
    hi = cloud[rng.integers(0, A, P)]
    lo = rng.integers(0, 2 * np.asarray(shape), size=(P, 3))
    return cloud, rot.astype(np.float32), hi, lo.astype(np.float32)


def _render_decision(field, cells, s, cloud, origin, inv, rot, hi, lo):
    """The kernel's per-pair score in numpy float32: the pose summed as
    rows_times does, rint, the in-grid test on the rounded floats, then the
    cell, then the field; and the number of .5 edges rounded down and up."""
    x = cloud[None] - hi[:, None]
    y = np.stack([((x[..., 0] * rot[:, None, e, 0]
                    + x[..., 1] * rot[:, None, e, 1])
                   + x[..., 2] * rot[:, None, e, 2]) + lo[:, None, e]
                  for e in range(3)], axis=-1)
    t = (y - origin) * inv
    v = np.rint(t)
    v[np.isnan(v)] = 0                  # NaN: voxel 0, as XLA converts it
    with np.errstate(invalid="ignore"):
        inb = ((v >= 0) & (v < np.asarray(field.shape, np.float32))).all(-1)
    vi = np.where(inb[..., None], v, 0).astype(np.int64)
    cell = cells[vi[..., 0] >> s, vi[..., 1] >> s, vi[..., 2] >> s]
    hit = inb & cell & (field[vi[..., 0], vi[..., 1], vi[..., 2]] > 0)
    cnt = hit.sum(axis=1).astype(np.float32)
    score = (np.float32(100.0) * cnt) / np.float32(max(len(cloud), 1))
    edge = inb[..., None] & (t - np.floor(t) == 0.5)
    return score, int((edge & (v < t)).sum()), int((edge & (v > t)).sum())


def test_decision_equals_compiled_approx_repeat():
    rng = np.random.default_rng(21)
    shape, r, P, A = (80, 72, 70), 2, 512, 12       # cells of edge 4
    vox = _anchors(rng, shape, 60)
    field = np.asarray(jm._compiled_field(shape, r)(
        vox, np.ones(len(vox), bool)))
    cloud, rot, hi, lo = _exact_poses(rng, P, A, shape)
    lo[:4] = [[1e9, 0, 0], [0, -1e9, 0], [3e38, 0, 0], [np.nan, 0, 0]]
    lo[4:12] = 2.0 * vox[:8] + 1.0                   # on the anchors, .5 off
    hi[4:12] = cloud[:8]
    origin, inv = np.zeros(3, np.float32), np.float32(0.5)
    s = k12.coarse_shift(shape)
    cells = _render_map(shape, vox, r, s)
    got, down, up = _render_decision(field, cells, s, cloud, origin, inv,
                                     rot, hi, lo)
    want = np.asarray(jm._compiled_approx_repeat(shape, A, P, 256)(
        field, cloud, np.ones(A, bool), origin, inv, rot, hi, lo))
    t = lambda a: torch.as_tensor(np.array(a))
    plain = k12.approx_repeat(t(field), t(vox), r, t(cloud), t(origin),
                              float(inv), t(rot), t(hi), t(lo)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    assert down > 100 and up > 100                   # both ways
    assert (got[:3] == 0).all() and got[3] > 0 and (got > 0).sum() > 8
    assert s == 2 and not cells.all()


def _center_rendering(x0, A, b, order):
    """The lane's center as one block of THREADS threads sums it: strided
    partial sums, each warp's xor tree (lane 0's value), then the warps'
    sums in order, by thread 0 for each coordinate (one block a lane,
    ``order`` 0) or by thread e for coordinate e (``order`` 1: the same
    additions)."""
    N = len(x0)
    part = np.zeros((THREADS, 3))
    for t in range(THREADS):
        for n in range(t, N, THREADS):
            for e in range(3):
                p = ((x0[n, 0] * A[0, e] + x0[n, 1] * A[1, e])
                     + x0[n, 2] * A[2, e]) + b[e]
                part[t, e] = part[t, e] + p
    warps = part.reshape(THREADS // 32, 32, 3).copy()
    for off in (16, 8, 4, 2, 1):
        warps = warps + warps[:, np.arange(32) ^ off]
    red = warps[:, 0]
    center = np.zeros(3)
    for e in (range(3) if order == 0 else (2, 1, 0)):
        v = red[0, e]
        for w in range(1, THREADS // 32):
            v = v + red[w, e]
        center[e] = v / N
    return center


def test_lane_blocks_center_split_and_hits():
    rng = np.random.default_rng(22)
    N, B, hit = 300, 90, 9.0
    x0 = rng.normal(size=(N, 3)) * 10
    clouds = [rng.normal(size=(B, 3)) * 14]
    clouds.append(clouds[0].copy())
    clouds[1][7, 2] = np.nan            # every lane hitless
    for A in (1, 7, 8, 9, 32, 33, 70):
        lo_cloud = clouds[A == 33]
        G = min(LANE_BLOCKS, max(1, -(-A // WARPS)))
        # block g's warp w: anchors g WARPS + w + k WARPS G
        blocks = [[a for w in range(WARPS)
                   for a in range(g * WARPS + w, A, WARPS * G)]
                  for g in range(G)]
        assert sorted(a for b in blocks for a in b) == list(range(A))
        C = 3
        q, _r = np.linalg.qr(rng.normal(size=(C, 3, 3)))
        args = [torch.as_tensor(a) for a in (
            np.eye(3, dtype=np.float32) + rng.normal(size=(C, 3, 3))
            .astype(np.float32) * 1e-2,
            rng.normal(size=(C, 3)).astype(np.float32),
            np.array([False, True, False]), q, rng.normal(size=(C, 3)) * 5,
            rng.normal(size=(C, 3)) * 5, x0,
            x0[rng.choice(N, A, replace=False)], lo_cloud)]
        s_a, hits, counts = k16.post_lanes_plain(*args, hit, 0, C)
        rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo = (
            a.numpy().astype(np.float64) for a in args[:6])
        for c in range(C):
            Am = cand_rot[c].T
            b = cand_lo[c] - ((cand_hi[c, 0] * Am[0] + cand_hi[c, 1] * Am[1])
                              + cand_hi[c, 2] * Am[2])
            center = _center_rendering(x0, Am, b, 0)
            np.testing.assert_array_equal(_center_rendering(x0, Am, b, 1),
                                          center)
            if failed[c]:
                assert not hits[c].any() and counts[c] == 0
                continue
            u = ((args[7].numpy()[:, :1] * Am[0] + args[7].numpy()[:, 1:2]
                  * Am[1]) + args[7].numpy()[:, 2:] * Am[2]) + b - center
            R = rot_m[c]
            sa = (((u[:, :1] * R[0] + u[:, 1:2] * R[1]) + u[:, 2:] * R[2])
                  + center) + trans_m[c]
            d = lo_cloud[None] - sa[:, None]
            d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
                + d[..., 2] * d[..., 2]
            # two running minima a lane (points lane and lane + 32 of each
            # 64), then the warp's; min propagates NaN as min_nan does
            mins = [np.min(d2[:, j::64], axis=1) if j < B else
                    np.full(A, np.inf) for j in range(64)]
            best = np.min(np.stack(mins), axis=0)
            mine = best < hit * hit
            np.testing.assert_array_equal(mine, hits[c].numpy() != 0)
            assert counts[c] == mine.sum()
            # the ticket: G blocks' (arrived << 32 | hits) summed
            word = sum((1 << 32) | int(mine[blocks[g]].sum())
                       for g in range(G))
            assert word >> 32 == G and word & 0xffffffff == counts[c]
            assert np.abs(sa - s_a[c].numpy()).max() <= ANCHOR_TOL
        assert (counts.sum() == 0) == (A == 33)


def test_fold_plain_and_round_through_fold(monkeypatch):
    """The fold's plain version is the two plain stages; the port's merge of
    tests/test_torch_post.py's two rounds on one device goes through the
    fold (never the lane entry) and gives mad_tpu's solutions."""
    sc = post_scenario(seed=4)
    calls = {"fold": 0, "lanes": 0}
    fold, lanes = k16.post_lanes_dedup, k16.post_lanes

    def spy_fold(*a):
        calls["fold"] += 1
        got = fold(*a)
        want = k16.post_lanes_plain(a[0], a[1], *a[3:10], a[12], 0,
                                    a[0].shape[0])
        want += k16.post_dedup_plain(a[2], a[3], want[2], a[10], a[11],
                                     a[13])
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        return got

    def spy_lanes(*a):
        calls["lanes"] += 1
        return lanes(*a)

    monkeypatch.setattr(k16, "post_lanes_dedup", spy_fold)
    monkeypatch.setattr(k16, "post_lanes", spy_lanes)
    dmap = SimpleNamespace(voxsp=2.0)
    table = SimpleNamespace(hi_cloud=sc["hi_cloud"], lo_cloud=sc["lo_cloud"],
                            lo_coord=sc["lo_rows"])
    jsols, tsols = [], []
    for r in range(2):
        rd = sc["rounds"][r]
        cands = [SimpleNamespace(rot=rd["rot"][i], hi_coord=rd["hi"][i],
                                 lo_coord=rd["lo"][i], weight=rd["weight"][i],
                                 members=rd["members"][i])
                 for i in range(len(rd["weight"]))]
        res = SimpleNamespace(rot=rd["R"], trans=rd["t"],
                              failed=rd["failed"],
                              coords=rd["coords"].astype(np.float64))
        j_new = jdock._merge_refined(res, cands, jsols, sc["sub"], dmap,
                                     table, JConfig())
        cands, res = post_round(sc, r, "cpu")
        t_new, _top = tdock._merge_refined(res, cands, tsols, sc["sub"],
                                           dmap, table, TConfig(), "cpu", 40)
        assert t_new == j_new
    assert calls == {"fold": 2, "lanes": 0}
    assert len(tsols) == len(jsols) == 4
    for a, b in zip(tsols, jsols):
        np.testing.assert_array_equal(a.structure.coords, b.structure.coords)
        assert a.weight == b.weight and a.repeat == b.repeat
        assert np.abs(a.corresp_anchors - b.corresp_anchors).max() \
            <= ANCHOR_TOL
