"""The orders of decision of K14 (csrc/cluster.cu) and K16's redesigned
stages (csrc/post.cu), rendered in numpy on the CPU and held equal to the
plain versions (kernels/cluster.py, kernels/post.py) and to mad_tpu.

  * K14's founder scan: every (row, earlier row) near test as one bit
    matrix, then the founders found a 32-row tile at a time (a row is
    blocked by the earlier tiles' founders through its near words; inside
    the tile the lowest unblocked row founds and the rows near it drop
    out), then each other row's argmin of (r2, slot) over the founders
    before it; equal to cluster_select_plain's assignment, founding rows
    and weights, and its candidates to mad_tpu's host filter_pairs. Tables:
    the bench-like table of test_torch_cluster_select.py, one where every
    row founds, one cluster, and exact r2 ties between two founders.
  * K16's row stage: a binary search of the np.unique cloud in (x, y, z)
    order, taking a point only when its coordinates equal the row's, and
    the atoms' own minimum otherwise; equal to post_rows_plain's linear
    match, with signed zeros, rows off the cloud and NaN rows, and on a
    shuffled cloud (the search then misses rows, whose fallback gives the
    same flags).
  * K16's dedup scan as 32-lane tiles (the founder scan's bit form on the
    RMSDs), its point stage as tiles of points against runs of atoms (a
    NaN atom of an accepted lane propagating through the minima, as in
    the plain version), and its compaction as 16-flag masks with a scan
    per 16 K rows; equal to the plain versions.
"""

import jax  # noqa: F401  (mad_tpu's host path imports it)
import numpy as np
import pytest
import torch

from mad_tpu.core.config import FilterConfig as JF
from mad_tpu.engine.cluster import filter_pairs as jfilter
from mad_tpu.engine.match import MatchTable as JTable
from mad_tpu_torch.convert import match_table_from_numpy
from mad_tpu_torch.core.config import FilterConfig as TF
from mad_tpu_torch.engine.docking import selection_args
from mad_tpu_torch.kernels import build
from mad_tpu_torch.kernels import cluster as k14
from mad_tpu_torch.kernels import post as k16
from mad_tpu_torch.testing import pose_table

torch.set_num_threads(1)

TILE = build.constants("cluster.cu")["kTile"]
POST = build.constants("post.cu")


# -- K14 ---------------------------------------------------------------------

def tiled_selection(rot, hi, lo, repeat, mu, M, rmsd):
    """(assign, founding rows, weights) by csrc/cluster.cu's three phases."""
    n = rot.shape[0]
    A = torch.as_tensor(rot).to(torch.float64).transpose(1, 2)
    hi, lo = torch.as_tensor(hi), torch.as_tensor(lo)
    b = lo - ((hi[:, 0:1] * A[:, 0] + hi[:, 1:2] * A[:, 1])
              + hi[:, 2:3] * A[:, 2])
    mu, M = torch.as_tensor(mu), torch.as_tensor(M)
    # r2[i, j]: row i's pose against row j's as a founder
    r2 = torch.stack([k14._cloud_r2(A, b, A[i], b[i], mu, M)
                      for i in range(n)]).numpy()
    with np.errstate(invalid="ignore"):
        near = (~np.isnan(r2) & ~(np.sqrt(np.maximum(r2, 0.0)) > rmsd)
                & np.tri(n, n, -1, dtype=bool))
    W = k14.near_words(n)
    bits = np.zeros((n, W * TILE), dtype=np.uint64)
    bits[:, :n] = near
    words = (bits.reshape(n, W, TILE) << np.arange(TILE, dtype=np.uint64)
             ).sum(axis=2).astype(np.uint64)
    fw = np.zeros(W, dtype=np.uint64)
    slot_of, founders_rows = np.full(n, -1), []
    for t in range(-(-n // TILE)):
        rows = np.arange(t * TILE, min(n, (t + 1) * TILE))
        blocked = (words[rows, :t] & fw[:t]).any(axis=1)
        own = words[rows, t]
        cand = {k for k, bl in enumerate(blocked) if not bl}
        founders = 0
        while cand:
            k = min(cand)
            founders |= 1 << k
            cand -= {k} | {m for m in cand if (int(own[m]) >> k) & 1}
        for k in range(len(rows)):
            if (founders >> k) & 1:
                slot_of[rows[k]] = len(founders_rows)
                founders_rows.append(rows[k])
        fw[t] = founders
    found = np.asarray(founders_rows)
    assign = slot_of.copy()
    for i in np.nonzero(slot_of < 0)[0]:
        before = found[found < i]
        v = r2[i, before]
        ok = ~np.isnan(v)
        assign[i] = np.flatnonzero(ok)[np.argmin(v[ok])]   # first on ties
    return assign, found, np.bincount(assign, minlength=len(found))


def _tie_table():
    """A 60-row table whose rows 0 and 1 found clusters with the same
    rotation, b 16 A apart, and row 2 lies exactly halfway: r2 = 64 to
    both, a tie that the first slot wins."""
    t = pose_table(60, 4, 8, noise=0.6)
    for k, dx in ((0, 8.0), (1, -8.0), (2, 0.0)):
        t["rot"][k] = t["rot"][0]
        t["hi_coord"][k] = 0.0
        t["lo_coord"][k] = np.array([10.0 + dx, -3.0, 5.0])
    return t


CASES = {
    "bench_like": (lambda: pose_table(400, 30, 1, noise=0.6), {}, 240),
    "every_row_founds": (lambda: pose_table(100, 30, 5, noise=0.6),
                         dict(rmsd_cloud=1e-3, weight_threshold=1,
                              min_repeat=0.0, repeat_frac=0.0), 100),
    "one_cluster": (lambda: pose_table(80, 1, 4, noise=0.02), {}, 60),
    "r2_ties": (_tie_table, dict(weight_threshold=1), 60),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k14_founder_scan(case):
    make, fkw, n_samples = CASES[case]
    t = make()
    table = match_table_from_numpy(**t)
    n = min(n_samples, table.n)
    args = selection_args(table, TF(**fkw), n, "cpu")
    assign, found, weights = tiled_selection(*args[:6], args[6])
    plain = k14.split_selection(k14.cluster_select_plain(*args).numpy(), n)
    np.testing.assert_array_equal(assign, plain[0])
    np.testing.assert_array_equal(found, plain[1])
    np.testing.assert_array_equal(weights, plain[2])
    if case == "every_row_founds":
        assert len(found) == n
    if case == "one_cluster":
        assert len(found) == 1
    if case == "r2_ties":
        r2 = [float(k14._cloud_r2(*(torch.as_tensor(x) for x in (
            np.stack([args[0][j].numpy().T.astype(np.float64)]),
            np.stack([args[2][j].numpy()]))), *(torch.as_tensor(x) for x in (
                args[0][2].numpy().T.astype(np.float64),
                args[2][2].numpy(), args[4].numpy(), args[5].numpy())))[0])
            for j in (0, 1)]
        assert r2[0] == r2[1] == 64.0 and list(found[:2]) == [0, 1]
        assert assign[2] == 0
    # ... and the candidates those of mad_tpu's filter_pairs
    rng = np.random.default_rng(0)
    hb = rng.integers(0, 112, len(t["repeat"])).astype(np.int32)
    lb = rng.integers(0, 112, len(t["repeat"])).astype(np.int32)
    want = jfilter(JTable(**t), hb, lb, JF(**fkw), n_samples)
    rep = t["repeat"][found]
    score = rep * weights.astype(np.float32)
    gate = (weights >= args[7]) & ~(rep.astype(np.float64) < args[8])
    order = [c for c in np.argsort(np.where(gate, -score, np.inf),
                                   kind="stable") if gate[c]]
    assert [(int(weights[c]), float(rep[c])) for c in order] == \
        [(w.weight, w.repeat) for w in want]
    for c, w in zip(order, want):
        np.testing.assert_array_equal(t["lo_coord"][found[c]], w.lo_coord)
        np.testing.assert_array_equal(t["hi_coord"][found[c]], w.hi_coord)


# -- K16 ---------------------------------------------------------------------

def _round(seed, S=3, C=6, N=50, B=300, P=2000):
    """One round's eligibility inputs: S earlier solutions, C lanes of N
    atoms (two rejected), a cloud from np.unique on a 0.5 A lattice with
    signed zeros, table rows on it plus rows off it and a NaN row."""
    rng = np.random.default_rng(seed)
    pts = np.round(rng.normal(size=(B, 3)) * 6) / 2
    pts[:8, 0] = 0.0
    pts[8:16, 0] = -0.0
    pts[16:20, 1] = -0.0
    cloud = np.unique(pts, axis=0)
    rows = cloud[rng.integers(0, len(cloud), P)].copy()
    flip = rows == 0.0
    rows[flip & (rng.random(rows.shape) < 0.5)] *= -1.0    # -0.0 <-> 0.0
    rows[:40] += 0.25                                       # off the cloud
    rows[40] = np.nan
    prev = rng.normal(size=(S, N, 3)) * 6
    coords = (rng.normal(size=(C, N, 3)) * 6).astype(np.float32)
    acc = np.ones(C)
    acc[[1, 4]] = 0.0
    t = lambda a: torch.as_tensor(a)
    return t(cloud), t(rows), t(prev), t(coords), t(acc)


def search_rows(rows, cloud, elig, prev, coords, acc, ad):
    """post_elig_rows' order of decision: (flags, the point each row took
    or -1)."""
    pts = cloud.numpy()
    atoms = k16._atoms(prev, coords, acc)
    flags, took = [], []
    for p in rows.numpy():
        lo, hi = 0, len(pts)
        while lo < hi:
            mid = (lo + hi) // 2
            q = pts[mid]
            if q[0] < p[0] or (q[0] == p[0] and (
                    q[1] < p[1] or (q[1] == p[1] and q[2] < p[2]))):
                lo = mid + 1
            else:
                hi = mid
        if lo < len(pts) and (pts[lo] == p).all():
            flags.append(int(elig[lo]))
            took.append(lo)
        else:
            d2 = k16._min_d2(torch.as_tensor(p[None]), atoms)
            flags.append(int(not bool(d2[0] < ad * ad)))
            took.append(-1)
    return torch.tensor(flags, dtype=torch.uint8), np.asarray(took)


def test_k16_row_search():
    for shuffled in (False, True):
        _row_search(shuffled)


def _row_search(shuffled):
    cloud, rows, prev, coords, acc = _round(1)
    if shuffled:
        cloud = cloud[np.random.default_rng(2).permutation(len(cloud))]
    ad = 1.5
    elig = k16.post_points_plain(cloud, prev, coords, acc, ad, 0,
                                 len(cloud))
    assert 0 < int(elig.sum()) < len(cloud)
    flags, took = search_rows(rows, cloud, elig, prev, coords, acc, ad)
    want = k16.post_rows_plain(rows, cloud, elig, prev, coords, acc, ad, 0,
                               len(rows))
    assert torch.equal(flags, want)
    linear = [int(np.flatnonzero((cloud.numpy() == p).all(axis=1))[0])
              if (cloud.numpy() == p).all(axis=1).any() else -1
              for p in rows.numpy()]
    missed = (took == -1) & (np.asarray(linear) >= 0)
    if shuffled:
        assert missed.sum() > 100                 # the fallback ran
    else:
        np.testing.assert_array_equal(took, linear)
        assert (took == -1).sum() == 41           # 40 off the cloud, NaN
        signed = (rows.numpy() == 0.0) & np.signbit(rows.numpy())
        assert signed.any(axis=1)[took >= 0].sum() > 50


def tiled_dedup(rmat, valid, S, dedup):
    """(accepted, slot) by csrc/post.cu's dedup_scan: 32 lanes a tile, a
    lane blocked by an earlier solution or accepted lane below dedup, the
    lowest unblocked valid lane of the tile accepted and the lanes below
    dedup of it dropped, then each merged lane's argmin over the accepted
    before it."""
    C = rmat.shape[0]
    acc, slot, lanes = np.zeros(C), np.full(C, -1.0), []
    for t0 in range(0, C, 32):
        tile = range(t0, min(C, t0 + 32))
        cand = [i for i in tile if valid[i] and not any(
            rmat[i, k] < dedup for k in list(range(S))
            + [S + j for j in lanes])]
        accepted = []
        while cand:
            k = cand.pop(0)
            accepted.append(k)
            cand = [i for i in cand if not rmat[i, S + k] < dedup]
        for i in tile:
            before = lanes + [j for j in accepted if j < i]
            if i in accepted:
                acc[i], slot[i] = 1.0, S + len(before)
            elif valid[i]:
                cols = list(range(S)) + [S + j for j in before]
                v = rmat[i, cols]
                ok = ~np.isnan(v)
                slot[i] = np.flatnonzero(ok)[np.argmin(v[ok])]
        lanes += accepted
    return acc, slot


def test_k16_dedup_tiles():
    """70 lanes (three tiles) near a few poses, 5 earlier solutions, two
    of them exactly as far from lane 0 (a tie that the first wins), failed
    and hitless lanes, a lane with a NaN coordinate (accepted: its RMSDs
    never win)."""
    rng = np.random.default_rng(4)
    S, C, N, n, dedup = 5, 70, 40, 25, 3.0
    base = np.round(rng.normal(size=(4, N, 3)) * 20).astype(np.float32)
    coords = base[rng.integers(0, 4, C)] + rng.normal(size=(C, N, 3)).astype(
        np.float32) * rng.choice([0.1, 3.0], size=(C, 1, 1)).astype(np.float32)
    coords[0] = base[0]
    idx = np.sort(rng.choice(N, n, replace=False))
    coords[9, idx[3], 1] = np.nan
    prev = base[rng.integers(0, 4, S)].astype(np.float64) + rng.normal(
        size=(S, N, 3)) * 3
    prev[0], prev[1] = base[0] + 1.0, base[0] - 1.0
    failed = rng.random(C) < 0.1
    failed[[0, 9]] = False
    counts = rng.integers(0, 4, C).astype(np.float64)
    counts[[0, 9]] = 2.0
    t = lambda a: torch.as_tensor(a)
    acc, slot = k16.post_dedup_plain(t(coords), t(failed), t(counts),
                                     t(prev), t(idx), dedup)
    new = t(coords).to(torch.float64)[:, idx]
    targets = torch.cat([t(prev)[:, idx], new])
    rmat = ((k16._d2(new[:, None], targets[None]).sum(dim=2) / n).sqrt()
            .numpy())
    got = tiled_dedup(rmat, ~failed & (counts > 0), S, dedup)
    np.testing.assert_array_equal(got[0], acc.numpy())
    np.testing.assert_array_equal(got[1], slot.numpy())
    assert rmat[0, 0] == rmat[0, 1] and slot[0] == 0
    assert np.isnan(rmat[9]).all() and acc[9] == 1
    assert 3 < int(acc.sum()) < 40 and (slot.numpy() >= S).sum() > 10


def test_k16_point_tiles():
    """Tiles of kPointTile points against runs of about kAtomChunk atoms
    (kernels/post.point_chunks), each run's least first, then the least
    over the runs, a rejected lane's atoms skipped; a NaN atom in a
    rejected lane is skipped with them, one in an accepted lane makes
    every point's least NaN (NaN propagates, as torch.amin's does) and
    every point eligible."""
    for lane, accepted in ((1, False), (0, True)):
        _point_tiles(lane, accepted)


def _point_tiles(nan_lane, accepted):
    cloud, _rows, prev, coords, acc = _round(3, S=2, C=5, N=700)
    coords[nan_lane, 7] = float("nan")
    assert bool(acc[nan_lane] != 0) == accepted
    ad, start, count = 1.0, 3, len(cloud) - 10
    S, C, N = prev.shape[0], coords.shape[0], coords.shape[1]
    chunks = k16.point_chunks(S + C, N)
    per = -(-(S + C) * N // chunks)
    assert chunks > 2 and per % N != 0       # runs straddle solutions
    every = torch.cat([prev.reshape(-1, 3), coords.to(torch.float64)
                       .reshape(-1, 3)])
    keep = torch.cat([torch.ones(S * N, dtype=torch.bool),
                      (acc != 0).repeat_interleave(N)])
    pts = cloud[start:start + count]
    part = torch.full((chunks, count), float("inf"), dtype=torch.float64)
    for c in range(chunks):
        sel = keep[c * per:(c + 1) * per]
        run = every[c * per:(c + 1) * per][sel]
        for t0 in range(0, count, POST["kPointTile"]):
            d2 = k16._d2(pts[t0:t0 + POST["kPointTile"], None], run[None])
            part[c, t0:t0 + POST["kPointTile"]] = torch.from_numpy(
                np.minimum.reduce(d2.numpy(), axis=1, initial=np.inf))
    best = torch.from_numpy(np.minimum.reduce(part.numpy(), axis=0))
    got = (~(best < ad * ad)).to(torch.uint8)
    want = k16.post_points_plain(cloud, prev, coords, acc, ad, start, count)
    assert torch.equal(got, want)
    if accepted:
        assert bool(best.isnan().all()) and int(want.sum()) == count
    else:
        assert not bool(best.isnan().any()) and 0 < int(want.sum()) < count


def test_k16_compaction_masks():
    """16 flags a thread counted as a bit mask, one block scan per 16 K
    rows, each thread's rows written at their positions below n_top, the
    chunks stopping once n_top are taken: a ragged tail with every row
    taken, and an early stop."""
    for P, n_top in ((3 * 16 * 1024 + 37, 40_000), (70_001, 600)):
        _compaction(P, n_top)


def _compaction(P, n_top):
    rng = np.random.default_rng(P)
    flags = ((rng.random(P) < 0.4)
             * rng.integers(1, 256, P)).astype(np.uint8)
    threads = POST["kCompact"]
    padded = np.zeros(-(-P // (16 * threads)) * 16 * threads, np.uint8)
    padded[:P] = flags
    out = np.full(n_top, -1.0)
    base, chunks = 0, 0
    for c, chunk in enumerate(padded.reshape(-1, threads, 16)):
        if base >= n_top:
            break
        chunks += 1
        masks = (chunk != 0) @ (1 << np.arange(16))
        counts = np.array([bin(int(m)).count("1") for m in masks])
        starts = base + np.cumsum(counts) - counts
        for th in range(threads):
            pos, m = int(starts[th]), int(masks[th])
            while m and pos < n_top:
                low = (m & -m).bit_length() - 1
                out[pos] = (c * threads + th) * 16 + low
                pos += 1
                m &= m - 1
        base += int(counts.sum())
    taken = min(base, n_top)
    want = k16.post_compact_plain(torch.as_tensor(flags), n_top).numpy()
    assert want[0] == taken
    np.testing.assert_array_equal(want[1:], out)
    assert chunks < len(padded) // (16 * threads) or n_top > base
