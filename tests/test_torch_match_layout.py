"""The orders of work of K13 (csrc/repeat.cu) and K10's head
(csrc/pairs.cu) as the card runs them, rendered in numpy on the CPU and
held equal to the direct forms, the plain versions (kernels/repeat.py,
kernels/pairs.py) and mad_tpu.

  * K13: the subunit anchors in groups of 32 (one a lane, the idle lanes
    of a pair's last group moving no anchor), the map cloud in tiles of
    kTile padded with +inf points to a multiple of kMinima, kMinima
    running minima a lane (fmin, which drops a NaN), hits counted a group
    at a time and summed over a pair's groups, the float32 quotient;
    equal bit for bit to one running minimum over every point in turn
    (the kernel's arithmetic, without FMA contraction), and equal to
    exact_repeat_plain and mad_tpu's _exact_repeat_body on every pair
    with no moved anchor within 1e-4 A of the radius, at 1, 32, 33 and
    400 subunit anchors, 1, 414 and kTile + 1 map anchors and 0, 1 and
    1,100 pairs.
  * K10's head: each row's radix select over the 64-bit keys, its first
    digit the kFirstBits bits below the highest bit where its survivors
    differ, later digits 8 bits, ending at a bin taken whole or at a bin
    of at most kFinish keys ranked among themselves, its run sorted into
    pow2(k) slots; then the global stage: the runs' least and greatest
    key, a sample of the slots in kFine bins of
    width 2^sh, buckets between the sample's quantiles, each bucket's
    keys found by two binary searches a run and its place by the keys
    below it, a bucket over the cap taken in halved pieces; equal to
    pair_head_plain and mad_tpu's _compiled_similarity, with ties at the
    k-th cosine (a row whose k-th lies among a hundred ties), rows with
    no or fewer than k survivors, a negative threshold, fewer keys kept
    than the runs hold, a row offset and buckets over their cap; and the
    mesh's merge (runs of kTile sorted, then the same stage) equal to
    pair_merge_plain and the whole table's head.
"""

import jax  # noqa: F401  (mad_tpu's match module imports it)
import numpy as np
import pytest
import torch

from mad_tpu.engine import match as jm
from mad_tpu_torch.kernels import build
from mad_tpu_torch.kernels import pairs as k10
from mad_tpu_torch.kernels import repeat as k13
from mad_tpu_torch.parallel.mesh import shard_bounds
from mad_tpu_torch.testing import repeat_inputs

torch.set_num_threads(1)

REP = build.constants("repeat.cu")
PAIRS = build.constants("pairs.cu")
RADIUS = 4.0
EDGE = 1e-4
NONE = (1 << 64) - 1


# -- K13 ---------------------------------------------------------------------

def _moved(hi_cloud, rot, hi, lo):
    """y = (x - h) @ R^T + l, each product and sum rounded to float32 in
    the kernel's order: ((x0 R_e0 + x1 R_e1) + x2 R_e2) + l_e."""
    x = hi_cloud[None] - hi[:, None]
    y = np.empty(x.shape, np.float32)
    for e in range(3):
        y[..., e] = ((x[..., 0] * rot[:, None, e, 0]
                      + x[..., 1] * rot[:, None, e, 1])
                     + x[..., 2] * rot[:, None, e, 2]) + lo[:, None, e]
    return y


def _dist(y, b):
    """(y - b)^2 summed over x, y, z in float32, term by term."""
    with np.errstate(invalid="ignore"):        # inf - inf: NaN, as on the card
        e = y[..., None, :] - b
    return (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
        + e[..., 2] * e[..., 2]


def _score(count, a_hi):
    return np.float32(100.0) * np.float32(count) / np.float32(max(a_hi, 1))


def direct_repeat(hi_cloud, lo_cloud, rot, hi, lo, thresh2, chunk=64):
    """One running fmin over the map points in turn, every anchor."""
    out = np.zeros(len(rot), np.float32)
    for s in range(0, len(rot), chunk):
        y = _moved(hi_cloud, rot[s:s + chunk], hi[s:s + chunk],
                   lo[s:s + chunk])
        dmin = np.full(y.shape[:2], np.inf, np.float32)
        for b in lo_cloud:
            dmin = np.fmin(dmin, _dist(y, b[None])[..., 0])
        out[s:s + chunk] = [_score(c, len(hi_cloud))
                            for c in (dmin < thresh2).sum(axis=1)]
    return out


def tiled_repeat(hi_cloud, lo_cloud, rot, hi, lo, thresh2, chunk=64):
    """csrc/repeat.cu's order: a warp a (pair, group of 32 anchors), the
    map cloud in padded tiles, kMinima minima a lane, ballot counts summed
    over the pair's groups."""
    a_hi, P = len(hi_cloud), len(rot)
    if a_hi == 0:
        return np.zeros(P, np.float32)
    G = -(-a_hi // 32)
    lanes = np.arange(G * 32)
    cloud = np.zeros((G * 32, 3), np.float32)     # idle lanes: y at rest
    cloud[:a_hi] = hi_cloud
    tile, mins = REP["kTile"], REP["kMinima"]
    out = np.zeros(P, np.float32)
    for s in range(0, P, chunk):
        y = _moved(cloud, rot[s:s + chunk], hi[s:s + chunk], lo[s:s + chunk])
        y[:, a_hi:] = 0.0
        m = np.full((mins,) + y.shape[:2], np.inf, np.float32)
        for t0 in range(0, len(lo_cloud), tile):
            pts = lo_cloud[t0:t0 + tile]
            pad = -len(pts) % mins
            pts = np.concatenate([pts, np.full((pad, 3), np.inf, np.float32)])
            for j in range(mins):
                d = _dist(y, pts[j::mins])
                m[j] = np.fmin(m[j], np.fmin.reduce(d, axis=-1,
                                                    initial=np.inf))
        dmin = np.fmin.reduce(m, axis=0)
        hit = (lanes < a_hi) & (dmin < thresh2)
        ballots = hit.reshape(hit.shape[0], G, 32).sum(axis=2)
        out[s:s + chunk] = [_score(c, a_hi) for c in ballots.sum(axis=1)]
    return out


def _near_radius(hi_cloud, lo_cloud, rot, hi, lo):
    y = np.einsum("pad,ped->pae", hi_cloud[None].astype(np.float64)
                  - hi[:, None], rot.astype(np.float64)) + lo[:, None]
    d = np.sqrt(((y[:, :, None] - lo_cloud.astype(np.float64)) ** 2)
                .sum(-1).min(-1))
    return (np.abs(d - RADIUS) < EDGE).any(axis=1)


def test_k13_groups_tiles_minima_and_ballots():
    t2 = np.float32(RADIUS) * np.float32(RADIUS)
    past = REP["kTile"] + 1
    for a_hi, a_lo, P in ((1, 1, 1), (1, past, 1100), (32, 414, 1100),
                          (33, past, 1), (33, 1, 0), (400, 414, 1),
                          (400, past, 3)):
        a = repeat_inputs(a_hi, a_lo, P, seed=a_hi + a_lo + P)
        got = tiled_repeat(*a, t2)
        assert np.array_equal(got.view(np.int32),
                              direct_repeat(*a, t2).view(np.int32))
        plain = k13.exact_repeat(*(torch.as_tensor(x) for x in a), RADIUS)
        assert plain.shape == (P,) and k13.launches == 0
        if P == 0:
            continue
        keep = ~_near_radius(*a)
        assert keep.sum() >= P - 2
        np.testing.assert_array_equal(got[keep], plain.numpy()[keep])
        ref = np.asarray(jm._exact_repeat_body(1, RADIUS)(
            a[0], np.ones(a_hi, bool), a[1], np.ones(a_lo, bool), *a[2:]))
        np.testing.assert_array_equal(got[keep], ref[keep])
        if P > 1 and a_hi > 1:
            assert 0.0 < got.mean() < 100.0


def test_k13_minima_drop_nan_and_infinite_points():
    """A NaN map point, a NaN anchor and infinite coordinates: the tiles'
    +inf padding and the minima's fmin give one running fmin's bits."""
    t2 = np.float32(16.0)
    a = list(repeat_inputs(40, REP["kTile"] + 9, 50, seed=4))
    a[1][[3, REP["kTile"] + 2]] = np.nan
    a[1][7] = [np.inf, 0.0, -np.inf]
    a[0][5] = np.nan
    a[0][6] = [np.inf, 1.0, 1.0]
    got = tiled_repeat(*a, t2)
    assert np.array_equal(got.view(np.int32),
                          direct_repeat(*a, t2).view(np.int32))
    assert got.max() > 0.0


# -- K10's head -------------------------------------------------------------

def _u64(t):
    return [int(x) & NONE for x in t.tolist()]


def row_run(keys, k, kp):
    """csrc/pairs.cu's row stage on one row's survivors' keys (ints): the
    taken keys sorted into kp slots, their count and the radix passes."""
    n, passes = len(keys), 0
    if n <= k:
        taken = keys
    else:
        arr = np.array(keys, np.uint64)
        all_and = int(np.bitwise_and.reduce(arr))
        all_or = int(np.bitwise_or.reduce(arr))
        top = (all_and ^ all_or).bit_length() - 1
        shift = max(top - (PAIRS["kFirstBits"] - 1), 0)
        width = top - shift + 1
        mask = 0 if top == 63 else (NONE << (top + 1)) & NONE
        prefix, need = all_and & mask, k
        while True:
            digit = (1 << width) - 1
            hist = np.bincount([(x >> shift) & digit for x in keys
                                if x & mask == prefix], minlength=digit + 1)
            cum = np.cumsum(hist)
            b = int(np.searchsorted(cum, need))
            need -= int(cum[b] - hist[b])
            prefix |= b << shift
            mask |= digit << shift
            passes += 1
            if hist[b] == need or shift == 0:
                break
            if hist[b] <= PAIRS["kFinish"]:     # the bin's keys ranked
                prefix = sorted(x for x in keys if x & mask == prefix)[
                    need - 1]
                mask = NONE
                break
            width = min(8, shift)
            shift -= width
        taken = [x for x in keys if x & mask <= prefix]
        assert len(taken) == k
    return sorted(taken) + [NONE] * (kp - len(taken)), len(taken), passes


def select_runs(slots, stride, L, cap):
    """csrc/pairs.cu's global stage over the slots (ints) of sorted runs of
    ``stride`` (~0 after each run's keys); also the pieces it took."""
    out, N = [NONE] * L, len(slots)
    runs = [[x for x in slots[r:r + stride] if x != NONE]
            for r in range(0, N, stride)]
    B = max(1, min(PAIRS["kMaxBuckets"], -(-N // PAIRS["kBucketKeys"])))
    real = [r for r in runs if r]
    if not real:
        return out, 0
    arrays = [np.array(r, np.uint64) for r in runs]
    lo, hi = min(r[0] for r in real), max(r[-1] for r in real)
    # equal-count buckets from a sample of every step-th slot in kFine bins
    F = PAIRS["kFine"]
    sh = max(0, (hi - lo).bit_length() - PAIRS["kFineBits"])
    step = N // PAIRS["kSamples"] if N > PAIRS["kSamples"] else 1
    fine = np.zeros(F, np.int64)
    for x in slots[::step]:
        if lo <= x <= hi:
            fine[(x - lo) >> sh] += 1
    cum = np.cumsum(fine)
    S, pieces, last = int(cum[-1]), 0, (hi - lo) >> sh
    for b in range(B):
        f0 = 0 if b == 0 else int(np.searchsorted(cum, S * b // B, "right"))
        f1 = F if b == B - 1 else int(np.searchsorted(cum, S * (b + 1) // B,
                                                      "right"))
        cur = lo + (f0 << sh)
        end = hi + 1 if f1 > last else lo + (f1 << sh)
        while f0 < f1 and f0 <= last and cur < end:
            upto = end
            while True:
                a = [int(np.searchsorted(r, np.uint64(cur))) for r in arrays]
                e = [int(np.searchsorted(r, np.uint64(upto)))
                     for r in arrays]
                off, c = sum(a), sum(e) - sum(a)
                if off >= L or c <= cap or upto - cur == 1:
                    break
                upto = cur + (upto - cur) // 2
            if off >= L:
                break
            got = sorted(x for r, p, q in zip(runs, a, e) for x in r[p:q])
            out[off:off + c] = got[:max(0, L - off)]
            pieces += 1
            cur = upto
    return out, pieces


def head_rendering(sim, row_cap, max_pairs, threshold, row0=0,
                   cap=PAIRS["kBucketCap"]):
    dh, dl = sim.shape
    k = min(row_cap, dl)
    kp = 1 << (k - 1).bit_length()
    L = k10.head_length(dh, dl, row_cap, max_pairs)
    slots, passes = [], []
    for r in range(dh):
        cols = torch.nonzero(sim[r] > threshold)[:, 0]
        keys = _u64(k10.pair_keys(sim[r, cols], torch.full_like(
            cols, row0 + r), cols, dl))
        run, _s, p = row_run(keys, k, kp)
        slots += run
        passes.append(p)
    out, pieces = select_runs(slots, kp, L, cap)
    keys = torch.tensor([x - (1 << 64) if x >> 63 else x for x in out],
                        dtype=torch.int64)
    return keys, passes, pieces


def _cosines(rng, dh, dl, levels):
    """Values in [-0.5, 1) on a grid of ``levels`` steps, so that many
    cosines tie exactly; row 1 has none above 0.6, row 2 three, row 3 a
    hundred at 0.9 and the rest at 0.8 (the k-th among many ties)."""
    s = (rng.integers(0, levels, (dh, dl)) / levels * 1.5 - 0.5).astype(
        np.float32)
    s[1] = -1.0
    s[2, :3] = 0.95
    s[2, 3:] = 0.1
    s[3] = 0.8
    s[3, :100] = 0.9
    return s


@pytest.mark.parametrize("dh,dl,row_cap,max_pairs,threshold,levels,row0", [
    (20, 300, 16, 150, 0.6, 64, 0),        # ties at the k-th, L < N
    (30, 700, 128, 65536, 0.6, 1 << 20, 0),  # every run kept
    (12, 40, 64, 400, -0.25, 64, 5),       # row_cap > dl, threshold < 0
    (40, 500, 32, 900, 0.6, 1 << 12, 9),   # L < N, offset rows
])
def test_k10_row_runs_and_global_stage(dh, dl, row_cap, max_pairs,
                                       threshold, levels, row0):
    S = _cosines(np.random.default_rng(dh + dl), dh, dl, levels)
    sim = torch.as_tensor(S)
    got, passes, _pieces = head_rendering(sim, row_cap, max_pairs,
                                          threshold, row0)
    assert torch.equal(got, k10.pair_head_plain(sim, row_cap, max_pairs,
                                                threshold, row0))
    assert min(passes) == 0
    assert max(passes) >= (2 if row_cap < dl else 0)   # row 3's ties
    gv, gr, gc, ok = jm._compiled_similarity(dh, dl, row_cap, max_pairs,
                                             threshold)(
        S, np.eye(dl, dtype=np.float32))
    ok = np.asarray(ok)
    ccs, rows, cols = k10.split_pair_keys(got.numpy(), dl)
    np.testing.assert_array_equal(ccs, np.asarray(gv)[ok])
    np.testing.assert_array_equal(rows, np.asarray(gr)[ok] + row0)
    np.testing.assert_array_equal(cols, np.asarray(gc)[ok])


def test_k10_buckets_over_shared_memory():
    """One cosine far above the others puts them all in one bucket of the
    sample's bins: taken in halved pieces of at most cap keys; and caps
    below the sampled buckets' sizes on spread cosines."""
    flat = np.full((12, 90), 0.7, np.float32)
    flat[0, 0] = 0.99
    flat[4, 10:20] = 0.8
    for sim, args, caps in (
            (flat, (64, 1 << 20, 0.6), (PAIRS["kBucketCap"], 100)),
            (_cosines(np.random.default_rng(2), 30, 300, 1 << 10),
             (64, 1500, 0.3), (PAIRS["kBucketCap"], 7))):
        sim = torch.as_tensor(sim)
        want = k10.pair_head_plain(sim, *args)
        for cap in caps:
            got, _p, pieces = head_rendering(sim, *args, cap=cap)
            assert torch.equal(got, want)
            if cap < PAIRS["kBucketCap"]:
                assert pieces > int((want != -1).sum()) // cap


def test_k10_mesh_merge_of_tiles():
    """The shards' heads concatenated, sorted in runs of kTile, then the
    global stage: pair_merge_plain's keys and the whole table's head."""
    rng = np.random.default_rng(3)
    sim = torch.as_tensor(_cosines(rng, 61, 200, 1 << 9))
    args = (40, 1000, 0.3)
    whole = k10.pair_head_plain(sim, *args)
    b = shard_bounds(sim.shape[0], 3)
    keys = torch.cat([k10.pair_head(sim[b[s]:b[s + 1]], *args, b[s])
                      for s in range(3)])
    assert k10.launches == 0 and k10.merge_launches == 0
    flat = _u64(keys)
    tile = 512                          # kTile's role at this size
    slots = [x for i in range(0, len(flat), tile)
             for x in sorted(flat[i:i + tile])]
    for L in (whole.numel(), 333):
        got, _p = select_runs(slots, tile, L, PAIRS["kBucketCap"])
        want = k10.pair_merge(keys, L)
        assert _u64(want) == got
        assert torch.equal(want, whole[:L])
