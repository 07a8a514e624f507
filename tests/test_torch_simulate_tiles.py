"""K9's voxel tiles and the simulation body's order on the CPU; K19 and
K20 from K18's overlap.

* A torch / numpy rendering of ``csrc/scatter.cu``'s order must equal
  ``scatter_atoms_plain`` bit for bit: atoms binned by voxel tile of their
  shifted floor cell (one count a bin, the fill in any order), each tile's
  candidates taken from its own and its upper neighbours' bins, sorted by
  (local cell, atom index), the crowded tiles (more candidates than
  shared memory holds) in a pool whose size bounds them all, then per
  voxel the cells v - corner in corner order, each cell's atoms in order.
  The inputs put atoms on every face and tile boundary, outside the box,
  thousands on one cell, with zero, negative and NaN masses. NaN voxels
  compare as NaN (the payload is the CPU's), the rest bit for bit.
* The order-free max (order keys, :mod:`mad_tpu_torch.kernels.maxkey`)
  equals ``torch.amax``: bit for bit, except that where +0.0 and -0.0 mix
  the two compare equal (torch.amax keeps whichever its order meets).
* The body in the kernels' order on the CPU (the wrappers' CPU forms of
  K9 with its max, K1's blur with its divide and max epilogues, the
  scale-and-clamp) equals ``simulate_batch_plain`` bit for bit, with and
  without the isovalue; ``simulate_batch_plain`` stays within
  test_torch_scatter_order.py's tolerance (1e-5 of the volume's max) of
  mad_tpu's ``_compiled_simulate`` and ``_compiled_batched_simulate``.
* K19 and K20's plain heads from (ov, t) give the keys of the old
  staging (sym = ov[:t, :t] + its transpose, then the head), computed here
  by brute force.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from mad_tpu.ops import simulate as jsim
from mad_tpu.testing import make_assembly
from mad_tpu_torch.kernels import build, conv1d, hetero, maxkey, scatter
from mad_tpu_torch.kernels import enumerate as k_enum
from mad_tpu_torch.ops import simulate as tsim

torch.set_num_threads(1)

REL = 1e-5
MARGIN, VOXSP = 2, 1.4
BOX = (19, 17, 70)            # 3 x 3 x 3 tiles of 8 x 8 x 32, ragged
CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def atoms(seed=0, M=2, N=6000):
    """Atoms over and beyond the box: on the low and high faces and on
    tile boundaries (cells -1, dim - 1, multiples of the tile), 2,500 on
    one cell, masses zero (one in nine), negative (one in seven) and a
    few NaN."""
    rng = np.random.default_rng(seed)
    span = np.asarray(BOX) * VOXSP
    c = rng.uniform(-3 * VOXSP, span + 2 * VOXSP,
                    size=(M, N, 3)).astype(np.float32)
    vm = rng.uniform(-1.0, 1.0, size=(M, 3)).astype(np.float32)
    # g = margin + (c - vm) / voxsp lands at these floor cells, a
    # quarter voxel in
    cells = np.array([-1, 0, 7, 8, 15, 16, 31, 32, 63, 64])
    for s in range(M):
        for a in range(3):
            pick = rng.choice(cells[cells <= BOX[a] - 1], size=N // 3)
            c[s, : N // 3, a] = (vm[s, a] + (pick + 0.25 - MARGIN) * VOXSP
                                 ).astype(np.float32)
    c[:, N // 3: N // 3 + 2500] = c[:, :1] + np.float32(0.1)
    m = rng.uniform(0.5, 16.0, size=(M, N)).astype(np.float32)
    m[:, ::7] *= -1.0
    m[:, ::9] = 0.0
    m[:, 5:N:997] = np.nan
    return c, m, vm


def positions(c, vm):
    g = MARGIN + (c - vm[:, None, :]) / np.float32(VOXSP)
    g0 = np.floor(g)
    return g0, g - g0


def tile_order(c, m, vm, box=BOX, cap=scatter.TILE_CAP, seed=0):
    """The kernel's order in numpy; returns (grids, crowded tiles, pool
    keys used)."""
    M, N = m.shape
    T = np.asarray(scatter.TILE)
    dims = np.asarray(box)
    g0, w1 = positions(c, vm)
    with np.errstate(invalid="ignore"):
        keep = (m != 0) & ((g0 >= -1) & (g0 <= dims - 1)).all(-1)
    cell = np.where(keep[..., None], g0 + 1, 0).astype(np.int64)  # [0, dim]
    tiles = -(-dims // T)
    nb = tiles + 1
    b3 = cell // T
    bins = ((np.arange(M)[:, None] * nb[0] + b3[..., 0]) * nb[1]
            + b3[..., 1]) * nb[2] + b3[..., 2]
    # count and fill: the slots in whatever order the atomics give (here a
    # seeded shuffle)
    t_all = np.arange(M * N).reshape(M, N)[keep]
    b_all = bins[keep]
    perm = np.random.default_rng(seed).permutation(len(t_all))
    order = np.argsort(b_all[perm], kind="stable")
    ids, id_bin = t_all[perm][order], b_all[perm][order]
    counts = np.bincount(id_bin, minlength=M * int(nb.prod()))
    start = np.concatenate([[0], np.cumsum(counts)])
    cflat = cell.reshape(M * N, 3)
    wflat = w1.reshape(M * N, 3)
    mflat = m.reshape(M * N)
    grids = np.zeros((M,) + tuple(box), np.float32)
    C = T + 1
    crowded, pool_used = 0, 0
    for s in range(M):
        for tx, ty, tz in itertools.product(*[range(t) for t in tiles]):
            o = np.asarray([tx, ty, tz]) * T
            cand = []
            for i, j, k in itertools.product((0, 1), repeat=3):
                b = ((s * nb[0] + tx + i) * nb[1] + ty + j) * nb[2] + tz + k
                cand.append(ids[start[b]:start[b + 1]])
            cand = np.concatenate(cand)
            loc = cflat[cand] - o
            inside = ((loc >= 0) & (loc <= T)).all(-1)
            cand, loc = cand[inside], loc[inside]
            n = len(cand)
            if n > cap:
                crowded += 1
                pool_used += 1 << max(0, (n - 1).bit_length())
            lc = (loc[:, 0] * C[1] + loc[:, 1]) * C[2] + loc[:, 2]
            keys = np.sort((lc.astype(np.uint64) << np.uint64(32))
                           | cand.astype(np.uint64))
            st_t = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
            cstart = np.searchsorted((keys >> np.uint64(32)).astype(np.int64),
                                     np.arange(int(C.prod()) + 1))
            hi = np.minimum(o + T, dims)
            vox = np.stack(np.meshgrid(*[np.arange(a, b) for a, b in
                                         zip(o, hi)], indexing="ij"),
                           -1).reshape(-1, 3)
            flat = np.ravel_multi_index(tuple(vox.T), box)
            out = np.zeros(len(vox), np.float32)
            for corner in CORNERS:
                lv = vox - o + 1 - np.asarray(corner)
                cc = (lv[:, 0] * C[1] + lv[:, 1]) * C[2] + lv[:, 2]
                cnt = cstart[cc + 1] - cstart[cc]
                at = np.repeat(np.arange(len(vox)), cnt)
                k = (np.repeat(cstart[cc], cnt)
                     + np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt,
                                                        cnt))
                t = st_t[k]
                w = mflat[t]
                for a, d in enumerate(corner):
                    w = w * (wflat[t, a] if d
                             else np.float32(1.0) - wflat[t, a])
                # np.add.at adds in order: each voxel's terms, corner by
                # corner, each cell's atoms ascending
                np.add.at(out, at, w.astype(np.float32))
            grids[s].reshape(-1)[flat] = out
    return grids, crowded, pool_used


def same_bits_nan(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return (a.shape == b.shape and np.array_equal(nan, np.isnan(b))
            and np.array_equal(a[~nan].view(np.int32),
                               b[~nan].view(np.int32)))


@pytest.mark.parametrize("cap", [scatter.TILE_CAP, 16])
def test_tile_order_is_the_plain_order(cap):
    """The kernel's shared-memory capacity, then a capacity of 16 that
    sends most tiles with atoms to the pool: the same bits."""
    c, m, vm = atoms()
    got, crowded, pool_used = tile_order(c, m, vm, cap=cap)
    ref = scatter.scatter_atoms_plain(torch.as_tensor(c), torch.as_tensor(m),
                                      torch.as_tensor(vm), BOX, MARGIN,
                                      VOXSP).numpy()
    assert same_bits_nan(got, ref)
    assert np.isnan(ref).any() and (ref < 0).any()
    assert crowded >= (2 if cap == scatter.TILE_CAP else 20)
    assert pool_used <= scatter.POOL_PER_ATOM * m.size


def test_order_free_max_is_amax():
    rng = np.random.default_rng(3)
    cases = [rng.normal(size=(3, 500)).astype(np.float32),
             -rng.random((2, 300)).astype(np.float32) - 1.0,
             np.full((2, 64), -0.0, np.float32),
             np.zeros((1, 64), np.float32),
             np.array([[-0.0, 0.0, -1.0], [0.0, -0.0, -5.0]], np.float32),
             np.array([[1.0, np.nan, 2.0], [-np.inf, -np.nan, -3.0],
                       [np.inf, -7.0, 3.0]], np.float32)]
    for x in cases:
        t = torch.as_tensor(x)
        want = torch.amax(t, dim=1)
        # merged in three chunks, in two orders: the same keys
        keys = [maxkey.new_keys(x.shape[0], "cpu") for _ in range(2)]
        parts = torch.tensor_split(t, 3, dim=1)
        for p in parts:
            maxkey.merge_(keys[0], p)
        for p in reversed(parts):
            maxkey.merge_(keys[1], p)
        assert torch.equal(keys[0], keys[1])
        got = maxkey.values(keys[0])
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(got[ok], want[ok])
        zero = t == 0
        mixed = ((zero & t.signbit()).any(dim=1)
                 & (zero & ~t.signbit()).any(dim=1) & (want == 0))
        plain = ok & ~mixed
        assert torch.equal(got[plain].view(torch.int32),
                           want[plain].view(torch.int32))
        if torch.isnan(want).any():
            assert got[torch.isnan(got)].view(torch.int32).eq(
                0x7FC00000).all()
    assert maxkey.values(maxkey.merge_(maxkey.new_keys(1, "cpu"), torch.full(
        (1, 8), -0.0))).view(torch.int32).item() == -2 ** 31
    assert torch.equal(maxkey.divisors(maxkey.merge_(
        maxkey.new_keys(2, "cpu"), torch.tensor([[0.0, -0.0], [-3.0, -1.0]]))),
        torch.full((2,), 1e-30))


def _batch(seed=9, M=3, N=200):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0.0, 20.0, size=(M, N, 3)).astype(np.float32)
    masses = rng.uniform(1.0, 16.0, size=(M, N)).astype(np.float32)
    masses[1, ::5] *= -1.0
    return coords, masses


def test_the_kernels_order_of_the_body_is_the_plain_body():
    """The CUDA path's sequence with the wrappers' CPU forms: K9 with the
    grids' maxima, the x pass dividing its inputs, the z pass taking the
    blurred maxima, the scale-and-clamp pass."""
    coords, masses = _batch()
    args = tsim.scatter_args(coords, masses, 2.0, "cpu")
    taps = tsim._blur_taps(8.0 / (math.pi * math.sqrt(2.0)) / 2.0, 3)
    for iso in (0.0, 0.05, 0.3):
        want = tsim.simulate_batch_plain(*args, taps, iso)
        M = masses.shape[0]
        gmax, dmax = maxkey.new_keys(2 * M, "cpu").split(M)
        grids = scatter.scatter_atoms(*args, max_into=gmax)
        assert torch.equal(maxkey.values(gmax), grids.amax(dim=(1, 2, 3)))
        dens = conv1d.conv1d_along(grids, taps, 0, "full", divide_by=gmax)
        dens = conv1d.conv1d_along(dens, taps, 1, "full")
        dens = conv1d.conv1d_along(dens, taps, 2, "full", max_into=dmax)
        got = scatter.scale_clamp(dens, dmax, iso)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(tsim._simulate_batch(*args, taps, iso), want)
        if iso:
            assert (want == 0).any() and (want[want > 0] >= iso).all()


def test_simulate_batch_plain_stays_close_to_mad_tpu():
    _sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([x.coords for x in copies])
    masses = np.concatenate([x.masses for x in copies])
    plan = tsim.plan_simulation(coords, 8.0, 2.0, 0.1)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))[None]
    t = tsim.simulate_batch_plain(
        f32(coords), f32(masses), f32(plan.vox_min), plan.box, plan.margin,
        plan.voxsp, tsim._blur_taps(plan.sigma, plan.radius), 0.1)[0]
    j = jsim._compiled_simulate(plan.box, plan.margin, plan.radius,
                                plan.sigma, plan.voxsp, 0.1)(
        coords, masses, np.asarray(plan.vox_min, np.float32))
    _close(t, j)
    b = np.stack([copies[0].coords + np.float32(d) for d in (0.0, 3.1, -2.2)])
    bm = np.tile(copies[0].masses, (3, 1))
    mins, box, margin = tsim._batch_plan(b, 1.4, 16)
    sigma = 10.0 / (math.pi * math.sqrt(2.0)) / 1.4
    radius = int(math.ceil(3.0 * sigma))
    t = tsim.simulate_batch_plain(*tsim.scatter_args(b, bm, 1.4, "cpu"),
                                  tsim._blur_taps(sigma, radius), 0.0)
    j = jsim._compiled_batched_simulate(3, b.shape[1], box, margin, radius,
                                        sigma, 1.4, 0.0)(
        b, bm, mins.astype(np.float32))
    _close(t, j)


def _close(got, ref):
    got = got.detach().cpu().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= REL * scale


def _brute_keys(scores):
    s = np.maximum(np.asarray(scores, np.float32), np.float32(0.0))
    keys = (s.view(np.uint32).astype(np.int64) << 32) | np.arange(len(s))
    return np.sort(keys)


def test_heads_read_the_overlap():
    """K19 on the first t of n solutions and K20 over all n: the plain
    heads from K18's (n, n) upper-triangular overlap equal the brute-force
    heads of sym = ov[:t, :t] + ov[:t, :t].T."""
    rng = np.random.default_rng(17)
    n, t, k, head = 15, 12, 4, 64
    ov = np.triu(rng.random((n, n)) * 0.3, k=1).astype(np.float32)
    sym = (ov[:t, :t].astype(np.float64) + ov[:t, :t].T).astype(np.float32)
    combos = list(itertools.combinations(range(t), k))   # rank order
    scores = [max(sym[a, b] for a, b in itertools.combinations(cb, 2))
              for cb in combos]
    tab = torch.as_tensor(k_enum.comb_table(t, k))
    got = k_enum.enumerate_head(torch.as_tensor(ov), tab, head)
    assert np.array_equal(got.numpy(), _brute_keys(scores)[:head])
    assert torch.equal(k_enum.sym_trim_plain(torch.as_tensor(ov), t),
                       torch.as_tensor(sym))
    sizes = [5, 4, 6]
    lists = np.zeros((3, 6), np.int32)
    perm = rng.permutation(n)
    for g, (a, z) in enumerate(zip(np.cumsum([0] + sizes[:-1]),
                                   np.cumsum(sizes))):
        lists[g, : sizes[g]] = perm[a:z]
    full = (ov.astype(np.float64) + ov.T).astype(np.float32)
    sums = []
    for tup in itertools.product(*[range(s) for s in sizes]):
        glob = [lists[g, i] for g, i in enumerate(tup)]
        acc = np.float32(0.0)
        for i0, i1 in itertools.combinations(range(3), 2):
            acc = np.float32(acc + full[glob[i0], glob[i1]])
        sums.append(acc)
    got = hetero.hetero_head(torch.as_tensor(ov), torch.as_tensor(lists),
                             sizes, head)
    assert np.array_equal(got.numpy(), _brute_keys(sums)[:head])


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")
    monkeypatch.setattr(build, "library", no_library)
    counters = ("launches", "divide_launches", "max_launches")
    before = ([getattr(conv1d, c) for c in counters],
              scatter.launches, scatter.scale_launches)
    coords, masses = _batch(seed=4, M=2, N=50)
    dens, _origins = tsim.batched_simulate(coords, masses, 8.0, 2.0, "cpu",
                                           isovalue=0.1)
    keys = maxkey.new_keys(2, "cpu")
    scatter.scatter_atoms(*tsim.scatter_args(coords, masses, 2.0, "cpu"),
                          max_into=keys)
    conv1d.conv1d_along(dens, np.ones(3, np.float32), 0, "full",
                        divide_by=keys, max_into=keys)
    scatter.scale_clamp(dens, keys, 0.2)
    ov = torch.triu(torch.rand(9, 9), diagonal=1)
    k_enum.enumerate_head(ov, torch.as_tensor(k_enum.comb_table(9, 3)), 8)
    hetero.hetero_head(ov, torch.arange(9, dtype=torch.int32).reshape(3, 3),
                       [3, 3, 3], 8)
    assert before == ([getattr(conv1d, c) for c in counters],
                      scatter.launches, scatter.scale_launches)
    assert k_enum.launches == 0 and hetero.launches == 0


def test_scratch_is_sized_to_tiles_and_atoms():
    """The bench models' batch (10 x 10,400 atoms into 288 x 256 x 288):
    one count a tile, some 32 bytes an atom and the pool, against the
    215 M cells of a count per floor cell."""
    M, N, box = 10, 10400, (288, 256, 288)
    sizes = scatter.scratch_sizes(M, N, box)
    cells = M * (box[0] + 1) * (box[1] + 1) * (box[2] + 1)
    tiles = M * math.prod(-(-d // t) for d, t in zip(box, scatter.TILE))
    assert sizes["counts"] == M * math.prod(
        -(-d // t) + 1 for d, t in zip(box, scatter.TILE)) + 1
    assert sizes["counts"] < 2 * tiles and cells > 1000 * sizes["counts"]
    assert sizes["pool"] == scatter.POOL_PER_ATOM * M * N + 1
    nbytes = sum(n * scatter._ITEM_BYTES[k] for k, n in sizes.items())
    assert nbytes < 20 * 2 ** 20 < 4 * cells
