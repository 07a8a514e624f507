"""K13 (csrc/repeat.cu: a warp for each pair and group of 32 subunit
anchors) and K10's head (csrc/pairs.cu: sorted row heads, then one global
stage over buckets of equal key width) against their plain PyTorch
versions on the card. Every test here needs a CUDA card and skips without
one; the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_match_redesign_cuda.py

Tolerances: K13 equal on every pair with no moved anchor within 1e-4 A
of the radius in float64 (the kernel takes the distance directly, the
plain version by the |y|^2 + |b|^2 - 2 y.b expansion), at 1 to 400
subunit anchors (one group of 32 and several), 1 to 5,000 map anchors
(one shared tile and several) and 0 to 1,100 pairs; K10's head and its
merge equal (keys are unique and order the pairs exactly): ties at the
k-th cosine, rows with no or few survivors, a negative threshold, fewer
keys kept than the heads hold, a row offset, rows with more survivors
than shared memory holds and heads sorted in device memory, and a bucket
of the global stage too large for shared memory. Two launches give the
same bits, and the launch counters count each call's kernels (K13 one,
K10's head and merge two each). The plain versions are held against
mad_tpu on the CPU by tests/test_torch_match_heads.py,
tests/test_torch_match.py and tests/test_torch_match_layout.py.
"""

import numpy as np
import pytest
import torch

from mad_tpu_torch.kernels import build
from mad_tpu_torch.kernels import pairs as k10
from mad_tpu_torch.kernels import repeat as k13
from mad_tpu_torch.parallel.mesh import shard_bounds
from mad_tpu_torch.testing import repeat_inputs

pytestmark = pytest.mark.cuda

EDGE = 1e-4                 # A, K13's pairs at the radius
RADIUS = 4.0


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _repeat_inputs(a_hi, a_lo, P, seed, cuda):
    return tuple(torch.as_tensor(a, device=cuda)
                 for a in repeat_inputs(a_hi, a_lo, P, seed))


def _near_radius(hi_cloud, lo_cloud, rot, hi, lo, chunk=8):
    out = [torch.zeros(0, dtype=torch.bool, device=rot.device)]
    lc = lo_cloud.double()
    for s in range(0, rot.shape[0], chunk):
        y = torch.einsum("cad,ced->cae", hi_cloud.double()[None]
                         - hi[s:s + chunk, None].double(),
                         rot[s:s + chunk].double()) \
            + lo[s:s + chunk, None].double()
        d = ((y[:, :, None] - lc[None, None]) ** 2).sum(-1).amin(-1).sqrt()
        out.append(((d - RADIUS).abs() < EDGE).any(dim=1))
    return torch.cat(out)


def _k13(args):
    before = k13.launches
    got = k13.exact_repeat(*args, RADIUS)
    assert k13.launches == before + (1 if len(got) else 0)
    want = k13.exact_repeat_plain(*args, RADIUS)
    keep = ~_near_radius(*args)
    assert torch.equal(got[keep], want[keep])
    assert torch.equal(got.view(torch.int32),
                       k13.exact_repeat(*args, RADIUS).view(torch.int32))
    return got, keep


def test_k13_groups_tiles_and_pair_counts(cuda):
    """One anchor and one map point; one group of 32 and one past it; one
    tile and one past it; no pair, one, and 1,100."""
    for a_hi, a_lo, P in ((1, 1, 1), (1, 1025, 1100), (32, 414, 1100),
                          (33, 1025, 1), (33, 1, 40), (400, 414, 1),
                          (400, 1025, 30), (32, 414, 0)):
        args = _repeat_inputs(a_hi, a_lo, P, a_hi + a_lo + P, cuda)
        got, keep = _k13(args)
        assert got.shape == (P,) and int(keep.sum()) >= P - 2
    # no subunit anchor: every score 0, as 100 * 0 / max(A_hi, 1)
    args = _repeat_inputs(4, 50, 7, 4, cuda)
    got = k13.exact_repeat(args[0][:0], *args[1:], RADIUS)
    assert got.shape == (7,) and (got.view(torch.int32) == 0).all()


def test_k13_bench_and_stress_shapes(cuda):
    """The bench's 1,024 pairs of 32 x 414 anchors and the stress shape of
    400 x 5,000, whose groups and map tiles repeat; NaN anchors never
    hit."""
    for a_hi, a_lo in ((32, 414), (400, 5000)):
        args = _repeat_inputs(a_hi, a_lo, 1024, 7, cuda)
        got, keep = _k13(args)
        assert 0 < float(got.mean()) < 100
    hi_cloud = args[0].clone()
    hi_cloud[::2] = float("nan")
    got = k13.exact_repeat(hi_cloud, *args[1:], RADIUS)
    want = k13.exact_repeat_plain(hi_cloud, *args[1:], RADIUS)
    assert torch.equal(got[keep], want[keep]) and float(got.max()) <= 50.0


def _cosines(rng, dh, dl, levels):
    """Values in [-0.5, 1) on a grid of ``levels`` steps, so that many
    cosines tie exactly; row 3 has none above 0.6, row 5 seven, and row 6
    (where there is one) a hundred at 0.9 and the rest at 0.8, so that the
    k-th lies among many ties."""
    sim = torch.as_tensor(
        (rng.integers(0, levels, (dh, dl)) / levels * 1.5 - 0.5)
        .astype(np.float32))
    sim[3] = -1.0
    sim[5, :7] = 0.9
    sim[5, 7:] = 0.1
    if dh > 6:
        sim[6] = 0.8
        sim[6, :100] = 0.9
    return sim


def _k10(sim, row_cap, max_pairs, threshold, row0=0, rows=None):
    before = k10.launches
    got = k10.pair_head(sim, row_cap, max_pairs, threshold, row0, rows)
    assert k10.launches == before + 2
    want = k10.pair_head_plain(sim, row_cap, max_pairs, threshold, row0)
    assert torch.equal(got, want)
    assert torch.equal(got, k10.pair_head(sim, row_cap, max_pairs,
                                          threshold, row0, rows))
    return got


@pytest.mark.parametrize("dh,dl,row_cap,max_pairs,threshold,levels,row0", [
    (24, 16411, 128, 2000, 0.6, 97, 0),      # keeps fewer than the heads
    (300, 700, 128, 65536, 0.6, 1 << 20, 0),  # every head kept
    (50, 300, 500, 4000, -0.25, 64, 7),       # row_cap > dl, offset rows
    (366, 4588, 128, 65536, 0.6, 1 << 20, 0),  # the bench's shape
])
def test_k10_head(cuda, dh, dl, row_cap, max_pairs, threshold, levels,
                  row0):
    sim = _cosines(np.random.default_rng(dl), dh, dl, levels).to(cuda)
    got = _k10(sim, row_cap, max_pairs, threshold, row0, row0 + dh + 3)
    ccs, rows, _cols = k10.split_pair_keys(got.cpu().numpy(), dl)
    assert len(ccs) > 0 and (ccs > np.float32(threshold)).all()
    assert row0 + 3 not in set(rows.tolist())


def test_k10_head_past_shared_memory(cuda):
    """Rows with more survivors than shared memory keeps (read again for
    each pass) and more keys taken than it sorts (sorted in device
    memory); then one cosine far above the others, so that the others
    fill one bucket of the global stage beyond its shared memory."""
    pc = build.constants("pairs.cu")
    rng = np.random.default_rng(5)
    dl = pc["kRowCap"] + 5003
    sim = _cosines(rng, 6, dl, 1000).to(cuda)
    _k10(sim, 2 * pc["kSelCap"], 1 << 20, -0.25)
    _k10(sim, 100, 300, -0.25)
    flat = torch.full((40, 2 * pc["kBucketCap"] // 40 + 7), 0.7,
                      device=cuda)
    flat[0, 0] = 0.99
    got = _k10(flat, 1 << 12, 1 << 20, 0.6)
    assert int((got != -1).sum()) == flat.numel()


def test_k10_merge_of_shard_heads(cuda):
    """Shard heads with their row offsets, merged, are the whole table's
    head; the merge also on unsorted keys with -1 padding."""
    rng = np.random.default_rng(3)
    sim = _cosines(rng, 301, 900, 1 << 10).to(cuda)
    args = (150, 5000, 0.3)
    whole = _k10(sim, *args)
    for n in (3, 4):
        b = shard_bounds(sim.shape[0], n)
        keys = torch.cat([_k10(sim[b[s]:b[s + 1]], *args, b[s],
                               sim.shape[0]) for s in range(n)])
        before = k10.merge_launches
        got = k10.pair_merge(keys, whole.numel())
        assert k10.merge_launches == before + 2
        assert torch.equal(got, k10.pair_merge_plain(keys, whole.numel()))
        assert torch.equal(got, whole)
    keys = torch.as_tensor(rng.integers(-(1 << 62), 1 << 62, 20000),
                           device=cuda)
    keys[::3] = -1
    for L in (20000, 777, 0):
        assert torch.equal(k10.pair_merge(keys, L),
                           k10.pair_merge_plain(keys, L))
