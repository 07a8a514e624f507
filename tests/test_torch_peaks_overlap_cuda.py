"""K4 (csrc/peaks.cu, the threshold stream) and K18 (csrc/overlap.cu, the
tiled pack-and-count pass) against their plain PyTorch versions on the
card, bit for bit. Every test here needs a CUDA card and skips without
one; the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_peaks_overlap_cuda.py

K4 at ragged shapes: volumes of V mod 4 != 0 voxels and smaller than one
16-byte load, own rows starting off a 16-byte boundary, plateaus of equal
values (signed zeros among them), NaN neighbours (no peak, as
max_pool3d's NaN maximum says), more survivors than the first key
buffer, and the offset form (row0, rows, x0); its raw keys equal the plain
version's peaks' ``peak_keys_plain`` as a set. K18 at m = 2 (frame z 32),
16, 64, 80, 1,200 and 4,000 (the tile shrinks in depth, then in columns,
to fit shared memory), boxes on every face of the frame and an all-empty
solution: equal bit for bit, the same bits over five launches, one launch
a call. The plain versions' parity with mad_tpu is held on the CPU by
tests/test_torch_peaks_overlap.py.
"""

import numpy as np
import pytest
import torch

from mad_tpu_torch.kernels import overlap as k18
from mad_tpu_torch.kernels import peaks as k4

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _plateaus(shape, seed):
    """Values in steps of 0.5 (plateaus of equal values), signed zeros."""
    rng = np.random.default_rng(seed)
    v = (np.round(rng.normal(size=shape) * 2) / 2).astype(np.float32)
    v[v == 0] = np.where(rng.random(int(np.sum(v == 0))) < 0.5,
                         np.float32(0.0), np.float32(-0.0))
    return torch.tensor(v)


def _same(got, want):
    return (torch.equal(got[1].cpu(), want[1])
            and torch.equal(got[0].cpu().view(torch.int32),
                            want[0].view(torch.int32)))


def _launched(fn, *args):
    before = k4.launches
    out = fn(*args)
    assert k4.launches > before
    return out


def test_k4_ragged_whole_volume(cuda):
    """V mod 4 != 0, volumes below one float4, plateaus; thresholds above
    and below zero, a border and none, capacity cuts."""
    for shape in ((37, 29, 31), (2, 1, 3), (1, 1, 1), (5, 3, 2),
                  (64, 65, 63)):
        vol = _plateaus(shape, sum(shape))
        dev = vol.to(cuda)
        for thr, border, cap in ((0.1, 2, 50), (-0.6, 0, 10 ** 6),
                                 (-1.1, 1, 7)):
            args = (shape, thr, border, cap)
            assert _same(_launched(k4.peak_topk, dev, *args),
                         k4.peak_topk_plain(vol, *args)), (shape, thr)


def test_k4_nan_neighbours(cuda):
    """A NaN in a voxel's neighbourhood makes the plain version's max NaN
    (max_pool3d, as mad_tpu's reduce_window), so the voxel is no peak;
    the kernel agrees, whole volume and offset form."""
    vol = _plateaus((37, 29, 31), 11)
    flat = vol.view(-1)
    flat[torch.randperm(flat.numel(), generator=torch.Generator()
                        .manual_seed(3))[:60]] = float("nan")
    dev = vol.to(cuda)
    for args in (((37, 29, 31), 0.1, 1, 10 ** 6),
                 ((57, 29, 31), -0.6, 0, 500, 3, 20, 17)):
        got = _launched(k4.peak_topk, dev, *args)
        want = k4.peak_topk_plain(vol, *args)
        assert _same(got, want), args
    plain_all = k4.peak_topk_plain(torch.nan_to_num(vol, nan=-9.0),
                                   (37, 29, 31), 0.1, 1, 10 ** 6)
    assert len(want[1]) < len(plain_all[1])     # NaN removed peaks


def test_k4_offset_form_off_a_16_byte_boundary(cuda):
    """Y * Z = 899 floats: own row r starts 4 * r bytes off a 16-byte
    boundary for odd r; the halo rows feed only the neighbourhood."""
    vol = _plateaus((37, 29, 31), 7)
    dev = vol.to(cuda)
    for row0, rows, x0 in ((1, 20, 17), (3, 1, 0), (0, 37, 5), (5, 0, 9),
                           (36, 1, 2)):
        real = (x0 + 40, 27, 30)
        for thr, border, cap in ((0.1, 2, 40), (-0.6, 1, 10 ** 6)):
            args = (real, thr, border, cap, row0, rows, x0)
            assert _same(_launched(k4.peak_topk, dev, *args),
                         k4.peak_topk_plain(vol, *args)), (row0, rows, thr)


def test_k4_keys_past_the_first_buffer_in_the_offset_form(cuda,
                                                          monkeypatch):
    """A lattice of equal peaks (a plateau value repeated) with more
    survivors than _FIRST_CAPACITY: the counter counts them all, the first
    pass writes only its buffer, the rerun writes every key, and the keys
    are the plain version's peaks' keys; with a candidate buffer too small
    for the stream's warps, one more rerun gives the same."""
    vol = torch.zeros((70, 130, 131))
    vol[1::2, 1::2, 1::2] = 1.0
    vol[1::4, 1::2, 1::2] = 2.0
    row0, rows, x0 = 3, 65, 11
    real = (200, 130, 131)
    args = (real, 0.5, 0, 10 ** 6, row0, rows, x0)
    want = k4.peak_topk_plain(vol, *args)
    n = len(want[1])
    assert n > k4._FIRST_CAPACITY
    dev = vol.to(cuda)
    before = k4.launches
    assert _same(k4.peak_topk(dev, *args), want)
    assert k4.launches == before + 2
    monkeypatch.setattr(k4, "_FIRST_CANDIDATES", 20_000)
    assert _same(k4.peak_topk(dev, *args), want)
    assert k4.launches == before + 5
    monkeypatch.undo()
    counter = torch.empty(3, dtype=torch.int32, device=cuda)
    cand = torch.empty(k4._FIRST_CANDIDATES, dtype=torch.int32, device=cuda)
    top = (torch.empty(8, device=cuda),
           torch.empty(8, dtype=torch.int64, device=cuda))
    for cap in (1000, n):
        keys = torch.full((cap,), -1, dtype=torch.int64, device=cuda)
        k4.compact(dev, real, 0.5, 0, row0, rows, x0, keys, cand, counter,
                   *top)
        got_n, most, warps = counter.tolist()
        assert got_n == n and most <= k4.candidate_room(len(cand), warps)
        Y, Z = vol.shape[1:]
        all_keys = k4.peak_keys_plain(want[0], want[1] - x0 * Y * Z)
        got = keys.cpu()
        assert bool(torch.isin(got, all_keys).all())
        assert len(torch.unique(got)) == cap
    assert torch.equal(torch.sort(got).values, torch.sort(all_keys).values)


def _frame_boxes(m, box, frame, seed):
    """m boxes of extent ``box`` in ``frame``: the first six on the six
    faces, the others anywhere; solution 3 (when m > 3) all empty; about
    half of every other box occupied."""
    rng = np.random.default_rng(seed)
    hi = np.array(frame) - np.array(box)
    off = np.stack([rng.integers(0, h + 1, m) for h in hi], axis=1)
    for f in range(min(m, 6)):
        off[f, f // 2] = 0 if f % 2 == 0 else hi[f // 2]
    dens = rng.normal(size=(m,) + box).astype(np.float32)
    if m > 3:
        dens[3] = -np.abs(dens[3])
    k18.check_frame(off, box, frame)
    return torch.tensor(dens), torch.tensor(off.astype(np.int32))


def _held(m, box, frame, cuda):
    """K18 on _frame_boxes against the plain version on the card, bit for
    bit, five launches."""
    dens, off = _frame_boxes(m, box, frame, m)
    dd, do = dens.to(cuda), off.to(cuda)
    want = k18.pack_overlap_plain(dd, do, frame).cpu()
    before = k18.launches
    runs = [k18.pack_overlap(dd, do, frame) for _ in range(5)]
    assert k18.launches == before + 5
    for got in runs:
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    assert float(want.max()) > 0
    if m > 3:
        assert not want[3].any() and not want[:, 3].any()


@pytest.mark.parametrize("m,box,frame", [
    (2, (30, 28, 20), (41, 37, 32)),
    (16, (40, 36, 44), (70, 66, 96)),
    (64, (24, 20, 30), (60, 52, 64)),
    (80, (30, 26, 34), (71, 63, 96))])
def test_k18_tiles(cuda, m, box, frame):
    _held(m, box, frame, cuda)


def test_k18_tile_shrinks_for_many_solutions(cuda):
    """1,200 solutions: the tile's depth halves to fit shared memory;
    4,000: its columns drop to 1 x 4."""
    _held(1200, (6, 5, 8), (25, 22, 256), cuda)
    _held(4000, (4, 4, 6), (20, 18, 32), cuda)
