"""K5 (csrc/localize.cu: a warp a peak walking on a window about its patch,
seeds and validity from K4's flat indices in the flat form, seeds given in
the offset form) and K22 (csrc/crop_pad.cu: the per-axis occupancy flags as
a stream of 16-byte loads) against their plain PyTorch versions on the
card. Every test here needs a CUDA card and skips without one; the file
imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_localize_flags_cuda.py

Tolerance: none, every output bit for bit (on the NaN volume the NaN
subvoxel coordinates are compared as NaN, their payloads aside). K5 at the
border ``eb``, at pos 0 (the far-face patch), at the upper face, with
``n_iter`` 0, on a singular Hessian, a NaN volume, values equal to the
threshold, no peak, and walks of several voxels in both forms (the offset
form on a block with ``goff`` > 0); K22 on views off 16-byte alignment
(``vol[1:]`` of a Z = 250 volume whose planes are not a multiple of 16
bytes, and flat views 1-3 values in), Z of 1-7 and 250, flag vectors
larger than 48 KB of shared memory, and the unreduced bench map. The
launch counters count one launch a call of each entry. The plain versions
are held against mad_tpu on the CPU by tests/test_torch_localize_flags.py.
"""

import numpy as np
import pytest
import torch

from mad_tpu_torch.kernels import crop_pad as k22
from mad_tpu_torch.kernels import localize as k5

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _same(a, b):
    """Equal bit for bit, NaN as NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a.masked_fill(nan, 0), b.masked_fill(nan, 0)
    ints = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def launched(fn, *args):
    before = k5.launches
    out = fn(*args)
    assert k5.launches == before + 1
    return out


def _smooth_noise(seed, shape):
    v = np.random.default_rng(seed).normal(size=shape)
    for ax in range(3):
        for _ in range(2):
            v = (np.roll(v, 1, ax) + 2 * v + np.roll(v, -1, ax)) / 4
    return v.astype(np.float32)


def _flat_case(vol, pts, vals, cuda):
    flat = np.ravel_multi_index(np.array(pts).T, vol.shape).astype(np.int64)
    return (torch.as_tensor(vol, device=cuda),
            torch.as_tensor(flat, device=cuda),
            torch.as_tensor(np.asarray(vals, np.float32), device=cuda))


def _check_both_forms(vol, flat, vals, real, thr, eb, mo=0.6, n_iter=5):
    args = (vol, flat, vals, real, thr, eb, mo, n_iter)
    got = launched(k5.localize_peaks, *args)
    assert all(_same(x, y) for x, y in zip(got, k5.localize_peaks_plain(
        *args)))
    walk = (vol, k5.flat_seeds(flat, vol.shape, real, eb), real, mo, n_iter)
    got2 = launched(k5.localize, *walk)
    assert all(_same(x, y) for x, y in zip(got2, k5.localize_plain(*walk)))
    assert _same(got[0], got2[0]) and _same(got[1], got2[1])
    return got


def test_k5_flat_form_at_the_faces(cuda):
    vol = _smooth_noise(1, (11, 9, 12))
    real = (10, 8, 12)
    pts = [(0, 0, 0), (0, 4, 6), (9, 7, 11), (10, 8, 11), (5, 1, 10),
           (2, 3, 4), (6, 5, 0), (1, 7, 5)]
    vals = np.linspace(0.01, 0.2, len(pts))
    vals[3] = np.float32(0.05)                 # equal to the threshold
    case = _flat_case(vol, pts, vals, cuda)
    for eb in (0, 1, 2):
        _check_both_forms(*case, real, 0.05, eb)
    pos, _sub, valid = _check_both_forms(*case, real, 0.05, 0, n_iter=0)
    assert not bool(valid.any())
    assert torch.equal(pos.cpu(), torch.as_tensor(np.minimum(
        pts, np.asarray(real) - 1)))


def test_k5_degenerate_inputs(cuda):
    """A flat volume (singular Hessian), a NaN volume, no peak."""
    pts = [(1, 4, 0), (3, 6, 3), (1, 3, 3), (0, 0, 7)]
    vals = [0.05, 0.05, 0.5, 0.049]
    for fill in (0.25, np.nan):
        vol = np.full((8, 9, 10), fill, np.float32)
        case = _flat_case(vol, pts, vals, cuda)
        _pos, sub, valid = _check_both_forms(*case, vol.shape, 0.05, 1)
        assert not bool(valid.any())
        assert bool(torch.isnan(sub).all()) == bool(np.isnan(fill))
    vol, flat, vals = case
    before = k5.launches
    got = k5.localize_peaks(vol, flat[:0], vals[:0], vol.shape, 0.05, 1, 0.6,
                            5)
    assert [tuple(t.shape) for t in got] == [(0, 3), (0, 3), (0,)]
    assert k5.launches == before              # no peak, no launch


def test_k5_long_walks_in_both_forms(cuda):
    """Seeds 2-5 voxels from a Gaussian peak (walks that leave the first
    window), and the offset form on a block of rows 4.. of the field."""
    n = 20
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    vol = np.exp(-((g - [9.7, 10.2, 9.4]) ** 2 / [60.0, 70.0, 65.0]).sum(-1))
    pts = [(7, 10, 9), (12, 12, 9), (9, 7, 12), (13, 13, 13), (6, 6, 6),
           (10, 10, 9), (1, 10, 9), (18, 2, 10)]
    case = _flat_case(vol.astype(np.float32), pts, [1.0] * len(pts), cuda)
    pos, _sub, valid = _check_both_forms(*case, (n,) * 3, 0.05, 1, n_iter=8)
    assert int(valid.sum()) >= 4
    assert int((pos.cpu() - torch.as_tensor(pts)).abs().amax()) >= 4
    seeds = torch.as_tensor([p for p in pts if 6 <= p[0] <= 14],
                            device=cuda)
    blk = case[0][4:17].contiguous()
    got = launched(k5.localize, blk, seeds, (n,) * 3, 0.6, 8, 4, n)
    ref = k5.localize_plain(blk, seeds, (n,) * 3, 0.6, 8, 4, n)
    assert all(_same(x, y) for x, y in zip(got, ref))
    assert int(got[2].sum()) >= 3


def test_k5_on_cpu_tensors_launches_nothing(cuda):
    vol = torch.as_tensor(_smooth_noise(2, (7, 8, 9)))
    flat = torch.tensor([100, 200], dtype=torch.int64)
    vals = torch.tensor([0.3, 0.01])
    before = k5.launches
    got = k5.localize_peaks(vol, flat, vals, vol.shape, 0.05, 1, 0.6, 5)
    assert all(_same(x, y) for x, y in zip(got, k5.localize_peaks_plain(
        vol, flat, vals, vol.shape, 0.05, 1, 0.6, 5)))
    assert k5.launches == before
    with pytest.raises(ValueError):
        k5.localize_peaks(vol.to(cuda), flat.to(cuda, torch.int32),
                          vals.to(cuda), vol.shape, 0.05, 1, 0.6, 5)
    with pytest.raises(ValueError):
        k5.localize_peaks(vol.to(cuda), flat.to(cuda), vals.to(cuda).double(),
                          vol.shape, 0.05, 1, 0.6, 5)


def _flag_cases(cuda):
    rng = np.random.default_rng(5)
    out = []
    for shape in ((40, 37, 250), (9, 11, 7), (6, 13, 5), (7, 5, 4),
                  (8, 9, 3), (5, 6, 2), (4, 7, 1)):
        v = (rng.random(shape) * (rng.random(shape) < 0.02)).astype(
            np.float32)
        v[tuple(n - 1 for n in shape)] = 1.0
        v[0, shape[1] // 2, 0] = np.nan
        v[shape[0] // 2, 0, shape[2] - 1] = -0.0
        out.append(torch.as_tensor(v, device=cuda))
    return out


def test_k22_views_off_alignment_and_small_z(cuda):
    before = k22.launches
    n = 0
    for vol in _flag_cases(cuda):
        X, Y, Z = vol.shape
        flat = vol.reshape(-1)
        views = [vol, vol[1:]] + [flat[k:k + (X - 1) * Y * Z].view(
            X - 1, Y, Z) for k in (1, 2, 3)]
        for v in views:
            assert _same(k22.axis_flags(v), k22.axis_flags_plain(v)), (
                tuple(v.shape), v.data_ptr() % 16)
            n += 1
    assert k22.launches == before + n
    # a single nonzero voxel at each corner, unaligned
    base = torch.zeros(5 * 6 * 250 + 3, device=cuda)
    for k in range(4):
        vol = base[k:k + 5 * 6 * 250].view(5, 6, 250)
        for corner in np.ndindex(2, 2, 2):
            vol.zero_()
            vol[tuple(c * (s - 1) for c, s in zip(corner, vol.shape))] = 2.0
            assert _same(k22.axis_flags(vol), k22.axis_flags_plain(vol))


def test_k22_flags_beyond_48_kb(cuda):
    """X + Y + Z flag bytes above the default shared memory of a block."""
    vol = torch.zeros((3, 2, 60000), device=cuda)
    vol[1, 1, 59999] = 1.0
    vol[2, 0, 123] = float("nan")
    vol[0, 0, 5] = -0.0
    assert _same(k22.axis_flags(vol), k22.axis_flags_plain(vol))


def test_k22_on_the_bench_map(cuda):
    import chip_smoke
    raw = chip_smoke.unreduced_map(cuda).data
    X, Y, Z = raw.shape
    for v in (raw, raw[1:], raw.reshape(-1)[1:1 + (X - 1) * Y * Z].view(
            X - 1, Y, Z)):
        assert _same(k22.axis_flags(v), k22.axis_flags_plain(v))
