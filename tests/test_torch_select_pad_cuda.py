"""K21 (csrc/select_exact.cu: one launch, each CTA of a cluster selecting
its chunk's head and the first joining them; three launches above its
size), K22 and K23 (csrc/crop_pad.cu: the per-axis occupancy
flags; the crop and zero re-pad) against their plain PyTorch versions on
the card. Every test here needs a CUDA card and skips without one; the
file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_select_pad_cuda.py

Tolerance: none, every output bit for bit. K21 on repeatabilities with
ties at the n_use-th key, zeros of both signs, NaN and -inf, from one row
to the bench's 46,848 at n_use 1,024, and at n_use = P = 60,000 (more keys
than one block's shared memory holds); K22 on empty, one-voxel and odd
volumes with NaN (occupied) and -0.0 (not); K23 at odd boxes, offsets and
pads, outputs whose size is not a multiple of four; ``reduce_void`` and
``prepare`` on the card equal to the CPU's. The launch counters count
each call's kernels (K21 one at the test's size, K22 and K23 one). The
plain versions are held against mad_tpu on the CPU by
tests/test_torch_select_pad.py.
"""

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import ScaleSpaceConfig
from mad_tpu_torch.core.grid import DensityGrid
from mad_tpu_torch.kernels import crop_pad as k23
from mad_tpu_torch.kernels import select_exact as k21
from mad_tpu_torch.ops.scalespace import prepare

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _same(a, b):
    ints = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints).cpu(), b.contiguous().view(ints).cpu())


def _k21_inputs(P, seed, cuda):
    rng = np.random.default_rng(seed)
    rep = (rng.integers(0, 40, P) * 2.5).astype(np.float32)
    for value, share in ((0.0, 0.1), (-0.0, 0.1), (np.nan, 0.02),
                         (-np.inf, 0.02), (np.inf, 0.001)):
        rep[rng.random(P) < share] = value
    return [torch.as_tensor(a, device=cuda) for a in (
        rep, rng.normal(size=(P, 3, 3)).astype(np.float32),
        rng.normal(size=(P, 3)).astype(np.float32),
        rng.normal(size=(P, 3)).astype(np.float32))]


def _check_k21(args, n_use):
    got = k21.select_exact(*args, n_use)
    want = k21.select_exact_plain(*args, n_use)
    assert all(_same(g, w) for g, w in zip(got, want))
    rep = args[0].cpu().numpy()
    np.testing.assert_array_equal(got[0].cpu().numpy(), np.argsort(
        -rep, kind="stable")[:n_use])


@pytest.mark.parametrize("P,n_use", [(1, 1), (333, 64), (46_848, 1024)])
def test_k21_equals_plain(cuda, P, n_use):
    _check_k21(_k21_inputs(P, P, cuda), n_use)


def test_k21_at_n_use_p_above_shared_memory(cuda):
    args = _k21_inputs(60_000, 7, cuda)
    _check_k21(args, 60_000)
    # the n_use-th key inside a run of ties, and every key one value
    _check_k21(args, 31_000)
    flat = [torch.full_like(args[0], 12.5)] + args[1:]
    _check_k21(flat, 777)


def _volumes(cuda):
    rng = np.random.default_rng(22)
    out = [np.zeros((1, 1, 1), np.float32), np.zeros((4, 3, 5), np.float32)]
    one = np.zeros((5, 33, 7), np.float32)
    one[4, 32, 0] = -1.5
    out.append(one)
    v = np.zeros((37, 70, 131), np.float32)
    v[5:30, 9:60, 3:129] = rng.random((25, 51, 126)) * (
        rng.random((25, 51, 126)) < 0.3)
    v[0, 0, 0] = np.nan
    v[36, 69, 130] = -0.0
    v[20, 1, 130] = -0.0
    out.append(v)
    return [torch.as_tensor(a, device=cuda) for a in out]


def test_k22_equals_plain(cuda):
    for v in _volumes(cuda):
        assert _same(k23.axis_flags(v), k23.axis_flags_plain(v)), v.shape
    flags = k23.axis_flags(_volumes(cuda)[-1]).cpu().numpy()
    x, y, z = np.split(flags, [37, 107])
    assert x[0] and y[0] and z[0] and not x[36] and not y[69]


def test_k23_equals_plain(cuda):
    v = _volumes(cuda)[-1]
    for lo, box, pad in (((0, 0, 0), (37, 70, 131), 9),
                         ((0, 0, 0), (37, 70, 131), 0),
                         ((5, 9, 3), (25, 51, 126), 10),
                         ((1, 2, 3), (1, 1, 1), 1),
                         ((36, 69, 130), (1, 1, 1), 0),
                         ((3, 0, 7), (2, 70, 3), 2)):
        got = k23.crop_pad(v, lo, box, pad)
        assert _same(got, k23.crop_pad_plain(v, lo, box, pad)), (lo, box)


def test_reduce_void_and_prepare_equal_the_cpus(cuda):
    for v in _volumes(cuda):
        for p in (0, 10):
            origin = np.array([1.0, -2.0, 3.5])
            got = DensityGrid(v, origin, 1.4).reduce_void(p)
            want = DensityGrid(v.cpu(), origin, 1.4).reduce_void(p)
            assert _same(got.data, want.data)
            np.testing.assert_array_equal(got.origin, want.origin)
        grid = DensityGrid(v, np.zeros(3), 1.4)
        for pad in (0, 9):
            cfg = ScaleSpaceConfig(map_padding=pad)
            got, o1 = prepare(grid, cfg)
            want, o2 = prepare(grid.to("cpu"), cfg)
            assert _same(got, want) and np.array_equal(o1, o2)


def test_launch_counts(cuda):
    args = _k21_inputs(500, 3, cuda)
    v = _volumes(cuda)[-1]
    k21.launches = k23.launches = k23.pad_launches = 0
    k21.select_exact(*args, 64)
    k21.select_exact_plain(*args, 64)
    k23.axis_flags(v)
    k23.axis_flags_plain(v)
    k23.crop_pad(v, (0, 0, 0), v.shape, 3)
    k23.crop_pad_plain(v, (0, 0, 0), v.shape, 3)
    assert (k21.launches, k23.launches, k23.pad_launches) == (1, 1, 1)
    # the same inputs launched again give the same bits
    assert all(_same(a, b) for a, b in zip(k21.select_exact(*args, 64),
                                           k21.select_exact(*args, 64)))
