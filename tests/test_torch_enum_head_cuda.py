"""K19 and K20, the thresholded select of csrc/enumerate.cu, on the card:
every case bit for bit with its plain version over five launches, one
``launches`` count a call. Every test needs a CUDA card and skips without
one; the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_enum_head_cuda.py

Tolerance: equal. The keys (score bits, rank) are unique, so the selected
set and its order are defined exactly, whatever order the blocks race in
on the threshold word. The cases span one block and many, the final head
on one CTA and on a cluster, heads of 1 to 4,096 keys, K20's overlap and
lists in shared and in device memory, and keys that fall with rank (the
threshold prunes least).
"""

import math

import numpy as np
import pytest
import torch

from mad_tpu_torch.kernels import enumerate as k_enum
from mad_tpu_torch.kernels import hetero

pytestmark = pytest.mark.cuda

REPEATS = 5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _overlap(n, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        # 65 % zeros, the rest 0.1 or 0.2, a few diagonal entries: most
        # tuple maxima tie and the rank decides the head's order
        ov = np.triu(np.where(rng.random((n, n)) < 0.35,
                              rng.integers(1, 3, (n, n)) * 0.1, 0.0), k=1)
        ov[np.diag_indices(n)] = np.where(rng.random(n) < 0.2, 0.15, 0.0)
    elif kind == "zeros":
        ov = np.zeros((n, n))
    elif kind == "nan":
        ov = np.triu(rng.random((n, n)) * 0.3, k=1)
        ov[2, 7] = np.nan
    elif kind == "falling":
        i = np.arange(n)
        ov = np.triu(1.0 / (1.0 + i[:, None] + i[None, :]), k=1)
    else:
        ov = np.triu(rng.random((n, n)) * 0.3, k=1)
    return ov


def _repeated(module, fn, want):
    """fn() REPEATS times, one launch each, every head equal to want."""
    for _ in range(REPEATS):
        before = module.launches
        got = fn()
        assert module.launches == before + 1
        assert got.shape == want.shape and torch.equal(got, want)


def _k19(cuda, n, k, head, kind, seed=0):
    ov = torch.as_tensor(_overlap(n, seed + n + k, kind), dtype=torch.float32,
                         device=cuda)
    tab = torch.as_tensor(k_enum.comb_table(n, k), device=cuda)
    want = k_enum.enumerate_head_plain(ov, tab, head)
    assert len(want) == min(head, math.comb(n, k))
    _repeated(k_enum, lambda: k_enum.enumerate_head(ov, tab, head), want)
    return want


def test_k19_the_fits_head(cuda):
    """C(16, 10) = 8,008 ranks, head 256, tied maxima: eight blocks, the
    final head on one CTA."""
    want = _k19(cuda, 16, 10, 256, "ties")
    _ranks, scores = k_enum.split_keys(want)
    assert scores[-1] == scores[len(scores) // 2]        # ties in the head


def test_k19_many_blocks_and_head_1(cuda):
    """C(25, 6) = 177,100 ranks over an SM each at heads 16 and 1."""
    _k19(cuda, 25, 6, 16, "random")
    _k19(cuda, 25, 6, 1, "random")


def test_k19_zero_and_nan_overlaps(cuda):
    """All-zero overlap: every key is its rank. A NaN entry makes every
    tuple's masked max NaN, clamped to 0: the same keys."""
    for kind in ("zeros", "nan"):
        want = _k19(cuda, 16, 10, 256, kind)
        assert torch.equal(want.cpu(), torch.arange(256))


def test_k19_head_4096(cuda):
    """Head 4,096 of C(25, 6): 16 blocks selecting many times, the final
    head on a cluster of 8 CTAs, a bitonic sort."""
    _k19(cuda, 25, 6, 4096, "ties")


def _k20(cuda, sizes, head, kind, seed=12, shuffle=True):
    rng = np.random.default_rng(seed)
    n_sol = sum(sizes)
    ov = torch.as_tensor(_overlap(n_sol, seed, kind), dtype=torch.float32,
                         device=cuda)
    perm = rng.permutation(n_sol) if shuffle else np.arange(n_sol)
    lists = np.zeros((len(sizes), max(sizes)), np.int32)
    for g, (a, z) in enumerate(zip(np.cumsum([0] + sizes[:-1]),
                                   np.cumsum(sizes))):
        lists[g, : sizes[g]] = perm[a:z]
    lists = torch.as_tensor(lists, device=cuda)
    want = hetero.hetero_head_plain(ov, lists, sizes, head)
    assert len(want) == min(head, int(np.prod(sizes)))
    _repeated(hetero, lambda: hetero.hetero_head(ov, lists, sizes, head),
              want)


def test_k20_16_to_the_5th(cuda):
    """16^5 = 1,048,576 tuples over 80 solutions, head 256 (chip_smoke's
    heteromer phase): sym in shared memory, the final on a cluster."""
    _k20(cuda, [16] * 5, 256, "random")


def test_k20_sym_in_device_memory(cuda):
    """50^3 tuples over 150 solutions: sym formed at each read from
    device memory."""
    _k20(cuda, [50] * 3, 256, "random")


def test_k20_falling_keys(cuda):
    """Sums that fall with rank (lists in solution order, overlap falling
    with the index): the threshold prunes least, blocks select often."""
    _k20(cuda, [16] * 4, 256, "falling", shuffle=False)


def test_k20_group_counts(cuda):
    """G = 2 (4,500 x 300 tuples: the lists, 36 KB, read from device
    memory, and sym too), G = 8 (4^8 tuples: the members decoded once
    into registers) and G = 12 (3^6 x 2^4 tuples, sizes of 1 among them:
    each member decoded where it is read)."""
    _k20(cuda, [4500, 300], 256, "random")
    _k20(cuda, [4] * 8, 256, "random")
    _k20(cuda, [3, 1, 3, 2, 3, 2, 3, 2, 1, 3, 2, 3], 256, "random")
