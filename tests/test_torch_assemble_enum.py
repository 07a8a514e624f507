"""Port parity: the assembly enumerations (mad_tpu_torch/engine/assemble.py
with the plain versions of K19 and K20) against mad_tpu on the same
overlap matrices, on the CPU.

Required on every path, device head and host enumeration alike: the same
tuples in the same order, the same MaD> notes, and sums, stds and maxima
within 1e-6 (the port recomputes them with the same host code on the same
float64 matrix; the tolerance covers nothing but the order of float
additions the two libraries may choose).
"""

import math

import numpy as np
import pytest
import torch

from mad_tpu.engine import assemble as jasm
from mad_tpu_torch.engine import assemble as tasm

torch.set_num_threads(1)

STAT_TOL = 1e-6


def _overlap(n, seed, scale=0.3, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # 65 % zeros, the rest 0.1 or 0.2: most tuple maxima tie and the
        # rank decides the order of the head.
        ov = np.where(rng.random((n, n)) < 0.35,
                      rng.integers(1, 3, (n, n)) * 0.1, 0.0)
    else:
        ov = rng.random((n, n)) * scale
    return np.triu(ov, k=1)


def _same(got, ref, got_notes, ref_notes):
    np.testing.assert_array_equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=STAT_TOL)
    assert got_notes == ref_notes


# (n, k, head, seed, ties): C(14,6) = 3,003 and C(25,6) = 177,100 take the
# device head (above 4 * head), C(25,6) over many chunks and blocks;
# C(16,8) = 12,870 with tied maxima; C(6,4) = 15 the host path; n = 70
# lies above the 64-solution frame and enumerates all on the host.
@pytest.mark.parametrize("n,k,head,seed,ties", [
    (14, 6, 32, 7, False), (25, 6, 16, 8, False), (16, 8, 64, 24, True),
    (6, 4, 256, 7, False), (70, 2, 256, 10, False)])
def test_homomultimer(n, k, head, seed, ties):
    ov = _overlap(n, seed, ties=ties)
    jasm.pop_enum_notes()
    tasm.pop_enum_notes()
    ref = jasm.enumerate_homomultimer(n, k, ov, head=head)
    ref_notes = jasm.pop_enum_notes()
    got = tasm.enumerate_homomultimer(n, k, ov, head=head, device="cpu")
    _same(got, ref, tasm.pop_enum_notes(), ref_notes)
    device = n <= 64 and math.comb(n, k) > 4 * head
    assert bool(ref_notes) == device
    assert len(ref[0]) == (head if device else math.comb(n, k))
    if ties:
        assert ref[3][head - 1] == ref[3][head // 2]   # ties in the head


# 8^4 = 4,096 > 4 * 64: the device head; 2 x 3 x 4 = 24: the host
# product; 12^3 with max_combinations=1000 trims to 10^3 = 1,000 (host
# product) and says so.
@pytest.mark.parametrize("n_per,n_groups,head,cap", [
    ([8] * 4, 4, 64, 50_000_000), ([2, 3, 4], 3, 256, 50_000_000),
    ([12] * 3, 3, 256, 1000)])
def test_heteromer(n_per, n_groups, head, cap):
    n_sol = sum(n_per)
    ov = _overlap(n_sol, 11 + n_groups, scale=0.2)
    starts = np.cumsum([0] + n_per)
    groups = {f"s{g}": list(range(starts[g], starts[g + 1]))
              for g in range(n_groups)}
    jasm.pop_enum_notes()
    tasm.pop_enum_notes()
    ref = jasm.enumerate_heteromer(groups, ov, max_combinations=cap,
                                   head=head)
    ref_notes = jasm.pop_enum_notes()
    got = tasm.enumerate_heteromer(groups, ov, max_combinations=cap,
                                   head=head, device="cpu")
    _same(got, ref, tasm.pop_enum_notes(), ref_notes)
    if cap == 1000:
        assert len(ref[0]) == 1000
        assert "restricted to the best-ranked" in ref_notes[0]
    else:
        assert len(ref[0]) == min(head, int(np.prod(n_per)))
