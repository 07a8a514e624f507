"""Faults found in mad_tpu's assembly while porting it, and what the port
does instead (ROADMAP.md Queue 3).

mad_tpu's device enumeration head fills its binomial table
tab[x, i] = C(n-1-x, k-1-i) as int32 (mad_tpu/engine/assemble.py:454-457).
For k > n / 2 an entry can exceed 2^31 - 1 although C(n, k) itself is
small: at C(35, 31) = 52,360 tuples the table needs C(34, 17) =
2,333,606,220 and mad_tpu raises OverflowError. The port clamps every
entry to C(n, k) (kernels/enumerate.comb_table), which changes no decode
decision, and returns the exhaustive ranking's head exactly.
"""

import math

import numpy as np
import pytest
import torch

from mad_tpu.engine import assemble as jasm
from mad_tpu_torch.engine import assemble as tasm
from mad_tpu_torch.kernels import enumerate as k_enum

torch.set_num_threads(1)


def test_binomial_table_above_int32():
    n, k = 35, 31
    ov = np.triu(np.random.default_rng(3).random((n, n)) * 0.3, k=1)
    with pytest.raises(OverflowError):
        jasm.enumerate_homomultimer(n, k, ov)
    got = tasm.enumerate_homomultimer(n, k, ov, device="cpu")
    full = tasm._all_combinations(n, k)
    _s, _sd, mx = tasm._score_tuples(full, ov)
    order = np.argsort(mx, kind="stable")
    np.testing.assert_array_equal(got[0], full[order][:256])
    np.testing.assert_array_equal(got[3], mx[order][:256])
    tab = k_enum.comb_table(n, k)
    assert tab.dtype == np.int32 and tab.max() == math.comb(n, k)
    tasm.pop_enum_notes()
