"""The five KNOB_REGIMES through both packages (slow tier), each held to
mad_tpu's own gates (tests/test_knob_matrix.py) on the CPU, the port's
recovery equal to mad_tpu's on the same inputs."""

import numpy as np
import pytest
import torch

from mad_tpu import testing as jt
from mad_tpu_torch import testing as tt

pytestmark = pytest.mark.slow

torch.set_num_threads(4)


@pytest.mark.parametrize("regime", tt.KNOB_REGIMES,
                         ids=[r["name"] for r in tt.KNOB_REGIMES])
def test_knob_regime_through_both(regime):
    a = tt.run_knob_regime(regime, device="cpu")
    assert a["n_solutions"] >= a["n_copies"] // 2, a
    assert a["recovered"] == a["n_copies"], a
    good = [r for r in a["rmsds"] if r < a["threshold"]]
    assert np.median(good) < a["threshold"] / 2.0, a
    b = jt.run_knob_regime(regime)
    assert (a["recovered"], a["map_shape"]) == \
        (b["recovered"], b["map_shape"]), (a, b)
