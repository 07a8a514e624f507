"""Bench-scale regimes through both packages (slow tier): the three
TOPOLOGY_REGIMES, the mid-ladder ``noise_10pct`` rung, and the 48^3 map
with one NaN voxel of tests/test_misc_components.py:197-223 under the stage
sanitizer.

Each regime is held to mad_tpu's own test gates (tests/test_topologies.py,
tests/test_degradation.py) on the CPU, and the port's recovery counts
equal mad_tpu's on the same inputs.
"""

import numpy as np
import pytest
import torch

from mad_tpu import testing as jt
from mad_tpu_torch import testing as tt

pytestmark = pytest.mark.slow

torch.set_num_threads(4)


@pytest.mark.parametrize("regime", tt.TOPOLOGY_REGIMES,
                         ids=[r["name"] for r in tt.TOPOLOGY_REGIMES])
def test_topology_through_both(regime):
    a = tt.run_topology(regime, device="cpu")
    assert a["recovered"] == a["n_copies"], a
    assert a["distinct_claimed"] == a["n_copies"], a
    good = [r for r in a["rmsds"] if r < a["threshold"]]
    assert np.median(good) < a["threshold"] / 2.0, a
    b = jt.run_topology(regime)
    assert (a["recovered"], a["distinct_claimed"], a["map_shape"]) == \
        (b["recovered"], b["distinct_claimed"], b["map_shape"]), (a, b)


def test_noise_10pct_through_both():
    point = dict(name="noise_10pct", noise_sigma=0.10, background=0.05)
    a = tt.run_degraded(point, device="cpu")
    assert a["recovered"] == a["n_copies"] == 3, a
    assert np.median([r for r in a["rmsds"] if r < 5.0]) < 2.5, a
    b = jt.run_degraded(point)
    assert (a["recovered"], a["map_shape"]) == \
        (b["recovered"], b["map_shape"]), (a, b)


def test_nan_voxel_localized_as_mad_tpu_does(monkeypatch):
    from mad_tpu.core.config import MadConfig as JConfig
    from mad_tpu.core.grid import DensityGrid as JGrid
    from mad_tpu.engine.pipeline import describe_grid as jdescribe
    from mad_tpu.utils import sanitize as jsanitize
    from mad_tpu_torch.core.config import MadConfig
    from mad_tpu_torch.core.grid import DensityGrid
    from mad_tpu_torch.engine.pipeline import describe_grid
    from mad_tpu_torch.utils import sanitize
    monkeypatch.setenv("MAD_TPU_NANCHECK", "1")
    rng = np.random.default_rng(0)
    data = rng.random((48, 48, 48)).astype(np.float32)
    data[20, 20, 20] = np.nan
    msgs = []
    for run, clear in (
            (lambda: describe_grid(DensityGrid(torch.as_tensor(data),
                                               np.zeros(3), 2.0),
                                   MadConfig(), name="bad", device="cpu"),
             sanitize.clear),
            (lambda: jdescribe(JGrid(data=data, origin=np.zeros(3),
                                     voxsp=2.0), JConfig(), name="bad"),
             jsanitize.clear)):
        clear()
        try:
            with pytest.raises(FloatingPointError,
                               match=r"detect\[o0\].*scalespace\.grad") as e:
                run()
        finally:
            clear()
        msgs.append(str(e.value).split(" (rerun")[0])
    assert msgs[0] == msgs[1], msgs
