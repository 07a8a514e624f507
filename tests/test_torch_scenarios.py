"""The port's scenario helpers against mad_tpu's (mad_tpu/testing.py:115-426):
the host copies bit for bit (deformations, symmetric assemblies, degraded
maps, the regime tables), and the fast C3 case of
tests/test_topologies.py:81-88 through both packages' ``run_topology``
with the same recovery and the same distinct solutions claimed.
"""

import numpy as np
import pytest
import torch

from mad_tpu import testing as jt
from mad_tpu.core.grid import DensityGrid as JGrid
from mad_tpu_torch import testing as tt
from mad_tpu_torch.core.grid import DensityGrid as TGrid

torch.set_num_threads(1)

C3 = dict(name="C3_small", cite="fast-tier variant", kind="cn", n=3,
          n_res=70, radius=24.0, resolution=12.0, voxsp=3.0, seed=31,
          run_kwargs=dict(cc_threshold=0.5))


def test_deform_structure_copy():
    for seed, scale in ((0, 1.5), (3, 4.0)):
        p = tt.make_protein(n_res=60, seed=seed)
        a = tt.deform_structure(p, scale, seed)
        b = jt.deform_structure(jt.make_protein(n_res=60, seed=seed), scale,
                                seed)
        np.testing.assert_array_equal(a.coords, b.coords)


def test_make_symmetric_assembly_copy():
    cases = [("cn", 6, dict(radius=20.0)),
             ("dn", 4, dict(radius=20.0, ring_dz=18.0)),
             ("helix", 5, dict(radius=12.0, rise=25.0,
                               twist=np.deg2rad(-100.0)))]
    for kind, n, kw in cases:
        sa, ca = tt.make_symmetric_assembly(kind, n, n_res=40, seed=2, **kw)
        sb, cb = jt.make_symmetric_assembly(kind, n, n_res=40, seed=2, **kw)
        np.testing.assert_array_equal(sa.coords, sb.coords)
        assert len(ca) == len(cb)
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(x.coords, y.coords)
    with pytest.raises(ValueError):
        tt.make_symmetric_assembly("tn", 3)


def test_regime_tables_copy():
    for a, b in ((tt.TOPOLOGY_REGIMES, jt.TOPOLOGY_REGIMES),
                 (tt.KNOB_REGIMES, jt.KNOB_REGIMES),
                 (tt.DEGRADATION_LADDER, jt.DEGRADATION_LADDER)):
        assert a == b
    assert (len(tt.TOPOLOGY_REGIMES), len(tt.KNOB_REGIMES),
            len(tt.DEGRADATION_LADDER)) == (3, 5, 12)


def test_degrade_map_copy():
    """Every rung's knobs on a small map: bit for bit, on the input
    grid's device."""
    rng = np.random.default_rng(5)
    data = rng.random((14, 12, 10)).astype(np.float32) ** 3
    origin = np.array([1.0, -2.0, 3.0])
    t = TGrid(torch.as_tensor(data), origin, 2.5)
    j = JGrid(data=data, origin=origin, voxsp=2.5)
    points = tt.DEGRADATION_LADDER + [dict(name="iso", noise_sigma=0.05,
                                           isovalue=0.3)]
    for i, point in enumerate(points):
        kw = {k: point[k] for k in ("noise_sigma", "background",
                                    "blur_vox", "isovalue") if k in point}
        a = tt.degrade_map(t, seed=100 + i, **kw)
        b = jt.degrade_map(j, seed=100 + i, **kw)
        assert a.device == t.device and a.data.dtype == torch.float32
        np.testing.assert_array_equal(a.host(), np.asarray(b.data))
        np.testing.assert_array_equal(a.origin, b.origin)


def test_c3_symmetric_dock_small_through_both():
    a = tt.run_topology(C3, rescue_rounds=0, max_anchors=1024,
                        device="cpu")
    b = jt.run_topology(C3, rescue_rounds=0, max_anchors=1024)
    assert a["recovered"] == b["recovered"] == 3, (a, b)
    assert a["distinct_claimed"] == b["distinct_claimed"] == 3, (a, b)
    assert a["map_shape"] == b["map_shape"]
    assert a.keys() == b.keys()
