"""Port parity: rigid-body refinement (mad_tpu_torch/engine/refine.py)
against mad_tpu/engine/refine.py on the same map and start poses.

Judged on outcomes, not trajectories (the two loops round float32 steps in
another order): final pose CA-RMSD to mad_tpu's <= 0.1 A, both on the
deposited pose, the same failed (NaN) and converged flags.
"""

import numpy as np
import pytest
import torch

from mad_tpu.core.config import RefineConfig as JRefine
from mad_tpu.engine import refine as jref
from mad_tpu.ops.simulate import simulate_density as jsimulate
from mad_tpu.testing import make_protein
from mad_tpu_torch.convert import grid_from_numpy
from mad_tpu_torch.core.config import RefineConfig as TRefine
from mad_tpu_torch.engine import refine as tref

torch.set_num_threads(1)

POSE_TOL = 0.1


@pytest.fixture(scope="module")
def refine_system():
    p = make_protein(n_res=30, seed=2, n_segments=2)
    dmap = jsimulate(p, resolution=8.0, voxsp=2.0).reduce_void(8)
    rng = np.random.default_rng(3)
    starts = []
    for i in range(6):
        ang = np.deg2rad(2.0 + 2.0 * i)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        center = p.coords.mean(axis=0)
        starts.append((p.coords - center) @ R + center
                      + rng.normal(scale=0.5 + 0.3 * i, size=3))
    starts = np.stack(starts).astype(np.float32)
    starts[5, 7] = np.nan              # a numerically failing candidate
    return p, dmap, starts


def _ca_rmsd(a, b, ca):
    return np.sqrt(((a[ca] - b[ca]) ** 2).sum(-1).mean())


@pytest.mark.parametrize("n_steps", [120, 500])
def test_refine_outcomes(refine_system, n_steps):
    p, dmap, starts = refine_system
    jr = jref.refine_candidates(dmap, starts, JRefine(n_steps=n_steps))
    tmap = grid_from_numpy(np.asarray(dmap.data), dmap.origin, dmap.voxsp,
                           device="cpu")
    tr = tref.refine_candidates(tmap, starts, TRefine(n_steps=n_steps),
                                device="cpu")
    np.testing.assert_array_equal(tr.failed, jr.failed)
    assert tr.failed[5] and not tr.failed[:5].any()
    for i in range(5):
        assert _ca_rmsd(tr.coords[i], jr.coords[i], p.ca_idx) <= POSE_TOL
        # and both land on the deposited pose
        assert _ca_rmsd(tr.coords[i], p.coords, p.ca_idx) < 1.0
    np.testing.assert_array_equal(tr.converged[:5], jr.converged[:5])


def test_unread_fields_are_the_four_tpu_knobs():
    """core/config.UNREAD_FIELDS names exactly mad_tpu's four config fields
    that change no result, each a field of both packages' MadConfig, and no
    port module outside core/config.py mentions them."""
    import dataclasses
    import pathlib

    from mad_tpu.core.config import MadConfig as JMad
    from mad_tpu_torch.core.config import UNREAD_FIELDS, MadConfig as TMad
    assert UNREAD_FIELDS == ("describe.static_lanes", "refine.segment_steps",
                             "refine.cascade", "warm_start")
    for cfg in (JMad(), TMad()):
        for name in UNREAD_FIELDS:
            obj = cfg
            for part in name.split("."):
                assert part in {f.name for f in dataclasses.fields(obj)}
                obj = getattr(obj, part)
    root = pathlib.Path(__file__).resolve().parent.parent / "mad_tpu_torch"
    for path in root.rglob("*.py"):
        if path.name == "config.py" and path.parent.name == "core":
            continue
        text = path.read_text()
        for name in UNREAD_FIELDS:
            assert name.split(".")[-1] not in text, (path, name)
