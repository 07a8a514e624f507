"""Port parity: density simulation, reduce_void and the two-octave scale
space (mad_tpu_torch/ops/simulate.py, core/grid.py, ops/scalespace.py)
against mad_tpu on the same numpy inputs.

Tolerances: relative 1e-5 of the volume's max for every field. The port
runs each octave at its real extent where mad_tpu pads to a 32-voxel
bucket; the map carries 9 voxels of zero padding, so the filters see the
same zeros either way and the real extents agree to float32 rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.ops import scalespace as jss
from mad_tpu.ops import simulate as jsim
from mad_tpu.testing import make_assembly
from mad_tpu_torch.convert import grid_from_numpy
from mad_tpu_torch.core.config import MadConfig as TConfig
from mad_tpu_torch.ops import scalespace as tss
from mad_tpu_torch.ops import simulate as tsim

torch.set_num_threads(1)

REL = 1e-5


def _close(got, ref, rel=REL):
    got = got.detach().cpu().float().numpy() \
        if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def system():
    sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    return sub, coords, masses


@pytest.mark.parametrize("pad,isovalue", [(0, 0.0), (2, 0.1)])
def test_simulate_density(system, pad, isovalue):
    _sub, coords, masses = system
    j = jsim.simulate_density(coords, 8.0, 2.0, isovalue=isovalue, pad=pad,
                              masses=masses, shape_bucket=32)
    t = tsim.simulate_density(coords, 8.0, 2.0,
                              device="cpu", isovalue=isovalue,
                              pad=pad, masses=masses, shape_bucket=32)
    np.testing.assert_array_equal(t.origin, j.origin)
    _close(t.data, j.data)
    assert tsim.simulated_shape(coords, 8.0, 2.0, pad=pad) == \
        jsim.simulated_shape(coords, 8.0, 2.0, pad=pad)


def test_plan_simulation_is_the_same(system):
    _sub, coords, _m = system
    for bucket in (16, 32):
        assert tsim.plan_simulation(coords, 10.0, 1.4, shape_bucket=bucket) \
            .__dict__ == jsim.plan_simulation(coords, 10.0, 1.4,
                                              shape_bucket=bucket).__dict__


def test_batched_simulate(system):
    sub, _c, _m = system
    rng = np.random.default_rng(4)
    coords = np.stack([sub.coords + rng.normal(scale=3.0, size=3)
                       for _ in range(3)])
    masses = np.tile(sub.masses, (3, 1))
    dj, oj = jsim.batched_simulate(coords, masses, 8.0, 2.0, shape_bucket=16)
    dt, ot = tsim.batched_simulate(coords, masses, 8.0, 2.0, "cpu",
                                   shape_bucket=16)
    np.testing.assert_array_equal(ot, oj)
    _close(dt, dj)


def test_reduce_void_normalized_padded_clamp(system):
    _sub, coords, masses = system
    j = jsim.simulate_density(coords, 8.0, 2.0, masses=masses)
    t = grid_from_numpy(np.asarray(j.data), j.origin, j.voxsp, device="cpu")
    for jj, tt in [(j.reduce_void(), t.reduce_void()),
                   (j.reduce_void(4), t.reduce_void(4)),
                   (j.normalized(), t.normalized()),
                   (j.padded(3), t.padded(3)),
                   (j.clamp_isovalue(0.2), t.clamp_isovalue(0.2)),
                   (j.clamp_isovalue(5.0), t.clamp_isovalue(5.0))]:
        np.testing.assert_array_equal(tt.origin, jj.origin)
        np.testing.assert_array_equal(tt.host(), np.asarray(jj.data))


@pytest.mark.parametrize("oct_mode", ["both"])
def test_octaves_log_and_gradient(system, oct_mode):
    _sub, coords, masses = system
    jcfg = JConfig()
    jcfg = jcfg.replace(scalespace=dataclasses.replace(jcfg.scalespace,
                                                       oct_mode=oct_mode))
    tcfg = TConfig()
    tcfg = tcfg.replace(scalespace=dataclasses.replace(tcfg.scalespace,
                                                       oct_mode=oct_mode))
    j = jsim.simulate_density(coords, 8.0, 2.0, masses=masses).reduce_void()
    t = grid_from_numpy(np.asarray(j.data), j.origin, j.voxsp, device="cpu")
    jo = list(jss.iter_lazy_octaves(j, jcfg.scalespace, jcfg.shape_bucket))
    to = list(tss.iter_octaves(t, tcfg.scalespace))
    assert len(jo) == len(to) == 2
    for (jorg, jo_), (torg, to_) in zip(jo, to):
        np.testing.assert_array_equal(torg, jorg)
        assert to_.voxsp == jo_.voxsp
        assert to_.real_shape == tuple(jo_.real_shape)
        rx, ry, rz = to_.real_shape
        log_t, gauss_t = to_.log_gauss()
        _close(log_t, np.asarray(jo_.log())[:rx, :ry, :rz])
        grad_t = tss.gradient(gauss_t, to_.grad_dtype())
        grad_j = np.asarray(jo_.grad())
        # jnp.gradient at the real edge reads the bucket padding beyond it;
        # compare where both sides see the same neighbours.
        _close(grad_t[:rx - 1, :ry - 1, :rz - 1],
               grad_j[:rx - 1, :ry - 1, :rz - 1])


def test_gradient_matches_jnp_gradient():
    import jax.numpy as jnp
    vol = np.random.default_rng(8).normal(size=(7, 9, 6)).astype(np.float32)
    got = tss.gradient(torch.as_tensor(vol))
    ref = np.stack(jnp.gradient(jnp.asarray(vol)), axis=-1)
    _close(got, ref)


def test_bf16_gate_is_the_same_voxel_count():
    cfg = TConfig().scalespace
    assert tss.BF16_VOXELS == jss.LazyOctave.BF16_VOXELS
    big = torch.empty((400, 400, 400), device="meta")
    assert tss.Octave(big, 0.7, True, cfg).grad_dtype() == torch.bfloat16
    assert tss.Octave(big, 1.4, False, cfg).grad_dtype() == torch.float32
