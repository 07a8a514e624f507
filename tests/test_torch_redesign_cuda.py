"""K1's fused LoG and batched blur, K9's ordered scatter and K6's cluster
kernel against their plain versions, on the card. Every test here needs a
CUDA card and skips without one; the file imports neither JAX nor
mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_redesign_cuda.py

Tolerances: all bit for bit (a float's sign of zero included). K1 rounds
every product and sum on its own in the plain version's order; K9 adds a
voxel's contributions in mad_tpu's (corner, atom) order, as the plain
version does on the CPU; K6's histogram sums are exact integers at the
default settings. The plain versions' parity with mad_tpu is held on the
CPU by tests/test_torch_logfused.py, test_torch_scatter_order.py and
test_torch_orient_zones.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import MadConfig
from mad_tpu_torch.engine import pipeline
from mad_tpu_torch.kernels import conv1d, orient as k6, scatter
from mad_tpu_torch.ops import convolve
from mad_tpu_torch.ops.convolve import gaussian_kernel1d
from mad_tpu_torch.ops.detect import detect_anchors
from mad_tpu_torch.ops.orient import _OrientTables
from mad_tpu_torch.ops.scalespace import gradient, iter_octaves
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.testing import make_assembly, orient_agreement

pytestmark = pytest.mark.cuda


def bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dimer(cuda):
    cfg = MadConfig()
    _sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    return cfg, coords, masses, copies


def _vol(cuda, seed, shape):
    v = torch.tensor(np.random.default_rng(seed).normal(size=shape)
                     .astype(np.float32), device=cuda)
    v[: shape[0] // 3] = 0.0            # a zero field: signed zeros
    return v


@pytest.mark.parametrize("shape,sigma", [((61, 47, 39), 2.0),
                                         ((40, 33, 58), 1.0),
                                         ((30, 31, 32), 3.0)])
def test_log_gauss_is_the_plain_sequence(cuda, shape, sigma):
    vol = _vol(cuda, 1, shape)
    g0, g2 = gaussian_kernel1d(sigma, 0), gaussian_kernel1d(sigma, 2)
    want = conv1d.log_gauss_plain(vol, g0, g2, sigma)
    before = conv1d.log_launches
    held = [vol.clone()]
    got = conv1d.log_gauss(held, g0, g2, sigma)
    assert held == [] and conv1d.log_launches == before + 3
    assert bits(got[0], want[0]) and bits(got[1], want[1])


def test_batched_blur_is_the_plain_version(cuda):
    batch = torch.stack([_vol(cuda, s, (23, 19, 30)) for s in range(3)])
    for k in (gaussian_kernel1d(1.6, 0), np.ones(13, np.float32) / 13,
              np.array([0.25, 0.0, 0.5, 0.25], np.float32)):
        for axis in range(3):
            for mode in ("same", "full"):
                before = conv1d.launches
                got = conv1d.conv1d_along(batch, k, axis, mode)
                assert conv1d.launches == before + 1
                assert bits(got, conv1d.conv1d_along_plain(batch, k, axis,
                                                           mode))


def test_scatter_is_the_cpu_plain_version_every_launch(cuda):
    rng = np.random.default_rng(2)
    M, N, box = 3, 20000, (40, 36, 30)
    c = rng.uniform(-3.0, 50.0, size=(M, N, 3)).astype(np.float32)
    c[:, :4000] = np.float32(12.3)                  # one crowded cell
    m = rng.uniform(0.5, 16.0, size=(M, N)).astype(np.float32)
    m[:, ::9] = 0.0
    vm = rng.uniform(-1.0, 1.0, size=(M, 3)).astype(np.float32)
    cpu = [torch.tensor(x) for x in (c, m, vm)]
    want = scatter.scatter_atoms_plain(*cpu, box, 2, 1.4)
    before = scatter.launches
    got = [scatter.scatter_atoms(*[x.to(cuda) for x in cpu], box, 2, 1.4)
           for _ in range(5)]
    assert scatter.launches == before + 5
    assert all(bits(g.cpu(), want) for g in got)


def test_a_subunit_describes_the_same_every_time(cuda, dimer):
    cfg, _c, _m, copies = dimer
    grids = [simulate_density(copies[0], 8.0, 2.0,
                              device=cuda) for _ in range(3)]
    assert all(bits(g.data, grids[0].data) for g in grids[1:])
    sets = [pipeline.describe_structure(copies[0], 8.0, 2.0, cfg,
                                        device=cuda) for _ in range(2)]
    a, b = sets
    assert a.n == b.n > 0 and torch.equal(a.desc, b.desc)
    for k in ("coords", "subv_coords", "rfinal"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_describe_grid_with_the_plain_log(cuda, dimer, monkeypatch):
    cfg, coords, masses, _copies = dimer
    dmap = simulate_density(coords, 8.0, 2.0, device=cuda,
                            masses=masses).reduce_void()
    a = pipeline.describe_grid(dmap, cfg, name="m", device=cuda)
    monkeypatch.setattr(convolve, "log_gauss", conv1d.log_gauss_plain)
    before = conv1d.log_launches
    b = pipeline.describe_grid(dmap, cfg, name="m", device=cuda)
    assert conv1d.log_launches == before
    assert a.n == b.n > 0 and torch.equal(a.desc, b.desc)
    for k in ("coords", "subv_coords", "rfinal"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_orient_clusters_equal_the_plain_version(cuda, dimer):
    cfg, coords, masses, _copies = dimer
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 max_anchors=1024))
    dmap = simulate_density(coords, 8.0, 2.0, device=cuda,
                            masses=masses).reduce_void()
    oc = cfg.orient
    radius = (oc.patch_size - oc.patch_size % 2) // 2
    for _org, octv in iter_octaves(dmap, cfg.scalespace):
        log_vol, gauss = octv.log_gauss()
        anch = detect_anchors(log_vol, octv.real_shape, cfg.detect)
        grad = gradient(gauss, octv.grad_dtype())
        co = anch.coords[anch.valid]
        va = torch.ones(co.shape[0], dtype=torch.bool, device=cuda)
        stride = 2 if octv.upsampled else 1
        tab = _OrientTables(oc, radius, stride, cuda)
        args = (grad, co, va, octv.real_shape, tab, radius, stride,
                oc.max_main, oc.max_sec, oc.cutoff_magn)
        got, again = k6.orient(*args), k6.orient(*args)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        share, dmax, _close = orient_agreement(got, k6.orient_plain(*args))
        assert round(share * co.shape[0]) == co.shape[0] and dmax == 0.0
        assert bool(got[3].any())
