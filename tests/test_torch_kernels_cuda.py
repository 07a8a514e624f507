"""The four hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA card and skips without one; the
file imports neither JAX nor mad_tpu, so it runs where only PyTorch is
installed, without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Inputs: a small two-copy map built by the port itself (make_assembly, 8 A
at 2 A), its two octaves, lanes and match table. Tolerances:
  * K1, K4: bit for bit (K1 rounds every product and sum on its own, in the
    shift-add's order; K4 is integer work on the same floats);
  * K7: rows equal in >= 99 %, the rest within an L1 of 8 counts (the
    card's atan2f / acosf against PyTorch's, at zone bounds);
  * K13: equal except pairs with an anchor within 1e-4 A of the 4 A radius
    (direct (y - b)^2 against the plain |y|^2 + |b|^2 - 2 y.b).
The parity of the plain versions with mad_tpu is held by the other
tests/test_torch_*.py files on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import MadConfig
from mad_tpu_torch.core.eqsp import get_eqsp
from mad_tpu_torch.engine.match import match_descriptors
from mad_tpu_torch.engine.pipeline import (describe_grid,
                                           describe_structure, octave_lanes)
from mad_tpu_torch.kernels import conv1d, describe, peaks, repeat
from mad_tpu_torch.ops.convolve import gaussian_kernel1d
from mad_tpu_torch.ops.describe import descriptor_lattice, region_ids
from mad_tpu_torch.ops.orient import ref_zone_bounds
from mad_tpu_torch.ops.scalespace import iter_octaves
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.testing import decoy_transform, make_assembly

pytestmark = pytest.mark.cuda

ROWS_EQUAL, ROW_L1, DIST_EDGE = 0.99, 8, 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def system(cuda):
    cfg = MadConfig()
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 max_anchors=1024))
    sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, device=cuda,
                            masses=masses).reduce_void()
    return cfg, sub, copies, dmap


def test_k1_conv1d_bitwise(system):
    _cfg, _s, _c, dmap = system
    vol = dmap.data
    for k in (gaussian_kernel1d(2.0, 2), gaussian_kernel1d(1.0, 0),
              np.array([0.1, 0.4, 0.3, 0.2], np.float32)):
        for axis in range(3):
            for mode in ("same", "full"):
                before = conv1d.launches
                got = conv1d.conv1d_along(vol, k, axis, mode)
                assert conv1d.launches == before + 1
                torch.testing.assert_close(
                    got, conv1d.conv1d_along_plain(vol, k, axis, mode),
                    rtol=0, atol=0)


def test_k1_rejects_what_it_does_not_take(system):
    _cfg, _s, _c, dmap = system
    k = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        conv1d.conv1d_along(dmap.data.double(), k, 0)
    with pytest.raises(ValueError):      # a batch has one leading axis
        conv1d.conv1d_along(dmap.data[None, None], k, 0)


def test_k4_peaks_exact(system):
    cfg, _s, _c, dmap = system
    dc = cfg.detect
    for _org, octv in iter_octaves(dmap, cfg.scalespace):
        log_vol, _g = octv.log_gauss()
        args = (log_vol, octv.real_shape, float(dc.threshold_abs),
                int(dc.exclude_border), int(dc.max_anchors))
        before = peaks.launches
        v1, i1 = peaks.peak_topk(*args)
        assert peaks.launches > before
        v2, i2 = peaks.peak_topk_plain(*args)
        assert len(i1) > 0
        assert torch.equal(i1, i2) and torch.equal(v1, v2)


def test_k4_more_peaks_than_the_first_buffer(cuda):
    """A peak lattice denser than the kernel's first survivor buffer: the
    wrapper reruns with the counted size and still returns the exact
    top-k in flat-index tie order."""
    vol = torch.zeros((130, 130, 130), device=cuda)
    vol[1:-1:2, 1:-1:2, 1:-1:2] = 1.0              # 64^3 = 262144 peaks
    args = (vol, vol.shape, 0.05, 0, 100_000)
    before = peaks.launches
    v1, i1 = peaks.peak_topk(*args)
    assert peaks.launches == before + 2
    v2, i2 = peaks.peak_topk_plain(*args)
    assert torch.equal(i1, i2) and torch.equal(v1, v2) and len(i1) == 100_000


def test_k7_descriptor_rows(system, cuda):
    cfg, _s, _c, dmap = system
    dcfg = cfg.describe
    radius = (dcfg.patch_size - dcfg.patch_size % 2) // 2
    for _org, octv in iter_octaves(dmap, cfg.scalespace):
        lanes = octave_lanes(octv, cfg)
        valid = torch.ones(lanes.coords.shape[0], dtype=torch.bool,
                           device=cuda)
        valid[::7] = False
        args = (lanes.grad, lanes.coords, lanes.rfinal, valid,
                octv.real_shape, descriptor_lattice(radius, octv.upsampled),
                region_ids(radius, dcfg.subregions),
                ref_zone_bounds(get_eqsp(dcfg.subeqsp_size)),
                dcfg.subregions, dcfg.cutoff_magn, dcfg.zero_magn)
        before = describe.launches
        d1, ok1 = describe.descriptor_hist(*args)
        assert describe.launches == before + 1
        d2, ok2 = describe.descriptor_hist_plain(*args)
        assert torch.equal(ok1, ok2) and int(ok1.sum()) > 10
        diff = (d1.long() - d2.long()).abs().sum(dim=1)
        assert (diff == 0).float().mean().item() >= ROWS_EQUAL
        assert diff.max().item() <= ROW_L1
        # rows of invalid lanes are zero
        assert not d1[~ok1].any()


def test_k7_bfloat16_field(system, cuda):
    """The bf16 gradient field (octaves above 250 M voxels) goes through
    the same kernel; compared with the plain version on the same field."""
    cfg, _s, _c, dmap = system
    dcfg = cfg.describe
    radius = (dcfg.patch_size - dcfg.patch_size % 2) // 2
    _org, octv = next(iter(iter_octaves(dmap, cfg.scalespace)))
    lanes = octave_lanes(octv, cfg)
    args = (lanes.grad.to(torch.bfloat16), lanes.coords, lanes.rfinal,
            torch.ones(lanes.coords.shape[0], dtype=torch.bool, device=cuda),
            octv.real_shape, descriptor_lattice(radius, octv.upsampled),
            region_ids(radius, dcfg.subregions),
            ref_zone_bounds(get_eqsp(dcfg.subeqsp_size)), dcfg.subregions,
            dcfg.cutoff_magn, dcfg.zero_magn)
    d1, ok1 = describe.descriptor_hist(*args)
    d2, ok2 = describe.descriptor_hist_plain(*args)
    assert torch.equal(ok1, ok2)
    diff = (d1.long() - d2.long()).abs().sum(dim=1)
    assert (diff == 0).float().mean().item() >= ROWS_EQUAL


def _near_radius(hc, lc, rot, hi, lo, thresh):
    y = torch.einsum("cad,ced->cae", hc[None].double() - hi[:, None].double(),
                     rot.double()) + lo[:, None].double()
    d = ((y[:, :, None] - lc[None, None].double()) ** 2).sum(-1)
    d = d.amin(-1).sqrt()
    return ((d - thresh).abs() < DIST_EDGE).any(dim=1)


def test_k13_exact_repeat(system, cuda):
    cfg, sub, _c, dmap = system
    m = describe_grid(dmap, cfg, name="map", device=cuda)
    s = describe_structure(decoy_transform(sub), 8.0, dmap.voxsp, cfg,
                           name="sub", device=cuda)
    table = match_descriptors(m, s, dmap.shape, dmap.origin, dmap.voxsp,
                              cfg.match, device=cuda)
    assert table.n > 100
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    args = (f(table.hi_cloud), f(table.lo_cloud), f(table.rot),
            f(table.hi_coord), f(table.lo_coord), 4.0)
    before = repeat.launches
    got = repeat.exact_repeat(*args)
    assert repeat.launches == before + 1
    want = repeat.exact_repeat_plain(*args)
    keep = ~_near_radius(*args)
    assert torch.equal(got[keep], want[keep])


def test_k13_rejects_mixed_devices(cuda):
    a = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        repeat.exact_repeat(a, a.cpu(), torch.eye(3, device=cuda)[None],
                            a[:1], a[:1], 4.0)
