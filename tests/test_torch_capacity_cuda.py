"""Capacity mode on the card: the offset forms of K4 (peaks), K5 (Newton
localization), K6 (orientation) and K7 (descriptors) against their plain
PyTorch versions at one shard's inputs, and describe_grid on a mesh of
shards that share one card against the single-device run. Every test here
needs a CUDA card and skips without one; the file imports neither JAX nor
mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_capacity_cuda.py

Inputs: the small two-copy map of tests/test_torch_describe_cuda.py (8 A at
2 A); a shard's inputs are those that describe_grid on 4 shards gives the
kernels at the call sites, recorded for the first shard with an offset
(shard 1 of the upsampled octave). Tolerances: K4 and K5 bit for bit; K6
on at least 99 % of the anchors with frames within 1e-6 (its standing
gate, tests/test_torch_orient_refine_cuda.py); K7 rows equal on at least
99 % with the rest within an L1 of 8 (zone-bound ulps of atan2f / acosf).
The capacity-mode DescriptorSet equals the single-device one bit for bit,
also with its shards on two cards (skipped on a machine with one).
The parity of the mesh path with mad_tpu's capacity bodies is held on the
CPU by tests/test_torch_capacity.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import MadConfig
from mad_tpu_torch.engine import pipeline
from mad_tpu_torch.kernels import describe as k7
from mad_tpu_torch.kernels import localize as k5
from mad_tpu_torch.kernels import orient as k6
from mad_tpu_torch.kernels import peaks as k4
from mad_tpu_torch.ops import describe, detect
from mad_tpu_torch.core.config import ScaleSpaceConfig
from mad_tpu_torch.ops.convolve import log_filter3d
from mad_tpu_torch.ops.scalespace import ShardedOctave
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.parallel.mesh import make_mesh
from mad_tpu_torch.parallel.volume import split_x
from mad_tpu_torch.testing import (make_assembly, orient_agreement,
                                   recording)

pytestmark = pytest.mark.cuda

FIELDS = ("coords", "map_coords", "subv_coords", "rfinal", "octave",
          "anchor_id", "main_bin", "sec_bin")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def system(cuda):
    cfg = MadConfig()
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 max_anchors=1024))
    _sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, device=cuda,
                            masses=masses).reduce_void()
    return cfg, dmap, pipeline.describe_grid(dmap, cfg, name="m")


@pytest.fixture(scope="module")
def shard_inputs(system, cuda):
    """K4, K5, K6 and K7's arguments on the first shard with an offset."""
    cfg, dmap, _want = system
    with recording(detect, "peak_topk") as c4, \
            recording(detect, "localize") as c5, \
            recording(k6, "orient") as c6, \
            recording(describe, "descriptor_hist") as c7:
        pipeline.describe_grid(dmap, cfg, name="m",
                               mesh=make_mesh(4, devices=[cuda] * 4))
    first = lambda calls, i: next(a for a in calls if a[i] > 0)
    return dict(k4=first(c4, 7), k5=first(c5, 5), k6=first(c6, 11),
                k7=first(c7, 11))


def launched(mod, fn, *args):
    before = mod.launches
    out = fn(*args)
    assert mod.launches == before + 1
    return out


def test_k4_offset_form(shard_inputs):
    args = shard_inputs["k4"]
    v1, i1 = launched(k4, k4.peak_topk, *args)
    v2, i2 = k4.peak_topk_plain(*args)
    assert len(i1) > 0 and torch.equal(v1, v2) and torch.equal(i1, i2)
    Y, Z = args[0].shape[1:]
    rows = int(args[6])
    assert i1.dtype == torch.int64
    assert bool(((i1 // (Y * Z) >= args[7])
                 & (i1 // (Y * Z) < args[7] + rows)).all())


def test_k5_offset_form(shard_inputs):
    args = shard_inputs["k5"]
    got = launched(k5, k5.localize, *args)
    ref = k5.localize_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert int(got[2].sum()) > 0


def test_k6_offset_form(shard_inputs):
    args = shard_inputs["k6"]
    got = launched(k6, k6.orient, *args)
    again = k6.orient(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    share, dmax, close = orient_agreement(got, k6.orient_plain(*args), 1e-6)
    assert int(got[3].sum()) > 0
    assert share >= 0.99 and close, (share, dmax)


def test_k7_offset_form(shard_inputs):
    args = shard_inputs["k7"]
    d1, ok1 = launched(k7, k7.descriptor_hist, *args)
    d2, ok2 = k7.descriptor_hist_plain(*args)
    assert torch.equal(ok1, ok2) and int(ok1.sum()) > 0
    l1 = (d1.long() - d2.long()).abs().sum(dim=1)
    assert float((l1 == 0).float().mean()) >= 0.99 and int(l1.max()) <= 8


@pytest.mark.parametrize("n", [3, 4])
def test_describe_grid_on_shards_of_one_card(system, cuda, n):
    from mad_tpu_torch.kernels import launch_counts, reset_launches
    cfg, dmap, want = system
    reset_launches()
    got = pipeline.describe_grid(dmap, cfg, name="m",
                                 mesh=make_mesh(n, devices=[cuda] * n))
    counts = launch_counts()
    for name in ("conv1d", "upsample2", "gradient", "peak_mask_compact",
                 "localize", "orient", "descriptor_hist"):
        assert counts[name] > 0, name
    assert got.n == want.n > 0
    assert torch.equal(got.desc, want.desc)
    assert torch.equal(got.desc_norm, want.desc_norm)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)


def test_sharded_log_on_the_card(cuda):
    rng = np.random.default_rng(2)
    vol = torch.tensor(rng.random((40, 24, 20)).astype(np.float32),
                       device=cuda)
    mesh = make_mesh(4, devices=[cuda] * 4)
    log_s, gauss_s = ShardedOctave(split_x(vol, mesh), 1.0, False,
                                   ScaleSpaceConfig(detect_sigma=2.0),
                                   mesh).log_gauss()
    log_w, gauss_w = log_filter3d(vol, 2.0)
    assert torch.equal(torch.cat(log_s), log_w)
    assert torch.equal(torch.cat(gauss_s), gauss_w)


def test_describe_grid_on_two_cards(system):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    cfg, dmap, want = system
    with recording(detect, "peak_topk") as c4, \
            recording(describe, "descriptor_hist") as c7:
        got = pipeline.describe_grid(dmap, cfg, name="m", mesh=make_mesh(2))
    cards = {torch.device("cuda", 0), torch.device("cuda", 1)}
    assert {a[0].device for a in c4} == cards
    assert {a[0].device for a in c7} == cards
    assert got.desc.device == torch.device("cuda", 0)
    assert got.n == want.n > 0
    assert torch.equal(got.desc, want.desc)
    assert torch.equal(got.desc_norm, want.desc_norm)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
