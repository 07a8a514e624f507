"""K6 (orientation) and K15 (refinement) against their plain PyTorch
versions, on the card. Every test here needs a CUDA card and skips without
one; the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_orient_refine_cuda.py

Tolerances:
  * K6, at patch sizes 12, 16 and 24, with and without a Gaussian window:
    lane validity, main and secondary bins equal on >= 99 % of the
    anchors (a direction within an ulp of a 4-decimal zone bound may bin
    differently if the card's atan2f / acosf and PyTorch's differ; with a
    Gaussian window the plain version's float sums of the weights may also
    round a quantized bin the other way), frames within 1e-6 on the
    agreeing anchors' valid lanes; two launches give equal outputs;
  * K15: final CA-RMSD to the plain version <= 0.5 A for every candidate
    and <= 0.05 A in the median, the same failed flags (the kernel sums
    the forces in another order, and a last-bit difference can flip a step
    halving); with every candidate frozen after its first step, equal
    counts and poses within 1e-5.
The parity of the plain versions with mad_tpu is held on the CPU by
tests/test_torch_orient_describe.py and tests/test_torch_refine.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import MadConfig, RefineConfig
from mad_tpu_torch.engine.refine import refine_inputs
from mad_tpu_torch.kernels import orient as k6
from mad_tpu_torch.kernels import refine as k15
from mad_tpu_torch.ops.detect import detect_anchors
from mad_tpu_torch.ops.orient import _OrientTables
from mad_tpu_torch.ops.scalespace import gradient, iter_octaves
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.testing import (ca_rmsds, make_assembly, make_protein,
                                   orient_agreement)

pytestmark = pytest.mark.cuda

ANCHORS_AGREE, RFINAL_TOL = 0.99, 1e-6
POSE_MAX, POSE_MEDIAN = 0.5, 0.05


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def octaves(cuda):
    """Per octave of a small two-copy map: its gradient field and its
    detected anchors."""
    cfg = MadConfig()
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 max_anchors=1024))
    _sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, device=cuda,
                            masses=masses).reduce_void()
    out = {}
    for _org, o in iter_octaves(dmap, cfg.scalespace):
        log_vol, gauss = o.log_gauss()
        anch = detect_anchors(log_vol, o.real_shape, cfg.detect)
        grad = gradient(gauss, o.grad_dtype())
        out["up" if o.upsampled else "base"] = (o, grad,
                                                anch.coords[anch.valid])
    return cfg, out


def with_edges(o, coords, half):
    """The anchors plus six more: on and just outside each side of the
    border test at ``half`` voxels, one on the far face, and one in the
    middle flagged invalid. Returns (coords, valid)."""
    rs = np.asarray(o.real_shape)
    mid = rs // 2
    edge = np.stack([np.r_[half, mid[1:]], np.r_[half - 1, mid[1:]],
                     np.r_[mid[0], rs[1] - half - 2, mid[2]],
                     np.r_[mid[0], rs[1] - half - 1, mid[2]],
                     np.r_[mid[:2], rs[2] - 1], mid])
    kc = torch.cat([coords, torch.as_tensor(edge, device=coords.device)])
    valid = torch.ones(kc.shape[0], dtype=torch.bool, device=kc.device)
    valid[-1] = False
    return kc, valid


# (octave, patch size, Gaussian window sigma): the default patch on both
# octaves, the smaller and larger patches users run (patch 24 is the 5kuh
# setting), and a Gaussian window (weights that are not 0 or 1).
K6_CASES = [("up", 16, 0.0), ("base", 16, 0.0), ("base", 12, 3.0),
            ("base", 24, 0.0)]


@pytest.mark.parametrize("octave,patch,gw_sig", K6_CASES,
                         ids=["up", "base", "base-patch12-gw3",
                              "base-patch24"])
def test_k6_matches_plain(octaves, octave, patch, gw_sig):
    cfg, out = octaves
    o, grad, coords = out[octave]
    oc = dataclasses.replace(cfg.orient, patch_size=patch, gw_sig=gw_sig)
    radius = patch // 2
    stride = 2 if o.upsampled else 1
    kc, valid = with_edges(o, coords, radius * stride)
    tab = _OrientTables(oc, radius, stride, grad.device)
    args = (grad, kc, valid, o.real_shape, tab, radius, stride, oc.max_main,
            oc.max_sec, oc.cutoff_magn)
    before = k6.launches
    got = k6.orient(*args)
    again = k6.orient(*args)
    torch.cuda.synchronize()
    assert k6.launches == before + 2
    for a, b in zip(got, again):        # integer atomics: deterministic
        assert torch.equal(a, b)
    ref = k6.orient_plain(*args)
    share, dmax, close = orient_agreement(got, ref, RFINAL_TOL)
    assert share >= ANCHORS_AGREE and close, (share, dmax)
    assert int(ref[3].any(dim=(1, 2)).sum()) >= 5
    # the border anchors: in at (c - half = 0, c + half + 1 = rs - 1), out
    # one voxel further, on the far face and when flagged invalid
    assert not bool(got[3][-5].any()) and not bool(got[3][-3].any())
    assert not bool(got[3][-2].any()) and not bool(got[3][-1].any())
    torch.testing.assert_close(got[3][-6], ref[3][-6], rtol=0, atol=0)
    torch.testing.assert_close(got[3][-4], ref[3][-4], rtol=0, atol=0)


@pytest.fixture(scope="module")
def refine_system(cuda):
    p = make_protein(n_res=30, seed=2, n_segments=2)
    dmap = simulate_density(p, 8.0, 2.0, device=cuda).reduce_void(8)
    rng = np.random.default_rng(3)
    center = p.coords.mean(axis=0)
    starts = []
    for i in range(12):
        ang = np.deg2rad(2.0 + 2.0 * i)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        starts.append((p.coords - center) @ R + center
                      + rng.normal(scale=0.5 + 0.3 * i, size=3))
    starts = np.stack(starts).astype(np.float32)
    starts[5, 7] = np.nan              # a numerically failing candidate
    return p, dmap, starts


def test_k15_matches_plain(refine_system):
    p, dmap, starts = refine_system
    args = refine_inputs(dmap, starts, dmap.device)
    cfg = RefineConfig()
    before = k15.launches
    got = k15.refine_loop(*args, cfg)
    torch.cuda.synchronize()
    assert k15.launches == before + 1
    ref = k15.refine_loop_plain(*args, cfg)
    failed = ref[5].cpu().numpy()
    np.testing.assert_array_equal(got[5].cpu().numpy(), failed)
    assert failed[5] and not failed[:5].any() and not failed[6:].any()
    d = ca_rmsds(got[2].cpu().numpy(), ref[2].cpu().numpy(), p.ca_idx)[
        ~failed]
    assert d.max() <= POSE_MAX and np.median(d) <= POSE_MEDIAN, d
    # and the kernel lands on the deposited pose
    assert ca_rmsds(got[2].cpu().numpy()[:5], p.coords[None],
                    p.ca_idx).max() < 1.0


@pytest.mark.parametrize("cfg", [RefineConfig(n_steps=0),
                                 RefineConfig(max_step=0.05, min_step=0.1)],
                         ids=["no_steps", "frozen_after_one"])
def test_k15_frozen_at_start(refine_system, cfg):
    _p, dmap, starts = refine_system
    args = refine_inputs(dmap, starts[:4], dmap.device)
    got = k15.refine_loop(*args, cfg)
    ref = k15.refine_loop_plain(*args, cfg)
    for a, b in zip(got[3:], ref[3:]):          # frozen, steps, failed
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(got[4].max()) == min(cfg.n_steps, 1)
    for a, b in zip(got[:3], ref[:3]):          # rot, trans, coords
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_wrappers_reject_mixed_devices_and_strides(octaves, refine_system):
    cfg, out = octaves
    o, grad, coords = out["base"]
    kc, valid = with_edges(o, coords, 8)
    oc = cfg.orient
    tab = _OrientTables(oc, 8, 1, grad.device)
    with pytest.raises(ValueError):
        k6.orient(grad, kc.cpu(), valid, o.real_shape, tab, 8, 1,
                  oc.max_main, oc.max_sec, oc.cutoff_magn)
    with pytest.raises(ValueError):
        k6.orient(grad.transpose(0, 1), kc, valid, o.real_shape, tab, 8, 1,
                  oc.max_main, oc.max_sec, oc.cutoff_magn)
    _p, dmap, starts = refine_system
    field, y0, center, den, bounds = refine_inputs(dmap, starts, dmap.device)
    with pytest.raises(ValueError):
        k15.refine_loop(field, y0.cpu(), center, den, bounds, RefineConfig())
    with pytest.raises(ValueError):
        k15.refine_loop(field, y0.transpose(0, 1).contiguous().transpose(
            0, 1), center, den, bounds, RefineConfig())
