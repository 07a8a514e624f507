"""Port parity: anchor detection (mad_tpu_torch/ops/detect.py and kernel K4,
mad_tpu_torch/kernels/peaks.py) against mad_tpu/ops/detect.py, fed the
same LoG volumes.

Required: the same anchor count, the same integer peaks in the same order
(response descending, ties by flat index), the same validity flags, and
subvoxel coordinates within 1e-4 voxel (both run the same float32 Newton
steps; only the determinant's summation order may differ).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.ops import detect as jdet
from mad_tpu.ops import scalespace as jss
from mad_tpu.ops import simulate as jsim
from mad_tpu.testing import make_assembly
from mad_tpu_torch.core.config import DetectConfig
from mad_tpu_torch.kernels import peaks as k4
from mad_tpu_torch.ops import detect as tdet

torch.set_num_threads(1)

SUBVOX_TOL = 1e-4


def _jax_anchors(log_np, real_shape, cfg):
    a = jdet.detect_anchors(jnp.asarray(log_np), tuple(real_shape), cfg)
    vals = np.asarray(a.values)
    n = int(np.sum(vals > cfg.threshold_abs))
    return (n, np.asarray(a.coords)[:n], np.asarray(a.subvox)[:n],
            vals[:n], np.asarray(a.valid)[:n])


def _check(log_np, real_shape, cfg):
    n, coords, subvox, vals, valid = _jax_anchors(log_np, real_shape, cfg)
    t = tdet.detect_anchors(torch.tensor(log_np), real_shape,
                            DetectConfig(**dataclasses.asdict(cfg)))
    assert t.n == n
    np.testing.assert_array_equal(t.coords.numpy(), coords)
    np.testing.assert_array_equal(t.values.numpy(), vals)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    assert np.abs(t.subvox.numpy() - subvox).max(initial=0.0) <= SUBVOX_TOL
    return n, int(valid.sum())


@pytest.fixture(scope="module")
def octave_logs():
    """Both octaves' LoG volumes of a small two-copy map (mad_tpu)."""
    sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    cfg = JConfig()
    dmap = jsim.simulate_density(coords, 8.0, 2.0, masses=masses
                                 ).reduce_void()
    return [(np.asarray(o.log()), tuple(o.real_shape))
            for _org, o in jss.iter_lazy_octaves(dmap, cfg.scalespace,
                                                 cfg.shape_bucket)]


@pytest.mark.parametrize("octave", [0, 1])
def test_map_octave_anchors(octave_logs, octave):
    log_np, real = octave_logs[octave]
    cfg = JConfig().detect
    # the port's own octave has no bucket padding: same anchors
    rx, ry, rz = real
    n_pad, nv = _check(log_np, real, cfg)
    n_real, _ = _check(np.ascontiguousarray(log_np[:rx, :ry, :rz]), real, cfg)
    assert n_pad == n_real and nv > 0


def test_capacity_cut_keeps_the_strongest(octave_logs):
    log_np, real = octave_logs[1]
    n_all, _ = _check(log_np, real, JConfig().detect)
    cfg = dataclasses.replace(JConfig().detect, max_anchors=n_all // 2)
    n, _ = _check(log_np, real, cfg)
    assert n == n_all // 2 > 0


def test_ties_at_the_capacity_cut_go_by_flat_index():
    """Equal isolated peaks, more than max_anchors: both keep the lowest
    flat indices, in flat-index order."""
    rng = np.random.default_rng(5)
    vol = np.zeros((40, 36, 34), dtype=np.float32)
    pts = np.stack(np.meshgrid(np.arange(13, 27, 3), np.arange(13, 23, 3),
                               np.arange(13, 21, 3), indexing="ij"),
                   -1).reshape(-1, 3)
    vol[pts[:, 0], pts[:, 1], pts[:, 2]] = 1.0
    # a few stronger ones, so the cut falls inside the tied block
    strong = pts[rng.choice(len(pts), 5, replace=False)]
    vol[strong[:, 0], strong[:, 1], strong[:, 2]] = 2.0
    cfg = dataclasses.replace(JConfig().detect, max_anchors=20)
    n, nv = _check(vol, vol.shape, cfg)
    assert n == 20 and nv == 20 and len(pts) > 20


def test_peak_plain_matches_jax_peak_set_on_noise():
    """Many peaks (smoothed noise) on a volume whose real extent is smaller
    than its buffer: the whole ordered peak list agrees."""
    from scipy import ndimage
    rng = np.random.default_rng(6)
    vol = ndimage.gaussian_filter(rng.normal(size=(48, 44, 40)), 1.2)
    vol = np.abs(vol).astype(np.float32)
    real = (45, 40, 40)
    cfg = dataclasses.replace(JConfig().detect, threshold_abs=0.01,
                              exclude_border=3, max_anchors=4096)
    n, _ = _check(vol, real, cfg)
    assert n > 50


def test_cpu_tensor_takes_the_plain_version():
    k4.launches = 0
    vol = torch.zeros((20, 20, 20))
    vol[10, 10, 10] = 1.0
    vals, idx = k4.peak_topk(vol, (20, 20, 20), 0.05, 3, 8)
    assert idx.tolist() == [10 * 400 + 10 * 20 + 10] and k4.launches == 0
