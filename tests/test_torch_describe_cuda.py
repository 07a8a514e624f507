"""K2 (x2 upsample), K3 (gradient field), K5 (Newton localization) and K8
(keep-gather + unit rows) against their plain PyTorch versions, on the
card, at the inputs the describe path gives them. Every test here needs a
CUDA card and skips without one; the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_describe_cuda.py

Inputs: the small two-copy map of tests/test_torch_kernels_cuda.py (8 A at
2 A), its two octaves. Tolerances: bit for bit (each kernel rounds every
product, sum and quotient as its plain version does; K8 sums integers),
except K8 at patch_size 24, whose rows may pass sum c^2 = 2^24 where the
plain version's float32 sum can round: unit rows within 1 ulp there. The
whole describe_grid must give the same DescriptorSet with the four kernels
as with their plain versions. The parity of the plain versions with
mad_tpu is held on the CPU by tests/test_torch_describe_plain.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu_torch.convert import descriptor_set_from_numpy
from mad_tpu_torch.core.config import MadConfig
from mad_tpu_torch.engine import pipeline
from mad_tpu_torch.kernels import gather_norm as k8
from mad_tpu_torch.kernels import gradient as k3
from mad_tpu_torch.kernels import localize as k5
from mad_tpu_torch.kernels import upsample as k2
from mad_tpu_torch.ops import detect, scalespace
from mad_tpu_torch.ops.scalespace import iter_octaves
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.testing import make_assembly, recording

pytestmark = pytest.mark.cuda

# (module, name, plain version): the four kernels' call sites on the path
SWAPS = ((scalespace, "upsample2", k2.upsample2_plain),
         (pipeline, "gradient", k3.gradient_plain),
         (detect, "localize_peaks", k5.localize_peaks_plain),
         (pipeline, "gather_norm", k8.gather_norm_plain))


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
    _sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, device=cuda,
                            masses=masses).reduce_void()
    return cfg, dmap


def launched(mod, fn, *args):
    before = mod.launches
    out = fn(*args)
    assert mod.launches == before + 1
    return out


def test_k2_upsample_bitwise(system):
    cfg, dmap = system
    _org, up = next(iter(iter_octaves(dmap, cfg.scalespace)))
    got = launched(k2, k2.upsample2, up.base)
    assert torch.equal(got, k2.upsample2_plain(up.base))
    assert tuple(got.shape) == up.real_shape
    # an axis of length 2 and one of length 1
    small = up.base[:2, :1, :9]
    assert torch.equal(k2.upsample2(small), k2.upsample2_plain(small))


def test_k3_gradient_bitwise(system):
    cfg, dmap = system
    for _org, octv in iter_octaves(dmap, cfg.scalespace):
        _log, gauss = octv.log_gauss()
        for dtype in (torch.float32, torch.bfloat16):
            got = launched(k3, k3.gradient, gauss, dtype)
            assert got.dtype == dtype
            assert torch.equal(got, k3.gradient_plain(gauss, dtype))
    tiny = gauss[:2, :3, :2]
    assert torch.equal(k3.gradient(tiny), k3.gradient_plain(tiny))


def test_k5_localize_bitwise(system):
    """The LoG volumes of both octaves with K4's peaks, as detect_anchors
    passes them (the flat form), and the offset form on their seeds."""
    cfg, dmap = system
    with recording(detect, "localize_peaks") as calls:
        pipeline.describe_grid(dmap, cfg, device=dmap.device)
    assert len(calls) == 2
    goods = []
    for args in calls:
        got = launched(k5, k5.localize_peaks, *args)
        ref = k5.localize_peaks_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        goods.append(ref[2])
        vol, flat, vals, real, thr, eb, mo, n = args
        walk = (vol, k5.flat_seeds(flat, vol.shape, real, eb), real, mo, n)
        got = launched(k5, k5.localize, *walk)
        assert all(torch.equal(a, b)
                   for a, b in zip(got, k5.localize_plain(*walk)))
    good = torch.cat(goods)
    assert int(good.sum()) > 10 and not bool(good.all())
    # no iteration: nothing accepted, positions the seeds
    vol, flat, vals, real, thr, eb, mo, _n = calls[0]
    seeds = k5.flat_seeds(flat, vol.shape, real, eb)
    pos, _sub, good = k5.localize_peaks(vol, flat, vals, real, thr, eb, mo,
                                        0)
    assert torch.equal(pos, seeds) and not bool(good.any())
    pos, _sub, good = k5.localize(vol, seeds, real, mo, 0)
    assert torch.equal(pos, seeds) and not bool(good.any())


def test_k8_gather_norm_bitwise(system, cuda):
    cfg, dmap = system
    with recording(pipeline, "gather_norm") as calls:
        pipeline.describe_grid(dmap, cfg, device=dmap.device)
    (tables, keeps), = calls
    assert len(tables) == 2 and all(len(k) > 10 for k in keeps)
    got = launched(k8, k8.gather_norm, tables, keeps)
    ref = k8.gather_norm_plain(tables, keeps)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    # the cache loader's identity gather, with a zero row
    desc = got[0].clone()
    desc[1] = 0
    n = desc.shape[0]
    z3, z = np.zeros((n, 3)), np.zeros(n, np.int32)
    before = k8.launches
    ds = descriptor_set_from_numpy(desc.cpu().numpy(), z3, z3, z3,
                                   np.zeros((n, 3, 3)), z, z, z, z,
                                   device=cuda)
    assert k8.launches == before + 1
    ref = k8.gather_norm_plain([desc], [torch.arange(n, device=cuda)])
    assert torch.equal(ds.desc, desc) and torch.equal(ds.desc_norm, ref[1])
    assert not ds.desc_norm[1].any()


def test_k8_patch_24_within_one_ulp(system, cuda):
    """The 5kuh setting (patch_size 24, 13,824 samples a row), plus rows
    whose squares pass 2^24 but sum exactly in float32."""
    cfg, dmap = system
    cfg = cfg.replace(describe=dataclasses.replace(cfg.describe,
                                                   patch_size=24),
                      orient=dataclasses.replace(cfg.orient, patch_size=24))
    with recording(pipeline, "gather_norm") as calls:
        pipeline.describe_grid(dmap, cfg, device=cuda)
    (tables, keeps), = calls
    big = torch.zeros((3, tables[0].shape[1]), dtype=torch.int16,
                      device=cuda)
    big[0, 0], big[0, 1:17] = 2048, 1024          # 2^22 + 16 * 2^20
    big[1, :4] = 4096                             # 4 * 2^24
    tables = list(tables) + [big]
    keeps = list(keeps) + [torch.arange(3, device=cuda)]
    d1, u1 = k8.gather_norm(tables, keeps)
    d2, u2 = k8.gather_norm_plain(tables, keeps)
    assert torch.equal(d1, d2)
    ulps = (u1.view(torch.int32) - u2.view(torch.int32)).abs()
    assert int(ulps.max()) <= 1
    assert torch.equal(u1[-3:], u2[-3:])


def test_describe_grid_same_with_the_plain_versions(system, monkeypatch):
    cfg, dmap = system
    for mod in (k2, k3, k5, k8):
        mod.launches = 0
    a = pipeline.describe_grid(dmap, cfg, device=dmap.device)
    assert all(m.launches > 0 for m in (k2, k3, k5, k8))
    for mod, name, fn in SWAPS:
        monkeypatch.setattr(mod, name, fn)
    counts = [m.launches for m in (k2, k3, k5, k8)]
    b = pipeline.describe_grid(dmap, cfg, device=dmap.device)
    assert [m.launches for m in (k2, k3, k5, k8)] == counts
    assert a.n == b.n > 50
    assert torch.equal(a.desc, b.desc) and torch.equal(a.desc_norm,
                                                       b.desc_norm)
    for key in ("coords", "subv_coords", "rfinal", "anchor_id"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))


def test_wrappers_reject_what_they_do_not_take(cuda):
    vol = torch.zeros((4, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        k2.upsample2(vol.double())
    with pytest.raises(ValueError):
        k3.gradient(vol[:1], torch.float32)
    with pytest.raises(ValueError):
        k3.gradient(vol, torch.float16)
    with pytest.raises(ValueError):
        k5.localize(vol, torch.ones((2, 3), dtype=torch.int32, device=cuda),
                    vol.shape, 0.6, 5)
    with pytest.raises(ValueError):
        k8.gather_norm([torch.zeros((3, 8), dtype=torch.int32, device=cuda)],
                       [torch.arange(3, device=cuda)])
    with pytest.raises(ValueError):
        k8.gather_norm([torch.zeros((3, 8), dtype=torch.int16, device=cuda)],
                       [torch.arange(2)])
