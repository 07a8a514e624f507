"""K1's fused LoG and batched blur, plain versions on the CPU.

``kernels/conv1d.log_gauss_plain`` is the plain version of the three-pass
LoG kernel: it must be the unfused sequence that ``log_filter3d`` ran
before the fusion (nine shift-adds, then add, add_, neg_, mul_, clamp_),
bit for bit, and within test_torch_filters.py's tolerance of mad_tpu's
``log_filter3d``. The batched 'full' blur of ``ops/simulate.py`` must be
the per-structure loop bit for bit. Inputs come from a numpy seed.
Tolerance against mad_tpu: max abs error <= 1e-5 * max|ref| (the same
float32 sums in the same order; a contracted multiply-add on either side
can move a last bit).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mad_tpu.ops import convolve as jcv
from mad_tpu_torch.kernels import build, conv1d
from mad_tpu_torch.ops import convolve as tcv
from mad_tpu_torch.ops import simulate as tsim

torch.set_num_threads(1)

REL = 1e-5


def _bits(t):
    return t.contiguous().view(torch.int32)


def _vol(seed, shape):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, dtype=np.float32)
    # a block of signal in a zero field: zeros of both signs come out
    x, y, z = (s // 4 for s in shape)
    vol[x:-x, y:-y, z:-z] = np.abs(rng.normal(
        size=(shape[0] - 2 * x, shape[1] - 2 * y, shape[2] - 2 * z)))
    return torch.as_tensor(vol)


def unfused(vol, sigma, truncate=4.0):
    """ops/convolve.py's log_filter3d before the fusion."""
    c = conv1d.conv1d_along_plain
    g0 = tcv.gaussian_kernel1d(sigma, 0, truncate)
    g2 = tcv.gaussian_kernel1d(sigma, 2, truncate)
    ax = c(vol, g0, 0)
    axy = c(ax, g0, 1)
    gauss = c(axy, g0, 2)
    lap = c(axy, g2, 2)
    term = c(c(ax, g2, 1), g0, 2)
    x = c(c(c(vol, g2, 0), g0, 1), g0, 2)
    lap = torch.add(x, term).add_(lap)
    return torch.clamp_(lap.neg_().mul_(sigma ** 2), min=0.0), gauss


@pytest.mark.parametrize("sigma", [1.0, 2.0, 3.0])
def test_fused_plain_is_the_unfused_sequence(sigma):
    for shape in ((27, 25, 23), (28, 26, 24)):          # odd and even
        vol = _vol(int(sigma * 10), shape)
        g0 = tcv.gaussian_kernel1d(sigma, 0)
        g2 = tcv.gaussian_kernel1d(sigma, 2)
        got = conv1d.log_gauss_plain(vol, g0, g2, sigma)
        ref = unfused(vol, sigma)
        # bits, so the sign of the zero field's zeros counts too
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b))


def test_fused_plain_is_close_to_mad_tpu():
    vol = _vol(5, (29, 26, 27))
    got = tcv.log_filter3d(vol.clone(), 2.0)
    ref = jcv.log_filter3d(jnp.asarray(vol.numpy()), 2.0)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a.numpy() - b).max()) <= REL * scale


def test_log_filter3d_hands_its_volume_to_the_entry(monkeypatch):
    seen = []

    def spy(vol, g0, g2, sigma):
        seen.append((type(vol), len(vol)))
        return conv1d.log_gauss_plain(vol, g0, g2, sigma)
    monkeypatch.setattr(tcv, "log_gauss", spy)
    vol = _vol(6, (20, 21, 22))
    got = tcv.log_filter3d(vol, 2.0)
    assert seen == [(list, 1)]
    for a, b in zip(got, unfused(vol, 2.0)):
        assert torch.equal(_bits(a), _bits(b))


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")
    monkeypatch.setattr(build, "library", no_library)
    before = (conv1d.launches, conv1d.log_launches)
    vol = _vol(7, (19, 18, 17))
    held = [vol.clone()]
    g0, g2 = tcv.gaussian_kernel1d(2.0, 0), tcv.gaussian_kernel1d(2.0, 2)
    got = conv1d.log_gauss(held, g0, g2, 2.0)
    assert held == []
    for a, b in zip(got, unfused(vol, 2.0)):
        assert torch.equal(_bits(a), _bits(b))
    batch = torch.stack([vol, vol.flip(0)])
    out = conv1d.conv1d_along(batch, g0, 1, "full")
    assert out.shape == (2, 19, 18 + 16, 17)
    assert (conv1d.launches, conv1d.log_launches) == before


def test_batched_full_blur_is_the_per_structure_loop():
    rng = np.random.default_rng(8)
    grids = torch.as_tensor(rng.random((3, 14, 12, 13)).astype(np.float32))
    taps = tsim._blur_taps(1.6, 5)
    got = tcv.separable_conv3d(grids, (taps, taps, taps), mode="full")
    ref = torch.stack([tcv.separable_conv3d(g, (taps, taps, taps),
                                            mode="full") for g in grids])
    assert got.shape == (3, 24, 22, 23)
    assert torch.equal(_bits(got), _bits(ref))


def test_simulate_batch_is_the_per_structure_loop(monkeypatch):
    rng = np.random.default_rng(9)
    coords = rng.uniform(0.0, 20.0, size=(3, 200, 3)).astype(np.float32)
    masses = rng.uniform(1.0, 16.0, size=(3, 200)).astype(np.float32)
    got, _ = tsim.batched_simulate(coords, masses, 8.0, 2.0, "cpu",
                                   isovalue=0.05)
    # the same batch with the blur taken one structure at a time
    real = tsim.separable_conv3d
    monkeypatch.setattr(tsim, "separable_conv3d", lambda g, k, mode: (
        torch.stack([real(x, k, mode=mode) for x in g])))
    ref, _ = tsim.batched_simulate(coords, masses, 8.0, 2.0, "cpu",
                                   isovalue=0.05)
    assert torch.equal(_bits(got), _bits(ref))
