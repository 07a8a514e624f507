"""K2 (x2 upsample, one launch for all three axes) and K3 (the
plane-marching gradient field) against their plain PyTorch versions on
the card, at ragged shapes: axes of 1, 2 and 3 samples, tiles and
footprints cut short on every axis, x chunks that end one plane after a
chunk boundary, also through the 64-bit offset path. Every test here
needs a CUDA card and skips without one;
the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_stencils_cuda.py

Tolerance: bit for bit, the sign of zeros included (each kernel rounds
every product, sum and difference as its plain version does; the
bfloat16 field rounds the same float32 differences to nearest even). The
CPU renderings of the two tilings are in tests/test_torch_stencils.py.
"""

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import MadConfig
from mad_tpu_torch.engine import pipeline
from mad_tpu_torch.kernels import gradient as k3
from mad_tpu_torch.kernels import upsample as k2
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.testing import make_assembly

pytestmark = pytest.mark.cuda

K2_SHAPES = ((1, 1, 1), (1, 2, 3), (3, 1, 2), (2, 3, 1), (2, 2, 2),
             (2, 5, 3), (9, 17, 35), (5, 9, 67), (8, 16, 64), (13, 2, 70))
K3_SHAPES = ((2, 2, 2), (2, 9, 33), (3, 2, 2), (35, 10, 37), (33, 9, 65),
             (65, 2, 3), (64, 8, 32), (97, 17, 40))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def volume(shape, seed, device):
    """Normal values with a quarter of them +0.0 or -0.0, so the sign of
    zero differences shows."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=shape).astype(np.float32)
    zero = rng.random(shape) < 0.25
    v[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    return torch.tensor(v, device=device)


def bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def test_k2_bitwise_at_ragged_shapes(cuda):
    for i, shape in enumerate(K2_SHAPES):
        vol = volume(shape, i, cuda)
        before = k2.launches
        got = k2.upsample2(vol)
        assert k2.launches == before + 1
        ref = k2.upsample2_plain(vol)
        assert got.shape == tuple(2 * n - 1 for n in shape)
        assert torch.equal(bits(got), bits(ref)), shape


def test_k2_on_a_strided_view_and_a_side_stream(cuda):
    """A non-contiguous input (made contiguous by the wrapper) and a
    launch on a side stream give the same bits."""
    base = volume((20, 30, 40), 7, cuda)
    view = base.transpose(0, 2)[3:, 1:, :]
    ref = k2.upsample2_plain(view.contiguous())
    assert torch.equal(bits(k2.upsample2(view)), bits(ref))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = k2.upsample2(base)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(bits(got), bits(k2.upsample2_plain(base)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_bitwise_at_ragged_shapes(cuda, dtype):
    for i, shape in enumerate(K3_SHAPES):
        vol = volume(shape, 20 + i, cuda)
        before = k3.launches
        got = k3.gradient(vol, dtype)
        assert k3.launches == before + 1
        ref = k3.gradient_plain(vol, dtype)
        assert got.dtype == dtype and got.shape == shape + (3,)
        assert torch.equal(bits(got), bits(ref)), shape


def test_wide_offsets_at_ragged_shapes(cuda, monkeypatch):
    """The 64-bit offset instantiations, which the wrappers take from
    ``WIDE_FROM`` elements on (2^32 on the path), forced at small
    shapes."""
    monkeypatch.setattr(k2, "WIDE_FROM", 0)
    monkeypatch.setattr(k3, "WIDE_FROM", 0)
    for i, shape in enumerate(K2_SHAPES):
        vol = volume(shape, 40 + i, cuda)
        assert torch.equal(bits(k2.upsample2(vol)),
                           bits(k2.upsample2_plain(vol))), shape
    for i, shape in enumerate(K3_SHAPES):
        vol = volume(shape, 60 + i, cuda)
        for dtype in (torch.float32, torch.bfloat16):
            assert torch.equal(bits(k3.gradient(vol, dtype)),
                               bits(k3.gradient_plain(vol, dtype))), shape


def test_describe_grid_launches_k2_once_an_upsampled_octave(cuda):
    cfg = MadConfig()
    _sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, device=cuda,
                            masses=masses).reduce_void()
    k2.launches = k3.launches = 0
    ds = pipeline.describe_grid(dmap, cfg, device=cuda)
    assert ds.n > 0
    assert k2.launches == 1 and k3.launches == 2
