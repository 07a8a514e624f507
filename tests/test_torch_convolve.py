"""Port parity: kernel K1's wrapper (mad_tpu_torch/kernels/conv1d.py,
``conv1d_along``) against mad_tpu/ops/convolve.py's ``conv1d_along``; the
filters built on it are in tests/test_torch_filters.py.

Inputs come from a numpy seed and go through both packages. On the CPU the
port's K1 wrapper runs its plain version (the shift-add of
mad_tpu/ops/convolve.py:116-123, same tap order). Tolerance: max abs error
<= 1e-5 * max|ref| -- both sum the same float32 terms in the same order,
so only a contracted multiply-add on either side can move a last bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mad_tpu.ops import convolve as jcv
from mad_tpu_torch.kernels import conv1d as k1

torch.set_num_threads(1)

REL = 1e-5


def _close(got, ref):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= REL * scale


def _vol(seed, shape=(20, 18, 17)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["same", "full"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_conv1d_along(axis, mode):
    vol = _vol(axis + 3)
    k = jcv.gaussian_kernel1d(1.6, 0)
    k[2] = 0.0                      # a zero tap is skipped by both
    got = k1.conv1d_along(torch.as_tensor(vol), k, axis, mode)
    ref = jcv.conv1d_along(jnp.asarray(vol), k, axis, mode)
    _close(got, ref)


def test_conv1d_even_taps_same_mode():
    vol = _vol(7, (9, 11, 13))
    k = np.array([0.1, 0.4, 0.3, 0.2], dtype=np.float32)
    for axis in range(3):
        _close(k1.conv1d_along(torch.as_tensor(vol), k, axis, "same"),
               jcv.conv1d_along(jnp.asarray(vol), k, axis, "same"))


def test_cpu_tensor_takes_the_plain_version():
    k1.launches = 0
    vol = torch.as_tensor(_vol(9, (6, 7, 8)))
    k = np.array([0.25, 0.5, 0.25], dtype=np.float32)
    out = k1.conv1d_along(vol, k, 1, "full")
    assert out.shape == (6, 9, 8)
    torch.testing.assert_close(out, k1.conv1d_along_plain(vol, k, 1, "full"),
                               rtol=0, atol=0)
    assert k1.launches == 0
