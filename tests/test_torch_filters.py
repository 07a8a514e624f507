"""Port parity: the separable filters of mad_tpu_torch/ops/convolve.py
(Gaussian taps, Gaussian smoothing, the LoG, the x2 upsampling) against
mad_tpu/ops/convolve.py. Their 1D passes go through kernel K1, whose
wrapper tests/test_torch_convolve.py holds.

Inputs come from a numpy seed and go through both packages. Tolerance: max
abs error <= 1e-5 * max|ref| -- both sum the same float32 terms in the
same order, so only a contracted multiply-add on either side can move a
last bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mad_tpu.ops import convolve as jcv
from mad_tpu_torch.ops import convolve as tcv

torch.set_num_threads(1)

REL = 1e-5


def _close(got, ref):
    got = got.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= REL * scale


def _vol(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_gaussian_kernel1d_is_the_same_table():
    for sigma, order in [(1.0, 0), (2.0, 0), (2.0, 2), (1.5, 2), (1.6, 0)]:
        np.testing.assert_array_equal(tcv.gaussian_kernel1d(sigma, order),
                                      jcv.gaussian_kernel1d(sigma, order))


def test_gaussian_filter3d():
    vol = _vol(1, (24, 24, 24))
    _close(tcv.gaussian_filter3d(torch.as_tensor(vol), 2.0),
           jcv.gaussian_filter3d(jnp.asarray(vol), 2.0))


@pytest.mark.parametrize("sigma", [1.6, 2.0])
def test_log_filter3d(sigma):
    rng = np.random.default_rng(2)
    vol = np.zeros((28, 26, 27), dtype=np.float32)
    vol[8:20, 9:18, 10:19] = np.abs(rng.normal(size=(12, 9, 9)))
    log_t, gauss_t = tcv.log_filter3d(torch.as_tensor(vol), sigma)
    log_j, gauss_j = jcv.log_filter3d(jnp.asarray(vol), sigma)
    _close(log_t, log_j)
    _close(gauss_t, gauss_j)


def test_upsample2():
    vol = _vol(5, (11, 9, 13))
    _close(tcv.upsample2(torch.as_tensor(vol)),
           jcv.upsample2(jnp.asarray(vol)))
