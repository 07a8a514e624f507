"""Port parity: gather interpolation (mad_tpu_torch/ops/interp.py) against
mad_tpu/ops/interp.py. ``nearest`` samples the descriptors (kernel K7 uses
the same rule), ``trilinear`` the refinement's gradient field.

Required: ``nearest`` exactly equal, .5 ties going to the lower index;
``trilinear`` within 1e-6 (float32 weights, products summed in the same
corner order).
"""

import numpy as np
import jax.numpy as jnp
import torch

from mad_tpu.ops import interp as jinterp
from mad_tpu_torch.ops import interp as tinterp

torch.set_num_threads(1)


def test_nearest_half_voxel_ties_go_down():
    field = np.random.default_rng(5).normal(size=(6, 7, 8, 3)).astype(
        np.float32)
    pts = np.array([[1.5, 2.5, 3.5], [0.5, 0.5, 0.5], [4.5, 5.0, 6.49],
                    [-0.5, 6.5, 7.5], [2.0, 3.51, 1.5]], dtype=np.float32)
    ref = np.asarray(jinterp.nearest(jnp.asarray(field), jnp.asarray(pts)))
    got = tinterp.nearest(torch.tensor(field), torch.tensor(pts)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], field[1, 2, 3])


def test_trilinear_matches():
    rng = np.random.default_rng(6)
    field = rng.normal(size=(9, 8, 10, 3)).astype(np.float32)
    pts = (rng.random((50, 3)) * [9, 8, 10] - 0.5).astype(np.float32)
    ref = np.asarray(jinterp.trilinear(jnp.asarray(field), jnp.asarray(pts)))
    got = tinterp.trilinear(torch.tensor(field), torch.tensor(pts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
