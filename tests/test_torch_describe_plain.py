"""Port parity: the plain PyTorch versions of the describe stage's kernels
K2 (x2 upsample), K3 (gradient field), K5 (Newton localization) and K8
(keep-gather + unit rows) against the mad_tpu bodies they replace, on the
CPU. Inputs come from a numpy seed or are built by hand and go through
both packages. Tolerances:
  * K2: max abs error <= 1e-5 * max|ref| (tests/test_torch_filters.py: the
    same float32 terms summed in the same order);
  * K3: equal, float32 and bfloat16 (one subtraction and one exact halving
    per value, then one rounding to bfloat16 on both sides);
  * K5 (through detect_anchors): equal coords and valid flags, subvoxel
    coordinates within 1e-4 voxel (mad_tpu's determinant is an LU, the
    port's the cofactor formula);
  * K8: equal int16 rows and equal unit rows (integer squares sum exactly
    in float32 below 2^24).
The kernels themselves are held against these plain versions on the card
by tests/test_torch_describe_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.engine.pipeline import _compiled_gather_norm
from mad_tpu.ops import convolve as jcv
from mad_tpu.ops import detect as jdet
from mad_tpu_torch.core.config import DetectConfig
from mad_tpu_torch.kernels import gather_norm as k8
from mad_tpu_torch.kernels import gradient as k3
from mad_tpu_torch.kernels import localize as k5
from mad_tpu_torch.kernels import upsample as k2
from mad_tpu_torch.ops import convolve as tcv
from mad_tpu_torch.ops import detect as tdet

torch.set_num_threads(1)

REL, SUBVOX_TOL = 1e-5, 1e-4


def _vol(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_k2_upsample_plain_matches_mad_tpu():
    """Odd and even extents, and an axis of length 2 (one half sample,
    both of its outer taps replicated edges)."""
    for seed, shape in ((5, (11, 9, 13)), (6, (10, 12, 8)), (7, (2, 7, 6))):
        vol = _vol(seed, shape)
        got = tcv.upsample2(torch.as_tensor(vol)).numpy()
        ref = np.asarray(jcv.upsample2(jnp.asarray(vol)))
        assert got.shape == ref.shape == tuple(2 * n - 1 for n in shape)
        assert np.abs(got - ref).max() <= REL * np.abs(ref).max()
        # the original samples land on the even indices unchanged
        np.testing.assert_array_equal(got[::2, ::2, ::2], vol)


def test_k3_gradient_plain_matches_jnp_gradient():
    """float32 as jnp.gradient stacked; bfloat16 as _grad_body's
    per-axis jnp.gradient(...).astype(bfloat16)."""
    vol = _vol(8, (9, 7, 2))
    t = torch.as_tensor(vol)
    got = k3.gradient_plain(t).numpy()
    ref = np.stack(jnp.gradient(jnp.asarray(vol)), axis=-1)
    np.testing.assert_array_equal(got, ref)
    got = k3.gradient_plain(t, torch.bfloat16).to(torch.float32).numpy()
    ref = np.stack([np.asarray(jnp.gradient(jnp.asarray(vol), axis=a)
                               .astype(jnp.bfloat16).astype(jnp.float32))
                    for a in range(3)], axis=-1)
    np.testing.assert_array_equal(got, ref)


# -- K5 ---------------------------------------------------------------------

N = 24
# A rotated anisotropic Gaussian whose discrete maximum (13, 12, 12) lies
# more than max_offset from the Newton solution along x: the peak walks to
# (12, 12, 12) and is accepted there.
WALK_A = np.array([[0.0611, -0.0287, -0.0343],
                   [-0.0287, 0.1014, 0.0185],
                   [-0.0343, 0.0185, 0.1305]])
WALK_MU = np.array([12.296, 11.731, 11.552])


def _blob(mu):
    g = np.stack(np.meshgrid(*[np.arange(N)] * 3, indexing="ij"), -1) - mu
    return np.exp(-np.einsum("...i,ij,...j->...", g, WALK_A, g)
                  ).astype(np.float32)


def _plateau():
    """A 3x3x3 block of equal peaks: the centre's Hessian is zero (bad)."""
    vol = np.zeros((N, N, N), np.float32)
    vol[10:13, 10:13, 10:13] = 1.0
    return vol


def _saddle():
    """A peak whose xy coupling gives its Hessian a positive eigenvalue:
    accepted at once (zero gradient), then rejected as a saddle."""
    vol = np.zeros((N, N, N), np.float32)
    c = (12, 12, 12)
    vol[c] = 1.0
    for a in range(3):
        for d in (-1, 1):
            p = list(c)
            p[a] += d
            vol[tuple(p)] = 0.9
    vol[13, 13, 12] = vol[11, 11, 12] = 0.99
    return vol


CASES = {
    "plateau": (_plateau, None),
    "saddle": (_saddle, None),
    "walk": (lambda: _blob(WALK_MU), (12, 12, 12)),
    # the same peak at x = 1: its walk toward x = 0 is clamped (pos - 1 > 0
    # fails), so it never converges
    "border_clamp": (lambda: _blob(WALK_MU - [12, 0, 0]), (1, 12, 12)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k5_localize_plain_matches_mad_tpu(case):
    build, want = CASES[case]
    vol = build()
    jcfg = dataclasses.replace(JConfig().detect, exclude_border=1)
    a = jdet.detect_anchors(jnp.asarray(vol), vol.shape, jcfg)
    vals = np.asarray(a.values)
    n = int(np.sum(vals > jcfg.threshold_abs))
    t = tdet.detect_anchors(torch.as_tensor(vol), vol.shape,
                            DetectConfig(**dataclasses.asdict(jcfg)))
    assert t.n == n > 0
    coords = np.asarray(a.coords)[:n]
    valid = np.asarray(a.valid)[:n]
    np.testing.assert_array_equal(t.coords.numpy(), coords)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    assert np.abs(t.subvox.numpy() - np.asarray(a.subvox)[:n]).max() \
        <= SUBVOX_TOL
    seed = np.unravel_index(np.argmax(vol), vol.shape)
    if case == "plateau":
        # 27 seeds; the centre's and those that walk onto it end bad
        centre = (coords == 11).all(axis=1)
        assert n == 27 and centre.sum() > 1 and not valid[centre].any()
    elif case == "saddle":
        assert n == 1 and tuple(coords[0]) == seed and not valid[0]
    elif case == "walk":
        assert n == 1 and tuple(coords[0]) == want != seed and valid[0]
    else:
        assert n == 1 and tuple(coords[0]) == want == seed and not valid[0]


# -- K8 ---------------------------------------------------------------------

def _tables(seed=9, D=1024):
    """Two octaves' int16 count tables (rows summing to <= 4096, as at
    patch_size 16), one zero row each, and sorted keep indices."""
    rng = np.random.default_rng(seed)
    tabs, keeps = [], []
    for L, n in ((40, 23), (25, 17)):
        t = rng.multinomial(4096, np.full(D, 1.0 / D), size=L)
        t[rng.random(L) < 0.2] //= 7
        t[3] = 0
        tabs.append(t.astype(np.int16))
        keeps.append(np.sort(np.r_[3, rng.choice(np.arange(4, L), n - 1,
                                                   replace=False)]))
    return tabs, keeps


def test_k8_gather_norm_plain_matches_mad_tpu():
    tabs, keeps = _tables()
    total = sum(len(k) for k in keeps)
    kb = 128
    idx = np.zeros((2, kb), np.int32)
    msk = np.zeros((2, kb), bool)
    at = 0
    for o, k in enumerate(keeps):
        idx[o, at:at + len(k)] = k
        msk[o, at:at + len(k)] = True
        at += len(k)
    jd, jn = _compiled_gather_norm(tuple(t.shape[0] for t in tabs), kb)(
        *[jnp.asarray(t) for t in tabs], idx, msk)
    desc, unit = k8.gather_norm_plain(
        [torch.as_tensor(t) for t in tabs], [torch.as_tensor(k)
                                            for k in keeps])
    np.testing.assert_array_equal(desc.numpy(), np.asarray(jd)[:total])
    np.testing.assert_array_equal(unit.numpy(), np.asarray(jn)[:total])
    assert not unit[0].any() and not unit[len(keeps[0])].any()
    # the cache loader's identity gather: every row, in order
    d2, u2 = k8.gather_norm_plain([desc], [torch.arange(total)])
    assert torch.equal(d2, desc) and torch.equal(u2, unit)


def test_cpu_tensors_take_the_plain_versions():
    for mod in (k2, k3, k5, k8):
        mod.launches = 0
    vol = torch.as_tensor(_vol(10, (6, 5, 7)))
    assert torch.equal(k2.upsample2(vol), k2.upsample2_plain(vol))
    assert torch.equal(k3.gradient(vol, torch.bfloat16),
                       k3.gradient_plain(vol, torch.bfloat16))
    seeds = torch.tensor([[2, 2, 3]])
    got = k5.localize(vol, seeds, vol.shape, 0.6, 5)
    ref = k5.localize_plain(vol, seeds, vol.shape, 0.6, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    tabs, keeps = _tables(D=64)
    args = ([torch.as_tensor(t) for t in tabs],
            [torch.as_tensor(k) for k in keeps])
    assert all(torch.equal(a, b) for a, b in zip(k8.gather_norm(*args),
                                                 k8.gather_norm_plain(*args)))
    assert [m.launches for m in (k2, k3, k5, k8)] == [0, 0, 0, 0]
