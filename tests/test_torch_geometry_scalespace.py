"""The port's geometry (kabsch, rmsd, random_rotation), materialized scale
space (ScaleSpace / build_scale_space) and host copies of
core/metrics.py and core/eqsp_viz.py against mad_tpu's.

Tolerances: kabsch and rmsd in float64 within 1e-10 of mad_tpu's numpy
twin ``kabsch_np`` and of the numpy formula, and within 1e-5 of mad_tpu's
JAX functions, which run in float32 here (no x64); the octave fields
within 1e-5 of their maxima over the real shape (the octave tests'
REL, tests/test_torch_stencils.py); the host copies equal, the TCL file
byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mad_tpu.core import eqsp_viz as jviz
from mad_tpu.core import geometry as jgeo
from mad_tpu.core import metrics as jmetrics
from mad_tpu.core.config import ScaleSpaceConfig as JSS
from mad_tpu.core.eqsp import get_eqsp as jget_eqsp
from mad_tpu.core.grid import DensityGrid as JGrid
from mad_tpu.ops.scalespace import build_scale_space as jbuild
from mad_tpu_torch.core import eqsp_viz as tviz
from mad_tpu_torch.core import geometry as tgeo
from mad_tpu_torch.core import metrics as tmetrics
from mad_tpu_torch.core.config import ScaleSpaceConfig as TSS
from mad_tpu_torch.core.eqsp import get_eqsp as tget_eqsp
from mad_tpu_torch.core.grid import DensityGrid as TGrid
from mad_tpu_torch.ops.scalespace import ScaleSpace, build_scale_space

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5
REL = 1e-5


def _rigid_case(rng, lead=()):
    x = rng.normal(size=lead + (12, 3)) * 8.0
    R = np.linalg.qr(rng.normal(size=lead + (3, 3)))[0]
    R = R * np.sign(np.linalg.det(R))[..., None, None]
    T = rng.normal(size=lead + (3,)) * 5.0
    y = x @ R + T[..., None, :] + rng.normal(size=x.shape) * 0.1
    return x, y


def test_kabsch_and_rmsd():
    rng = np.random.default_rng(7)
    for lead in ((), (4,), (2, 3)):
        x, y = _rigid_case(rng, lead)
        R, T = tgeo.kabsch(torch.as_tensor(x), torch.as_tensor(y))
        Rn, Tn = jgeo.kabsch_np(x, y)
        assert R.dtype == torch.float64 and R.shape == lead + (3, 3)
        assert np.abs(R.numpy() - Rn).max() <= F64_TOL
        assert np.abs(T.numpy() - Tn).max() <= F64_TOL
        Rc, Tc = tgeo.kabsch_np(x, y)
        np.testing.assert_array_equal(Rc, Rn)
        np.testing.assert_array_equal(Tc, Tn)
        Rj, Tj = jgeo.kabsch(jnp.asarray(x, jnp.float32),
                             jnp.asarray(y, jnp.float32))
        R32, T32 = tgeo.kabsch(torch.as_tensor(x, dtype=torch.float32),
                               torch.as_tensor(y, dtype=torch.float32))
        assert np.abs(R32.numpy() - np.asarray(Rj)).max() <= F32_TOL
        assert np.abs(T32.numpy() - np.asarray(Tj)).max() <= 1e3 * F32_TOL
        r = tgeo.rmsd(torch.as_tensor(x), torch.as_tensor(y)).numpy()
        want = np.sqrt(((x - y) ** 2).sum(axis=(-1, -2)) / x.shape[-2])
        assert np.abs(r - want).max() <= F64_TOL
        rj = np.asarray(jgeo.rmsd(jnp.asarray(x, jnp.float32),
                                  jnp.asarray(y, jnp.float32)))
        assert np.abs(r - rj).max() <= F32_TOL * np.abs(want).max()
    # reflection guard (tests/test_geometry.py): a mirrored cloud still
    # gives a proper rotation
    x = rng.normal(size=(10, 3))
    y = x * np.array([1.0, 1.0, -1.0])
    R, _T = tgeo.kabsch(torch.as_tensor(x), torch.as_tensor(y))
    assert float(torch.linalg.det(R)) == pytest.approx(1.0, abs=1e-10)
    assert np.abs(R.numpy() - jgeo.kabsch_np(x, y)[0]).max() <= F64_TOL


def test_random_rotation_properties():
    """A proper rotation from a torch.Generator, reproducible by seed. It
    cannot reproduce mad_tpu's jax.random draw (another generator), and
    does not."""
    mats = []
    for seed in (0, 1, 2, 0):
        g = torch.Generator().manual_seed(seed)
        R = tgeo.random_rotation(g, device="cpu")
        assert R.shape == (3, 3) and R.device == torch.device("cpu")
        np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-6)
        assert float(torch.linalg.det(R)) == pytest.approx(1.0, abs=1e-6)
        mats.append(R)
    assert torch.equal(mats[0], mats[3])
    assert not torch.equal(mats[0], mats[1])
    jr = np.asarray(jgeo.random_rotation(jax.random.PRNGKey(0)))
    assert not np.allclose(mats[0].numpy(), jr, atol=1e-3)


def _blob(shape=(20, 18, 16), center=(10, 9, 8), sigma=2.5):
    xs = [np.arange(s, dtype=np.float64) for s in shape]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    r2 = ((X - center[0]) ** 2 + (Y - center[1]) ** 2
          + (Z - center[2]) ** 2)
    rng = np.random.default_rng(4)
    return (np.exp(-r2 / (2 * sigma ** 2))
            + 0.1 * rng.random(shape)).astype(np.float32)


@pytest.mark.parametrize("mode", ["both", "base"])
def test_build_scale_space_over_the_real_shape(mode):
    """Over the real shape: against mad_tpu at bucket 1 everywhere; at
    its bucket 16 short of the last real voxel of each axis, where the
    bucket's padding enters mad_tpu's central difference and the port
    takes a one-sided one (ROADMAP Queue 3, "result depends on its
    compile bucket")."""
    data = _blob()
    origin = np.array([4.0, 6.0, 8.0])
    t = build_scale_space(TGrid(torch.as_tensor(data), origin, 2.0),
                          TSS(map_padding=9, oct_mode=mode), 16)
    assert isinstance(t, ScaleSpace)
    for bucket in (1, 16):
        j = jbuild(JGrid(data=data, origin=origin, voxsp=2.0),
                   JSS(map_padding=9, oct_mode=mode), shape_bucket=bucket)
        np.testing.assert_array_equal(t.origin, j.origin)
        assert len(t.octaves) == len(j.octaves) == (2 if mode == "both"
                                                    else 1)
        for to, jo in zip(t.octaves, j.octaves):
            assert to.voxsp == jo.voxsp and to.real_shape == jo.real_shape
            assert tuple(to.log.shape) == to.real_shape
            assert tuple(to.grad.shape) == to.real_shape + (3,)
            cut = 0 if bucket == 1 else 1
            real = tuple(slice(0, s - cut) for s in jo.real_shape)
            for got, ref in ((to.log, jo.log), (to.grad, jo.grad)):
                ref = np.asarray(ref)[real]
                scale = float(np.abs(ref).max())
                err = float(np.abs(got.numpy()[real] - ref).max())
                assert err <= REL * scale, (bucket, err, scale)


def test_metrics_copy():
    rng = np.random.default_rng(3)
    y = (rng.random(40) > 0.5).astype(float)
    p = rng.random(40)
    for yy, pp in ((y, p), (np.ones(5), p[:5]),
                   (np.array([0, 0, 1, 1, 1]),
                    np.array([0.1, 0.2, 0.9, 0.8, 0.7]))):
        a, b = tmetrics.bc_scoring(yy, pp), jmetrics.bc_scoring(yy, pp)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        for fn in ("mcc_scoring", "precision_scoring"):
            va, da = getattr(tmetrics, fn)(yy, pp)
            vb, db = getattr(jmetrics, fn)(yy, pp)
            np.testing.assert_array_equal(va, vb)
            np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(tmetrics.f1_scoring(yy, pp),
                                      jmetrics.f1_scoring(yy, pp))


def test_eqsp_viz_copy(tmp_path):
    for size in (16, 112):
        for mod in (tviz, jviz):
            mod.write_eqsp_tcl(str(tmp_path / f"{mod.__name__}.tcl"),
                               size=size)
        assert (tmp_path / f"{tviz.__name__}.tcl").read_bytes() == \
            (tmp_path / f"{jviz.__name__}.tcl").read_bytes()
        counts = np.random.default_rng(size).integers(0, 40, size)
        assert tviz.occupancy_ascii(counts, tget_eqsp(size)) == \
            jviz.occupancy_ascii(counts, jget_eqsp(size))
    tviz.write_def_pdb(str(tmp_path / "t.pdb"))
    jviz.write_def_pdb(str(tmp_path / "j.pdb"))
    assert (tmp_path / "t.pdb").read_bytes() == \
        (tmp_path / "j.pdb").read_bytes()
    assert len(tviz.occupancy_ascii(np.arange(16),
                                    tget_eqsp(16)).splitlines()) == 4
