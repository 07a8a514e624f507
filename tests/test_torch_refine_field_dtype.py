"""Port parity: ``RefineConfig.field_dtype`` "bfloat16" in the refinement
(mad_tpu_torch/engine/refine.py, core/config.refine_field_dtype) against
mad_tpu/engine/refine.py, which rounds its packed gradient rows to
bfloat16 below 67,108,864 map voxels (:86-92, :216-222).

* The interpolation: the port's bfloat16 field (K3's plain version)
  widened to float32 through ``trilinear`` equals mad_tpu's
  ``trilinear_packed(pack_corners(field, "bfloat16"))`` bit for bit, at
  random points and at the map's faces, corners and beyond.
* The refinement, through both packages, on 6 candidates (mad_tpu's
  monolithic program) and on 18 (its cascade): the same failed and
  converged flags, final poses within POSE_TOL of mad_tpu's (the loops
  round float32 steps in another order, tests/test_torch_refine.py), and
  within SAME_FIELD_TOL: on these poses a float32 field moves mad_tpu's
  own poses by up to 0.0154 A, the same bfloat16 field the port's by at
  most 1e-5 A (observed).
* The knob changes the port's result; the gate at its boundary, computed
  from the shape alone; another dtype name raises; a CPU mesh of two
  shards gives the one-device result bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mad_tpu.core.config import RefineConfig as JRefine
from mad_tpu.engine import refine as jref
from mad_tpu.ops.interp import pack_corners, trilinear_packed
from mad_tpu.ops.simulate import simulate_density as jsimulate
from mad_tpu.testing import make_protein
from mad_tpu_torch.convert import grid_from_numpy
from mad_tpu_torch.core.config import RefineConfig as TRefine
from mad_tpu_torch.core.config import refine_field_dtype
from mad_tpu_torch.engine import refine as tref
from mad_tpu_torch.kernels import refine as k15
from mad_tpu_torch.ops.interp import trilinear
from mad_tpu_torch.parallel.mesh import make_mesh
from mad_tpu_torch.testing import recording

torch.set_num_threads(1)

POSE_TOL = 0.1
SAME_FIELD_TOL = 1e-3
GATE = 67_108_864           # 4 GiB of 64-byte corner rows


@pytest.fixture(scope="module")
def system():
    """tests/test_torch_refine.py's map, and 18 start poses: rotated by
    2-36 degrees about z and shifted, the last one with a NaN atom."""
    p = make_protein(n_res=30, seed=2, n_segments=2)
    dmap = jsimulate(p, resolution=8.0, voxsp=2.0).reduce_void(8)
    rng = np.random.default_rng(3)
    center = p.coords.mean(axis=0)
    starts = []
    for i in range(18):
        ang = np.deg2rad(2.0 + 2.0 * i)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        starts.append((p.coords - center) @ R + center
                      + rng.normal(scale=0.5 + 0.15 * i, size=3))
    starts = np.stack(starts).astype(np.float32)
    starts[17, 7] = np.nan
    data = np.asarray(dmap.data)
    tmap = grid_from_numpy(data, dmap.origin, dmap.voxsp, device="cpu")
    return p, dmap, tmap, starts


def _ca_rmsd(a, b, ca):
    return np.sqrt(((a[ca] - b[ca]) ** 2).sum(-1).mean())


def test_interpolation_equals_mad_tpus_packed_rows(system):
    _p, dmap, tmap, _s = system
    data = np.asarray(dmap.data)
    field, _bounds = tref.map_inputs(tmap, "cpu", "bfloat16")
    assert field.dtype == torch.bfloat16
    grad = jnp.stack(jnp.gradient(jnp.asarray(data)), axis=-1)
    packed = pack_corners(grad, "bfloat16")
    shp = np.array(data.shape, dtype=np.float64)
    rng = np.random.default_rng(0)
    inside = rng.uniform(0.0, shp - 1, size=(3000, 3))
    around = rng.uniform(-2.0, shp + 1, size=(1000, 3))
    faces = rng.uniform(0.0, shp - 1, size=(600, 3))
    for a in range(3):                  # on each face, at both ends
        faces[200 * a:200 * a + 100, a] = 0.0
        faces[200 * a + 100:200 * (a + 1), a] = shp[a] - 1
    corners = np.array(np.meshgrid(*[(0.0, n - 1) for n in shp],
                                   indexing="ij")).reshape(3, -1).T
    pts = np.concatenate([inside, around, faces, corners,
                          corners - 1e-3, corners + 0.5]).astype(np.float32)
    got = trilinear(field.float(), torch.as_tensor(pts)).numpy()
    ref = np.asarray(trilinear_packed(packed, data.shape, jnp.asarray(pts)))
    np.testing.assert_array_equal(got, ref)
    # and the float32 field's interpolation is another one
    f32 = trilinear(tref.map_inputs(tmap, "cpu")[0],
                    torch.as_tensor(pts)).numpy()
    assert not np.array_equal(f32, got)


@pytest.mark.parametrize("n_cand", [6, 18], ids=["monolithic", "cascade"])
def test_refine_bf16_equals_mad_tpu(system, n_cand):
    p, dmap, tmap, starts = system
    starts = starts[-n_cand:]
    jr = jref.refine_candidates(dmap, starts,
                                JRefine(field_dtype="bfloat16"))
    tr = tref.refine_candidates(tmap, starts,
                                TRefine(field_dtype="bfloat16"),
                                device="cpu")
    np.testing.assert_array_equal(tr.failed, jr.failed)
    assert tr.failed[-1] and not tr.failed[:-1].any()
    np.testing.assert_array_equal(tr.converged, jr.converged)
    d = [_ca_rmsd(a, b, p.ca_idx)
         for a, b in zip(tr.coords[:-1], jr.coords[:-1])]
    assert max(d) <= POSE_TOL and max(d) <= SAME_FIELD_TOL, d


def test_the_knob_changes_the_result(system):
    _p, _dmap, tmap, starts = system
    with recording(k15, "refine_loop_plain") as calls:
        f32 = tref.refine_candidates(tmap, starts[:6], TRefine(),
                                     device="cpu")
        b16 = tref.refine_candidates(tmap, starts[:6],
                                     TRefine(field_dtype="bfloat16"),
                                     device="cpu")
    assert [c[0].dtype for c in calls] == [torch.float32, torch.bfloat16]
    assert not np.array_equal(f32.coords, b16.coords)
    np.testing.assert_array_equal(f32.failed, b16.failed)


def test_gate_at_its_boundary():
    """mad_tpu's ``X*Y*Z * 64 < 4 << 30`` at 67,108,863 and 67,108,864
    voxels, from the shapes alone (nothing of that size is allocated)."""
    below = (8191, 2731, 3)             # 2^26 - 1 = 8191 * 8193
    at = (1024, 256, 256)               # 67,108,864
    above = (4096, 4096, 4096)          # 2^36 voxels: int64 products
    assert np.prod(below) == GATE - 1 and np.prod(at) == GATE
    assert refine_field_dtype(below, "bfloat16") == torch.bfloat16
    assert refine_field_dtype(at, "bfloat16") == torch.float32
    assert refine_field_dtype(above, "bfloat16") == torch.float32
    for shape in (below, at, (2, 2, 2)):
        assert refine_field_dtype(shape, "float32") == torch.float32
    for shape, want in ((below, True), (at, False)):
        row_bytes = 64                  # mad_tpu's rule, refine.py:88-89
        assert (int(np.prod(shape, dtype=np.int64)) * row_bytes
                < 4 << 30) == want
    assert TRefine().field_dtype == JRefine().field_dtype == "float32"


def test_other_dtype_names_raise(system):
    _p, _dmap, tmap, starts = system
    with pytest.raises(ValueError, match="float16"):
        refine_field_dtype((8, 8, 8), "float16")
    with pytest.raises(ValueError, match="bf16"):
        tref.refine_candidates(tmap, starts[:2],
                               TRefine(field_dtype="bf16"), device="cpu")


def test_two_cpu_shards_equal_one_device(system):
    _p, _dmap, tmap, starts = system
    cfg = dataclasses.replace(TRefine(field_dtype="bfloat16"), n_steps=120)
    one = tref.refine_candidates(tmap, starts[:7], cfg, device="cpu")
    two = tref.refine_candidates(tmap, starts[:7], cfg,
                                 mesh=make_mesh(2, devices=["cpu"] * 2))
    for f in ("rot", "trans", "coords", "converged", "steps", "failed"):
        np.testing.assert_array_equal(getattr(two, f), getattr(one, f))
