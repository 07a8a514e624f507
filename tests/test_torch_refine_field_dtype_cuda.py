"""K15 on a bfloat16 gradient field (``RefineConfig.field_dtype``,
csrc/refine.cu's bfloat16 loads) against its plain PyTorch version on the
card. Every test here needs a CUDA card and skips without one; the file
imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_refine_field_dtype_cuda.py

Tolerance, K15's (ROADMAP Queue 3, standing): the same failed flags,
final CA-RMSD to the plain version <= 0.5 A for every candidate and <=
0.05 A in the median (the kernel sums the forces in another order). The
bfloat16 variant widens each corner exactly and then runs the float32
path's arithmetic, so on the widened field the float32 kernel gives its
outputs bit for bit. The plain version is held against mad_tpu's packed
bfloat16 rows on the CPU by tests/test_torch_refine_field_dtype.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import RefineConfig
from mad_tpu_torch.engine.refine import refine_candidates, refine_inputs
from mad_tpu_torch.kernels import refine as k15
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.parallel.mesh import make_mesh
from mad_tpu_torch.testing import ca_rmsds, make_protein

pytestmark = pytest.mark.cuda

POSE_MAX, POSE_MEDIAN = 0.5, 0.05
BF16 = RefineConfig(field_dtype="bfloat16")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _system(cuda, n_res, C, seed=2):
    """A protein's simulated map and C start poses near the deposited one
    (tests/test_torch_refine_describe_cuda.py's)."""
    p = make_protein(n_res=n_res, seed=seed, n_segments=2)
    dmap = simulate_density(p, 8.0, 2.0, device=cuda).reduce_void(8)
    rng = np.random.default_rng(seed + 1)
    center = p.coords.mean(axis=0)
    starts = []
    for i in range(C):
        ang = np.deg2rad(2.0 + 8.0 * i / max(C, 1))
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        starts.append((p.coords - center) @ R + center
                      + rng.normal(scale=0.5 + 2.0 * i / max(C, 1), size=3))
    return p, dmap, np.stack(starts).astype(np.float32)


@pytest.mark.parametrize("n_res", [75, 425], ids=["296_atoms",
                                                  "1696_atoms_looped"])
def test_k15_bf16_against_plain(cuda, n_res):
    p, dmap, starts = _system(cuda, n_res, 12)
    args = refine_inputs(dmap, starts, cuda, "bfloat16")
    assert args[0].dtype == torch.bfloat16
    before, before16 = k15.launches, k15.bf16_launches
    got = k15.refine_loop(*args, BF16)
    torch.cuda.synchronize()
    assert (k15.launches, k15.bf16_launches) == (before + 1, before16 + 1)
    ref = k15.refine_loop_plain(*args, BF16)
    failed = ref[5].cpu().numpy()
    np.testing.assert_array_equal(got[5].cpu().numpy(), failed)
    assert not failed.any()
    d = ca_rmsds(got[2].cpu().numpy(), ref[2].cpu().numpy(), p.ca_idx)
    assert d.max() <= POSE_MAX and np.median(d) <= POSE_MEDIAN, d


def test_k15_bf16_is_the_float32_path_on_the_widened_field(cuda):
    p, dmap, starts = _system(cuda, 75, 12)
    field, *rest = refine_inputs(dmap, starts, cuda, "bfloat16")
    b16 = k15.refine_loop(field, *rest, BF16)
    before16 = k15.bf16_launches
    f32 = k15.refine_loop(field.float(), *rest, BF16)
    torch.cuda.synchronize()
    assert k15.bf16_launches == before16
    for a, b in zip(b16, f32):
        assert torch.equal(a, b)


def test_k15_float32_path_unchanged(cuda):
    p, dmap, starts = _system(cuda, 75, 12)
    args = refine_inputs(dmap, starts, cuda)
    assert args[0].dtype == torch.float32
    before16 = k15.bf16_launches
    got = k15.refine_loop(*args, RefineConfig())
    torch.cuda.synchronize()
    assert k15.bf16_launches == before16
    ref = k15.refine_loop_plain(*args, RefineConfig())
    np.testing.assert_array_equal(got[5].cpu().numpy(),
                                  ref[5].cpu().numpy())
    d = ca_rmsds(got[2].cpu().numpy(), ref[2].cpu().numpy(), p.ca_idx)
    assert d.max() <= POSE_MAX and np.median(d) <= POSE_MEDIAN, d
    # the bfloat16 field gives other poses
    b16 = k15.refine_loop(*refine_inputs(dmap, starts, cuda, "bfloat16"),
                          RefineConfig())
    assert not torch.equal(b16[2], got[2])


def test_wrapper_refuses_other_fields(cuda):
    _p, dmap, starts = _system(cuda, 30, 2)
    field, *rest = refine_inputs(dmap, starts, cuda, "bfloat16")
    for bad in (field.half(), field.float().transpose(0, 1),
                field[..., :2].contiguous()):
        with pytest.raises(ValueError, match="field"):
            k15.refine_loop(bad, *rest, BF16)


def test_refine_candidates_bf16_on_two_shards(cuda):
    """refine_candidates with the knob: the bfloat16 kernel on one device
    and on a mesh of two shards of the card (D4), bit for bit."""
    _p, dmap, starts = _system(cuda, 75, 9)
    cfg = dataclasses.replace(BF16, n_steps=200)
    before16 = k15.bf16_launches
    one = refine_candidates(dmap, starts, cfg, device=cuda)
    two = refine_candidates(dmap, starts, cfg,
                            mesh=make_mesh(2, devices=[cuda, cuda]))
    assert k15.bf16_launches == before16 + 3
    for f in ("rot", "trans", "coords", "converged", "steps", "failed"):
        np.testing.assert_array_equal(getattr(two, f), getattr(one, f))
