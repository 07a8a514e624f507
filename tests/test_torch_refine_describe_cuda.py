"""K15 (csrc/refine.cu, one gather round and one cluster barrier a step)
and K7 (csrc/describe.cu, warp-owned regions counted by ballots) against
their plain PyTorch versions on the card, at the shapes and settings the
bench does not reach. Every test here needs a CUDA card and skips without
one; the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_refine_describe_cuda.py

Tolerances (ROADMAP Queue 3, standing):
  * K15: the same failed flags and, where nothing freezes, the same step
    counts; final CA-RMSD to the plain version <= 0.5 A for every
    candidate and <= 0.05 A in the median (the kernel sums the forces in
    another order, and a last-bit difference can flip a step halving).
    Cases: N not a multiple of 256 and N above the register tile (the
    looped form), a NaN in the field that a known step's gathers reach
    first, n_steps not a multiple of batch_size, a candidate that never
    freezes, C = 1 and C x kCluster above the card's 132 SMs;
  * K7: the same ok flags, rows equal in >= 99 % of lanes and within an
    L1 of 8 counts in the rest (zone-bound ulps of atan2f / acosf);
    rows of lanes that are out of bounds or invalid are zero. Cases: the
    bfloat16 field, the offset form (a block of the field from global row
    goff), lanes out of bounds at every face, 27, 8 and 1 subregions and
    patch_size 24.
The plain versions are held against mad_tpu on the CPU by
tests/test_torch_refine.py, tests/test_torch_orient_describe.py and
tests/test_torch_refine_describe_layout.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import DescribeConfig, RefineConfig
from mad_tpu_torch.core.eqsp import get_eqsp
from mad_tpu_torch.engine.refine import refine_inputs
from mad_tpu_torch.kernels import build
from mad_tpu_torch.kernels import describe as k7
from mad_tpu_torch.kernels import refine as k15
from mad_tpu_torch.ops.describe import descriptor_lattice, region_ids
from mad_tpu_torch.ops.orient import ref_zone_bounds
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.testing import ca_rmsds, make_protein

pytestmark = pytest.mark.cuda

POSE_MAX, POSE_MEDIAN = 0.5, 0.05
ROWS_EQUAL, ROW_L1 = 0.99, 8
SMS = 132                       # the H100's streaming multiprocessors


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _system(cuda, n_res, C, seed=2):
    """A protein's simulated map and C start poses near the deposited one
    (small rotations and shifts)."""
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


def _compare(p, args, cfg):
    before = k15.launches
    got = k15.refine_loop(*args, cfg)
    torch.cuda.synchronize()
    assert k15.launches == before + 1
    ref = k15.refine_loop_plain(*args, cfg)
    failed = ref[5].cpu().numpy()
    np.testing.assert_array_equal(got[5].cpu().numpy(), failed)
    ok = ~failed
    if ok.any():
        d = ca_rmsds(got[2].cpu().numpy(), ref[2].cpu().numpy(),
                     p.ca_idx)[ok]
        assert d.max() <= POSE_MAX and np.median(d) <= POSE_MEDIAN, d
    return got, ref


@pytest.mark.parametrize("n_res", [75, 425], ids=["296_atoms",
                                                  "1696_atoms_looped"])
def test_k15_atom_counts(cuda, n_res):
    p, dmap, starts = _system(cuda, n_res, 6)
    assert p.coords.shape[0] % 256 != 0
    _compare(p, refine_inputs(dmap, starts, cuda), RefineConfig())


def test_k15_nan_reached_at_a_known_step(cuda):
    """NaN in the field voxels that the gathers of step k reach and no
    earlier step's do: both fail, the first after k + 1 steps, each
    failing candidate after the same count."""
    p, dmap, starts = _system(cuda, 30, 3)
    args = list(refine_inputs(dmap, starts, cuda))
    field, bounds = args[0], args[4]
    dims = torch.tensor(field.shape[:3], device=cuda)

    def corners(cfg):
        coords = k15.refine_loop_plain(*args, cfg)[2]
        v = ((coords.reshape(-1, 3) - bounds[0:3]) / bounds[6])
        p0 = torch.minimum(torch.clamp(torch.floor(v).long(), min=0),
                           dims - 2)
        return {tuple(c) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
                for c in (p0 + torch.tensor([dx, dy, dz],
                                            device=cuda)).tolist()}

    k = 5
    earlier = set().union(*(corners(RefineConfig(n_steps=j))
                            for j in range(k)))
    fresh = corners(RefineConfig(n_steps=k)) - earlier
    assert fresh
    field = field.clone()
    for x, y, z in fresh:
        field[x, y, z, 0] = float("nan")
    args[0] = field
    got, ref = _compare(p, args, RefineConfig())
    failed = ref[5]
    # a candidate whose step-k corners were all touched by another's
    # earlier steps meets the NaN later
    assert int(ref[4][failed].min()) == k + 1
    assert torch.equal(got[4][failed], ref[4][failed])


@pytest.mark.parametrize("cfg", [
    RefineConfig(n_steps=37, batch_size=4),
    RefineConfig(n_steps=45, batch_size=6, min_step=0.0)],
    ids=["37_steps", "never_frozen"])
def test_k15_step_schedules(cuda, cfg):
    p, dmap, starts = _system(cuda, 30, 6)
    got, ref = _compare(p, refine_inputs(dmap, starts, cuda), cfg)
    if cfg.min_step == 0.0:            # nothing freezes: every step runs
        assert not bool(got[3].any())
        assert got[4].tolist() == [cfg.n_steps] * len(starts)
        assert torch.equal(got[4], ref[4])


def test_k15_one_candidate_and_more_clusters_than_sms(cuda):
    cluster = build.constants("refine.cu")["kCluster"]
    assert cluster in (1, 2, 4, 8)
    many = SMS // cluster + 7
    p, dmap, starts = _system(cuda, 30, many)
    assert many * cluster > SMS
    for C in (1, many):
        _compare(p, refine_inputs(dmap, starts[:C], cuda), RefineConfig())


def _field(cuda, shape, seed):
    """A smooth (X, Y, Z, 3) float32 field: a few random plane waves a
    component (zero magnitudes nowhere but by chance)."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64)
                                  for s in shape], indexing="ij"), -1)
    out = np.zeros(tuple(shape) + (3,))
    for c in range(3):
        for _ in range(4):
            k = rng.normal(scale=0.25, size=3)
            out[..., c] += rng.normal() * np.sin(grid @ k + rng.uniform(0, 6))
    return torch.tensor(out.astype(np.float32), device=cuda)


def _lanes(cuda, shape, reach, L, seed):
    """L lanes: random frames at coords that keep the rotated lattice
    inside, the last 12 out of bounds on each face, and the lanes 3 and 7
    invalid."""
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.uniform(reach, s - 1 - reach, L) for s in shape],
                      -1)
    for i in range(12):
        j, side = i % 3, (i // 3) % 2
        coords[L - 12 + i, j] = 1.0 if side == 0 else shape[j] - 2.0
    q, r = np.linalg.qr(rng.normal(size=(L, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    valid = np.ones(L, bool)
    valid[[3, 7]] = False
    return (torch.tensor(coords.astype(np.float32), device=cuda),
            torch.tensor(q.astype(np.float32), device=cuda),
            torch.tensor(valid, device=cuda))


def _describe(args):
    before = k7.launches
    d1, ok1 = k7.descriptor_hist(*args)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    d2, ok2 = k7.descriptor_hist_plain(*args)
    assert torch.equal(ok1, ok2) and ok1.dtype == torch.bool
    l1 = (d1.long() - d2.long()).abs().sum(dim=1)
    assert (l1 == 0).float().mean().item() >= ROWS_EQUAL
    assert l1.max().item() <= ROW_L1
    assert not d1[~ok1].any()
    return ok1


def test_k7_bfloat16_offset_form_and_edges(cuda):
    cfg = DescribeConfig()
    radius = cfg.patch_size // 2
    consts = (ref_zone_bounds(get_eqsp(cfg.subeqsp_size)), cfg.subregions,
              cfg.cutoff_magn, cfg.zero_magn)
    for upsampled in (False, True):
        shape = (70, 64, 72) if upsampled else (44, 40, 46)
        reach = 2 * radius * 1.75 if upsampled else radius * 1.75
        grad = _field(cuda, shape, seed=int(upsampled))
        coords, rfin, valid = _lanes(cuda, shape, reach, 200, seed=3)
        lat = (descriptor_lattice(radius, upsampled),
               region_ids(radius, cfg.subregions))
        for field in (grad, grad.to(torch.bfloat16)):
            ok = _describe((field, coords, rfin, valid, shape, *lat,
                            *consts))
            assert not ok[-12:].any() and not ok[3] and not ok[7]
            assert int(ok.sum()) > 150
            # the offset form: a block of rows [goff, goff + rows)
            goff, rows = shape[0] // 4, shape[0] // 2 + 3
            _describe((field[goff:goff + rows].contiguous(), coords, rfin,
                       valid, shape, *lat, *consts, goff))


def test_k7_subregions_and_patch_24(cuda):
    shape = (48, 50, 52)
    for subregions, patch in ((27, 16), (8, 16), (1, 16), (64, 24)):
        cfg = dataclasses.replace(DescribeConfig(), subregions=subregions,
                                  patch_size=patch)
        radius = patch // 2
        grad = _field(cuda, shape, seed=subregions + patch)
        coords, rfin, valid = _lanes(cuda, shape, radius * 1.75, 96, seed=5)
        ok = _describe((grad, coords, rfin, valid, shape,
                        descriptor_lattice(radius, False),
                        region_ids(radius, subregions),
                        ref_zone_bounds(get_eqsp(cfg.subeqsp_size)),
                        subregions, cfg.cutoff_magn, cfg.zero_magn))
        assert int(ok.sum()) > 60
