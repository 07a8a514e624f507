"""The matching front's CUDA kernels (K10's pair head, K11 field, K12
approximate repeatability, K14 cluster selection) against their plain
PyTorch versions, on the card. Every test here needs a CUDA card and skips
without one; the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_match_cuda.py

Tolerances:
  * K10's head, K11, K14: equal (keys are unique and order the pairs
    exactly; the field is bytes; the cluster scan sums in the plain
    version's order, without FMA);
  * K12: equal, except pairs with a moved anchor within 1e-4 voxel of a
    .5 rounding edge (none is expected: the kernel rounds as the plain
    version does).
The parity of the plain versions with mad_tpu is held on the CPU by
tests/test_torch_match_heads.py and tests/test_torch_cluster_select.py.
"""

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import FilterConfig
from mad_tpu_torch.kernels import approx as k12
from mad_tpu_torch.kernels import cluster as k14
from mad_tpu_torch.kernels import field as k11
from mad_tpu_torch.kernels import pairs as k10
from mad_tpu_torch.testing import pose_table

pytestmark = pytest.mark.cuda

EDGE = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cosines(rng, dh, dl, levels):
    """Values in [-0.5, 1) on a grid of ``levels`` steps, so that many
    cosines tie exactly."""
    return torch.as_tensor(
        (rng.integers(0, levels, (dh, dl)) / levels * 1.5 - 0.5)
        .astype(np.float32))


@pytest.mark.parametrize("dh,dl,row_cap,max_pairs,threshold,levels", [
    (24, 16411, 128, 2000, 0.6, 97),      # thousands of survivors a row
    (300, 700, 128, 65536, 0.6, 1 << 20),  # the heads merge over tiles
    (50, 300, 500, 4000, -0.25, 64),      # row_cap > dl, threshold < 0
])
def test_k10_pair_head(cuda, dh, dl, row_cap, max_pairs, threshold, levels):
    rng = np.random.default_rng(dl)
    sim = _cosines(rng, dh, dl, levels)
    sim[3] = -1.0                                     # a row with none
    sim[5, :7] = 0.9                                  # a row with few
    sim[5, 7:] = 0.1
    sim = sim.to(cuda)
    before = k10.launches
    got = k10.pair_head(sim, row_cap, max_pairs, threshold)
    assert k10.launches == before + 2                 # its two kernels
    want = k10.pair_head_plain(sim, row_cap, max_pairs, threshold)
    assert torch.equal(got, want)
    ccs, rows, cols = k10.split_pair_keys(got.cpu().numpy(), dl)
    assert len(ccs) > 0 and (ccs > np.float32(threshold)).all()
    assert 3 not in set(rows.tolist())


def test_k11_anchor_field(cuda):
    rng = np.random.default_rng(3)
    shape = (61, 47, 53)
    vox = rng.integers(0, shape, size=(400, 3))
    vox[:6] = [[0, 0, 0], [60, 46, 52], [0, 46, 0], [60, 0, 52],
               [30, 0, 26], [1, 1, 51]]                # at the border
    lo_vox = torch.as_tensor(vox.astype(np.int32), device=cuda)
    for radius in (3, 1):
        before = k11.launches
        got = k11.anchor_field(shape, lo_vox, radius)
        assert k11.launches == before + 1
        want = k11.anchor_field_plain(shape, lo_vox, radius)
        assert got.dtype == torch.int8 and torch.equal(got, want)


def _near_edge(hi_cloud, origin, inv, rot, hi, lo):
    x = hi_cloud.double()[None] - hi.double()[:, None]
    y = torch.einsum("pad,ped->pae", x, rot.double()) + lo.double()[:, None]
    v = (y - origin.double()) * inv
    frac = v - torch.floor(v)
    return ((frac - 0.5).abs() < EDGE).any(dim=(1, 2))


def test_k12_approx_repeat_far_poses(cuda):
    rng = np.random.default_rng(7)
    t = pose_table(3000, 30, 7)
    shape, voxsp = (90, 80, 100), 1.4
    origin = np.array([-60.0, -55.0, -70.0], np.float32)
    lo_vox = np.clip(np.round((t["lo_cloud"] - origin) / voxsp), 0,
                     np.asarray(shape) - 1).astype(np.int32)
    field = k11.anchor_field_plain(shape, torch.as_tensor(lo_vox), 3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    lo = t["lo_coord"].copy()
    lo[:5] += [[1e9, 0, 0], [0, -1e9, 0], [0, 0, 3e38], [-3e38, 0, 0],
               [400.0, 0, 0]]                         # poses off the map
    args = (field.to(cuda), torch.as_tensor(lo_vox, device=cuda), 3,
            f32(t["hi_cloud"]), f32(origin),
            float(np.float32(1.0 / voxsp)), f32(t["rot"]),
            f32(t["hi_coord"] + rng.normal(size=(3000, 3)) * 0.01), f32(lo))
    before = k12.launches
    got = k12.approx_repeat(*args)
    assert k12.launches == before + 1
    want = k12.approx_repeat_plain(*args)
    edge = _near_edge(*args[3:])
    assert torch.equal(got[~edge], want[~edge])
    assert (got[:5] == 0).all() and float(got.max()) > 50.0


def _selection_inputs(t, n, cuda):
    X = t["hi_cloud"]
    mu, M = X.mean(axis=0), (X.T @ X) / X.shape[0]
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dtype=dt),
                                        device=cuda)
    cfg = FilterConfig()
    return (put(t["rot"][:n], np.float32), put(t["hi_coord"][:n], np.float64),
            put(t["lo_coord"][:n], np.float64),
            put(t["repeat"][:n], np.float32), put(mu, np.float64),
            put(M, np.float64), cfg.rmsd_cloud, cfg.weight_threshold,
            k14.gate_threshold(t["repeat"][0], cfg.min_repeat,
                               cfg.repeat_frac))


@pytest.mark.parametrize("n,n_centers,noise", [(3000, 400, 0.6),
                                               (600, 60, 1.0)])
def test_k14_cluster_select(cuda, n, n_centers, noise):
    """3,000 rows scan their near words in device memory, 600 (the
    bench's n_scan) in shared memory; one call, three kernels."""
    t = pose_table(n, n_centers, n, noise=noise)
    args = _selection_inputs(t, n, cuda)
    before = k14.launches
    got = k14.cluster_select(*args)
    assert k14.launches == before + 3
    want = k14.cluster_select_plain(*args)
    assert torch.equal(got, want)
    _a, found, _w, cands, n_cands = k14.split_selection(got.cpu().numpy(), n)
    assert len(found) > n_centers // 2 and n_cands > 0


def test_wrappers_raise_on_mixed_devices(cuda):
    with pytest.raises(ValueError):
        k12.approx_repeat(torch.zeros((4, 4, 4), dtype=torch.int8,
                                      device=cuda),
                          torch.zeros((1, 3), dtype=torch.int32,
                                      device=cuda), 1,
                          torch.zeros((3, 3)), torch.zeros(3, device=cuda),
                          1.0, torch.eye(3, device=cuda)[None],
                          torch.zeros((1, 3), device=cuda),
                          torch.zeros((1, 3), device=cuda))
    t = pose_table(8, 2, 0)
    args = list(_selection_inputs(t, 8, cuda))
    args[4] = args[4].cpu()
    with pytest.raises(ValueError):
        k14.cluster_select(*args)
