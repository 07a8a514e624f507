"""K16 (post-refine merge and rescue eligibility) and K17 (batched model
CCC) against their plain PyTorch versions on the card, and K5 at
exclude_border 0 (the overlap staging that K20b ran is folded into K19 and
K20: tests/test_torch_simulate_tiles_cuda.py). Every test here needs a
CUDA card and skips without one; the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_post_cuda.py

Tolerances:
  * K16: equal hits, counts, accepted flags, slots and eligible rows; the
    moved anchors s_a within 1e-12 A (the centroid is summed in another
    order; every other product and sum rounds as in the plain version);
  * K17: within 1e-5 (float64 sums against the plain version's float32);
  * K5: equal (it rounds every operation as its plain version does, the
    patch placed by the same rule).
The parity of the plain versions with mad_tpu is held on the CPU by
tests/test_torch_post.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import MadConfig
from mad_tpu_torch.engine import docking
from mad_tpu_torch.kernels import ccc as k17
from mad_tpu_torch.kernels import localize as k5
from mad_tpu_torch.kernels import post as k16
from mad_tpu_torch.kernels import enumerate as k_enum
from mad_tpu_torch.testing import post_round, post_scenario, recording

pytestmark = pytest.mark.cuda

ANCHOR_TOL, CCC_TOL = 1e-12, 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def launched(mod, fn, *args):
    before = mod.launches
    out = fn(*args)
    assert mod.launches == before + 1
    return out


@pytest.mark.parametrize("last,n_rows,n_top", [(0, 160, 40),
                                               (1, 3000, 2000)],
                         ids=["first", "rescue"])
def test_k16_matches_plain(cuda, last, n_rows, n_top):
    """The rounds of tests/test_torch_post.py through the port's docking
    merge on the card, the last round's K16 call recorded; 3,003 rows span
    three chunks of the ordered compaction."""
    sc = post_scenario(seed=4, n_rows=n_rows)
    table = SimpleNamespace(hi_cloud=sc["hi_cloud"], lo_cloud=sc["lo_cloud"],
                            lo_coord=sc["lo_rows"])
    sols = []
    for r in range(last + 1):
        cands, res = post_round(sc, r, cuda)
        with recording(docking, "post") as calls:
            docking._merge_refined(res, cands, sols, sc["sub"],
                                   SimpleNamespace(voxsp=2.0), table,
                                   MadConfig(), cuda, n_top)
    args = calls[0]
    C, A = args[0].shape[0], args[8].shape[0]
    # on one device the lanes and the dedup are one launch (the fold)
    count = lambda: (k16.fold_launches, k16.lane_launches, k16.launches)
    before = count()
    vec = k16.post(*args)
    assert count() == (before[0] + 1, before[1], before[2])
    got = k16.split_post(vec.cpu().numpy(), C, A, n_top)
    want = k16.split_post(k16.post_plain(*args).cpu().numpy(), C, A, n_top)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert np.abs(got[0] - want[0]).max() <= ANCHOR_TOL
    assert got[3].any() and len(got[5]) > 0


def test_k17_matches_plain(cuda):
    """Boxes inside, across the low and high faces and wholly outside a
    (70, 64, 90) map (CCC 0), and three boxes of 96 x 80 x 112."""
    rng = np.random.default_rng(11)
    data = torch.as_tensor(rng.random((70, 64, 90), dtype=np.float32),
                           device=cuda)
    for shape, starts in (((16, 20, 24), [[5, 6, 7], [-5, 50, 80],
                                          [60, -10, -20], [80, 0, 0]]),
                          ((96, 80, 112), [[-10, -8, -11], [0, 0, 0],
                                           [-40, 30, 20]])):
        models = torch.as_tensor(rng.random((len(starts),) + shape,
                                            dtype=np.float32), device=cuda)
        st = torch.as_tensor(starts, dtype=torch.int32, device=cuda)
        got = launched(k17, k17.batched_ccc, data, models, st)
        want = k17.batched_ccc_plain(data, models, st)
        assert float((got - want).abs().max()) <= CCC_TOL
    assert float(got[0]) > 0.5


def test_k5_exclude_border_zero_bitwise(cuda):
    """Peaks on the x = 0 and x = X - 1 faces and seeds in two opposite
    corners of the volume, where the patch start is wrapped or clamped."""
    n = 24
    a = np.array([[0.0611, -0.0287, -0.0343], [-0.0287, 0.1014, 0.0185],
                  [-0.0343, 0.0185, 0.1305]])
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    seeds = torch.tensor([[0, 12, 12], [n - 1, 12, 12], [0, 0, 0],
                          [n - 1, n - 1, n - 1]], device=cuda)
    for x in (0.0, n - 1.0):
        d = g - np.array([x, 11.731, 11.552])
        vol = torch.as_tensor(np.exp(-np.einsum("...i,ij,...j->...", d, a, d))
                              .astype(np.float32), device=cuda)
        got = launched(k5, k5.localize, vol, seeds, vol.shape, 0.6, 5)
        want = k5.localize_plain(vol, seeds, vol.shape, 0.6, 5)
        assert all(torch.equal(p, q) for p, q in zip(got, want))


def test_wrappers_raise_on_mixed_devices(cuda):
    data = torch.zeros((8, 8, 8), device=cuda)
    models = torch.zeros((1, 4, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        k17.batched_ccc(data, models, torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        k_enum.enumerate_head(torch.zeros((4, 5), device=cuda), torch.as_tensor(
            k_enum.comb_table(4, 2), device=cuda), 2)
    sc = post_scenario(seed=4)
    cands, res = post_round(sc, 0, cuda)
    table = SimpleNamespace(hi_cloud=sc["hi_cloud"], lo_cloud=sc["lo_cloud"],
                            lo_coord=sc["lo_rows"])
    with recording(docking, "post") as calls:
        docking._merge_refined(res, cands, [], sc["sub"],
                               SimpleNamespace(voxsp=2.0), table,
                               MadConfig(), cuda, 0)
    args = list(calls[0])
    args[11] = args[11].cpu()
    with pytest.raises(ValueError):
        k16.post(*args)
