"""Port parity: the plain PyTorch versions of K16 (post-refine merge and
rescue eligibility), K17 (batched model CCC), the enumeration heads'
overlap staging (symmetrize and trim, once K20b's kernel) and K5 at
exclude_border 0, against the mad_tpu code they
replace, on the CPU. Inputs come from a numpy seed and go through both
packages. Tolerances:
  * K16 with the host rebuild (engine/docking._merge_refined): the same
    solutions in the same order, with equal coords, weights, members and
    repeats, and corresp_anchors within 1e-12 A (float64 on both sides,
    the centroid summed in another order); the eligible rows equal to
    cKDTree's;
  * K17: within 1e-5 of mad_tpu's CCC (float32 sums in another order);
  * the heads' staging (``sym_trim_plain``): equal to
    _compiled_embed_sym's block (one float32 addition);
  * K5 (through detect_anchors) at exclude_border 0, a peak on each x
    face: equal coords and valid flags, subvoxel coordinates within 1e-4
    voxel (mad_tpu's determinant is an LU).
The kernels are held against these plain versions on the card by
tests/test_torch_post_cuda.py.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.core.grid import DensityGrid as JGrid
from mad_tpu.engine import docking as jdock
from mad_tpu.engine.assemble import _compiled_embed_sym
from mad_tpu.engine.score import batched_ccc as jccc
from mad_tpu.ops import detect as jdet
from mad_tpu_torch.convert import grid_from_numpy
from mad_tpu_torch.core.config import DetectConfig, MadConfig as TConfig
from mad_tpu_torch.engine import docking as tdock
from mad_tpu_torch.engine.score import batched_ccc as tccc
from mad_tpu_torch.kernels import ccc as k17
from mad_tpu_torch.kernels import localize as k5
from mad_tpu_torch.kernels import post as k16
from mad_tpu_torch.kernels import enumerate as k_enum
from mad_tpu_torch.ops import detect as tdet
from mad_tpu_torch.testing import post_round, post_scenario

torch.set_num_threads(1)

ANCHOR_TOL, CCC_TOL, SUBVOX_TOL = 1e-12, 1e-5, 1e-4
N_TOP = 40


def _jround(sc, r):
    rd = sc["rounds"][r]
    cands = [SimpleNamespace(rot=rd["rot"][i], hi_coord=rd["hi"][i],
                             lo_coord=rd["lo"][i], weight=rd["weight"][i],
                             members=rd["members"][i])
             for i in range(len(rd["weight"]))]
    res = SimpleNamespace(rot=rd["R"], trans=rd["t"], failed=rd["failed"],
                          coords=rd["coords"].astype(np.float64))
    return cands, res


def _table(sc):
    return SimpleNamespace(hi_cloud=sc["hi_cloud"], lo_cloud=sc["lo_cloud"],
                           lo_coord=sc["lo_rows"])


def _same_solutions(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.structure.coords, b.structure.coords)
        assert a.weight == b.weight and a.repeat == b.repeat
        assert a.corresp_anchors.shape == b.corresp_anchors.shape
        assert np.abs(a.corresp_anchors - b.corresp_anchors).max() \
            <= ANCHOR_TOL
        assert len(a.members) == len(b.members)
        assert all(np.array_equal(x, y) for x, y in zip(a.members,
                                                         b.members))


def _both_rounds(sc, upto):
    """Run rounds 0..upto through mad_tpu's _merge_refined and the port's
    (K16's plain version + the host rebuild); returns both solution lists,
    the port's n_new and eligible rows of the last round."""
    dmap = SimpleNamespace(voxsp=2.0)
    table = _table(sc)
    jsols, tsols = [], []
    for r in range(upto + 1):
        cands, res = _jround(sc, r)
        j_new = jdock._merge_refined(res, cands, jsols, sc["sub"], dmap,
                                     table, JConfig())
        cands, res = post_round(sc, r, "cpu")
        t_new, top = tdock._merge_refined(res, cands, tsols, sc["sub"], dmap,
                                          table, TConfig(), "cpu", N_TOP)
        assert t_new == j_new
    return jsols, tsols, t_new, top


@pytest.mark.parametrize("rounds", [0, 1], ids=["first", "rescue"])
def test_k16_merge_matches_mad_tpu(rounds):
    """Round 1 (S = 0): a failed lane, a hitless lane, lanes 3 and 4
    within dedup_rmsd; round 2 (S = 3): a lane merging into an earlier
    solution and one into a lane of the same round."""
    sc = post_scenario(seed=4)
    jsols, tsols, n_new, _top = _both_rounds(sc, rounds)
    _same_solutions(tsols, jsols)
    if rounds == 0:
        assert n_new == 3 and len(tsols) == 3
        assert tsols[1].weight == sum(sc["rounds"][0]["weight"][3:5])
    else:
        assert n_new == 1 and len(tsols) == 4


def test_k16_eligibility_matches_ckdtree():
    """After each round the first N_TOP rows whose map anchor lies farther
    than anchor_dist from every accepted atom, as cKDTree finds them (3
    rows lie off the anchor cloud)."""
    sc = post_scenario(seed=4)
    ad = TConfig().match.anchor_dist
    for rounds in (0, 1):
        _j, tsols, _n, top = _both_rounds(sc, rounds)
        atoms = np.concatenate([s.structure.coords for s in tsols])
        d, _ = cKDTree(atoms).query(sc["lo_rows"], distance_upper_bound=ad)
        want = np.nonzero(d > ad)[0][:N_TOP]
        assert 0 < len(want) and np.count_nonzero(np.isinf(d)) < len(d)
        np.testing.assert_array_equal(top, want)


def test_k17_plain_matches_mad_tpu():
    """Interior, face-poking and corner-hugging 12^3 boxes of a 24^3 map
    in one batch (tests/test_score.py's cases): the boxes start at voxels
    (6, 6, 6), (-6, 6, 6) and (18, 18, 18)."""
    rng = np.random.default_rng(3)
    voxsp = 2.0
    data = rng.random((24, 24, 24)).astype(np.float32)
    models = rng.random((3, 12, 12, 12)).astype(np.float32)
    origins = np.array([[6.0, 6, 6], [-6, 6, 6], [18, 18, 18]]) * voxsp
    want = jccc(JGrid(data=data, origin=np.zeros(3), voxsp=voxsp), models,
                origins)
    tmap = grid_from_numpy(data, np.zeros(3), voxsp, device="cpu")
    k17.launches = 0
    got = tccc(tmap, torch.as_tensor(models), origins)
    assert k17.launches == 0
    assert np.abs(got - np.asarray(want)).max() <= CCC_TOL
    assert (np.asarray(want) > 0).all()


def test_k20b_plain_matches_embed_sym():
    rng = np.random.default_rng(7)
    n, t = 11, 7
    ov = np.triu(rng.random((n, n)), k=1).astype(np.float32)
    want = np.asarray(_compiled_embed_sym(n, 16)(jnp.asarray(ov), t))
    got = k_enum.sym_trim_plain(torch.as_tensor(ov), t).numpy()
    assert got.shape == (t, t)
    np.testing.assert_array_equal(got, want[:t, :t])
    assert not want[t:].any() and not want[:, t:].any()


# -- K5 at exclude_border 0 ---------------------------------------------------

N = 24
BLOB_A = np.array([[0.0611, -0.0287, -0.0343],
                   [-0.0287, 0.1014, 0.0185],
                   [-0.0343, 0.0185, 0.1305]])


def _blob(x):
    mu = np.array([x, 11.731, 11.552])
    g = np.stack(np.meshgrid(*[np.arange(N)] * 3, indexing="ij"), -1) - mu
    return np.exp(-np.einsum("...i,ij,...j->...", g, BLOB_A, g)
                  ).astype(np.float32)


@pytest.mark.parametrize("face", ["low", "high"])
def test_k5_exclude_border_zero_matches_mad_tpu(face):
    """A peak on the x = 0 face (mad_tpu's lax.dynamic_slice turns the
    patch start -1 into X - 1, then clamps it to X - 3) and on the
    x = X - 1 face (start clamped to X - 3, no IndexError)."""
    vol = _blob(0.0 if face == "low" else N - 1.0)
    jcfg = dataclasses.replace(JConfig().detect, exclude_border=0)
    a = jdet.detect_anchors(jnp.asarray(vol), vol.shape, jcfg)
    n = int(np.sum(np.asarray(a.values) > jcfg.threshold_abs))
    t = tdet.detect_anchors(torch.as_tensor(vol), vol.shape,
                            DetectConfig(**dataclasses.asdict(jcfg)))
    assert t.n == n == 1
    np.testing.assert_array_equal(t.coords.numpy(), np.asarray(a.coords)[:n])
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(a.valid)[:n])
    assert np.abs(t.subvox.numpy() - np.asarray(a.subvox)[:n]).max() \
        <= SUBVOX_TOL
    assert t.coords[0, 0] == (0 if face == "low" else N - 1)


def test_cpu_tensors_take_the_plain_versions():
    for mod in (k5, k16, k17, k_enum):
        mod.launches = 0
    sc = post_scenario(seed=5)
    cands, res = post_round(sc, 0, "cpu")
    sols = []
    tdock._merge_refined(res, cands, sols, sc["sub"],
                         SimpleNamespace(voxsp=2.0), _table(sc), TConfig(),
                         "cpu", N_TOP)
    ov = torch.triu(torch.rand(5, 5), diagonal=1)
    tab = torch.as_tensor(k_enum.comb_table(4, 2))
    assert torch.equal(k_enum.enumerate_head(ov, tab, 3),
                       k_enum.enumerate_head_plain(ov, tab, 3))
    vol = torch.as_tensor(_blob(N - 1.0))
    seeds = torch.tensor([[N - 1, 12, 12], [0, 0, 0]])
    got = k5.localize(vol, seeds, vol.shape, 0.6, 5)
    ref = k5.localize_plain(vol, seeds, vol.shape, 0.6, 5)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert [m.launches for m in (k5, k16, k17, k_enum)] == [0, 0, 0, 0]
    assert len(sols) == 3
