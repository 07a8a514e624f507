"""The dock on a mesh, on the card: the second entry of K10's source (the
merge of the shards' pair heads) and K10's head with a row offset, K16's
stage entries (lanes, dedup, cloud points, table rows, compaction) over
ranges, against their plain PyTorch versions; then the dock on shards
that share one card, and on two cards, against the single-device dock.
Every test here needs a CUDA card and skips without one (the two-card
test without two); the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_dock_mesh_cuda.py

Tolerances: the keys, the eligibility flags, the compaction and the dedup
decisions equal; K16's moved anchors within 1e-12 A of the plain version
(the centroid summed in another order, tests/test_torch_post_cuda.py).
On the card the mesh runs are bit for bit the single-device runs: every
kernel works per row, pair, candidate, lane or point, and the product of
a shard's subunit rows is taken at the whole table's row count. The
parity of the plain versions with mad_tpu's mesh bodies is held on the
CPU by tests/test_torch_dock_mesh.py.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import MadConfig, MatchConfig, RefineConfig
from mad_tpu_torch.convert import grid_from_numpy
from mad_tpu_torch.engine import docking, match
from mad_tpu_torch.engine.match import match_descriptors
from mad_tpu_torch.engine.pipeline import describe_grid, describe_structure
from mad_tpu_torch.engine.refine import refine_candidates
from mad_tpu_torch.kernels import launch_counts, reset_launches
from mad_tpu_torch.kernels import pairs as k10
from mad_tpu_torch.kernels import post as k16
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.parallel.mesh import make_mesh, shard_bounds
from mad_tpu_torch.parallel.step import multichip_step
from mad_tpu_torch.testing import (decoy_transform, make_assembly,
                                   post_round, post_scenario, recording)

pytestmark = pytest.mark.cuda

ANCHOR_TOL = 1e-12
MESH_KERNELS = ("pair_head", "pair_merge", "anchor_field", "approx_repeat",
                "exact_repeat", "cluster_select", "refine", "post",
                "post_lanes", "post_points", "post_rows", "post_compact")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _counted(mod, counter, fn, *args):
    """fn(*args), whose call must add its kernels to mod's counter: K10's
    head and merge two, the others one."""
    before = getattr(mod, counter)
    out = fn(*args)
    assert getattr(mod, counter) == before + (2 if mod is k10 else 1)
    return out


def test_pair_head_offsets_and_merge(cuda):
    """Shard heads with their row offsets, merged, are the whole table's
    head; each entry equals its plain version (ties in value included)."""
    rng = np.random.default_rng(3)
    sim = torch.tensor(rng.random((301, 900)).astype(np.float32),
                       device=cuda)
    sim[5, 7] = sim[5, 9] = sim[200, 3] = sim[1, 1]     # equal cosines
    args = (150, 5000, 0.3)
    whole = k10.pair_head(sim, *args)
    for n in (3, 4, 8):
        b = shard_bounds(sim.shape[0], n)
        heads = []
        for s in range(n):
            blk = sim[b[s]:b[s + 1]]
            h = _counted(k10, "launches", k10.pair_head, blk, *args, b[s],
                         sim.shape[0])
            assert torch.equal(h, k10.pair_head_plain(blk, *args, b[s]))
            heads.append(h)
        keys = torch.cat(heads)
        got = _counted(k10, "merge_launches", k10.pair_merge, keys,
                       whole.numel())
        assert torch.equal(got, k10.pair_merge_plain(keys, whole.numel()))
        assert torch.equal(got, whole)


@pytest.mark.parametrize("last,n_rows,n_top", [(0, 160, 40),
                                               (1, 3000, 2000)],
                         ids=["first", "rescue"])
def test_post_stage_entries(cuda, last, n_rows, n_top):
    """Each stage entry on whole and partial ranges (an empty one launches
    nothing) against its plain version, and the round on 3 shards of the
    card equal to the whole round."""
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
    (rot_m, trans_m, coords_m, failed, cand_rot, cand_hi, cand_lo, x0,
     hi_cloud, lo_cloud, prev, idx, hit, dedup, lo_rows, ad,
     _n) = calls[0][:17]
    C, B, P = coords_m.shape[0], lo_cloud.shape[0], lo_rows.shape[0]
    lane_args = (rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo, x0,
                 hi_cloud, lo_cloud, hit)
    for a, e in ((0, C), (1, C - 1), (2, 4)):
        got = _counted(k16, "lane_launches", k16.post_lanes, *lane_args, a,
                       e - a)
        want = k16.post_lanes_plain(*lane_args, a, e - a)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert float((got[0] - want[0]).abs().max()) <= ANCHOR_TOL
    before = k16.lane_launches
    assert k16.post_lanes(*lane_args, 3, 0)[0].shape[0] == 0
    assert k16.lane_launches == before
    counts = k16.post_lanes_plain(*lane_args, 0, C)[2]
    acc, slot = _counted(k16, "launches", k16.post_dedup, coords_m, failed,
                         counts, prev, idx, dedup)
    want = k16.post_dedup_plain(coords_m, failed, counts, prev, idx, dedup)
    assert torch.equal(acc, want[0]) and torch.equal(slot, want[1])
    assert bool(acc.any())
    pt_args = (lo_cloud, prev, coords_m, acc, ad)
    elig = k16.post_points_plain(*pt_args, 0, B)
    for a, e in ((0, B), (B // 3, B)):
        got = _counted(k16, "point_launches", k16.post_points, *pt_args, a,
                       e - a)
        assert torch.equal(got, elig[a:e])
    row_args = (lo_rows, lo_cloud, elig, prev, coords_m, acc, ad)
    flags = k16.post_rows_plain(*row_args, 0, P)
    for a, e in ((0, P), (P // 2, P - 1)):
        got = _counted(k16, "row_launches", k16.post_rows, *row_args, a,
                       e - a)
        assert torch.equal(got, flags[a:e])
    got = _counted(k16, "compact_launches", k16.post_compact, flags, n_top)
    assert torch.equal(got, k16.post_compact_plain(flags, n_top))
    assert int(got[0]) > 0
    mesh = make_mesh(3, devices=[cuda] * 3)
    a16 = calls[0][:17]
    assert torch.equal(k16.post(*a16, mesh), k16.post(*a16))


@pytest.fixture(scope="module")
def dimer(cuda):
    """chip_smoke.py's SMALL dimer, described once on the card, docked with
    a rescue round that clusters (n_copies 1, 10 samples a round)."""
    c = MadConfig()
    cfg = c.replace(
        detect=dataclasses.replace(c.detect, max_anchors=1024),
        filter=dataclasses.replace(c.filter, rescue_rounds=1, n_samples=10))
    sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([x.coords for x in copies])
    masses = np.concatenate([x.masses for x in copies])
    dmap = simulate_density(coords, 8.0, 2.0, device=cuda,
                            masses=masses).reduce_void()
    moved = decoy_transform(sub)
    m = describe_grid(dmap, cfg, name="map", device=cuda)
    s = describe_structure(moved, 8.0, 2.0, cfg, name="sub", device=cuda)
    args = (m, s, moved, dmap, 8.0, cfg)
    return args, docking.dock_structure(*args, verbose=False,
                                        n_copies=1, device=cuda)


def _bit_equal(got, want):
    assert len(got) == len(want) >= 2
    for a, b in zip(got, want):
        assert np.array_equal(a.structure.coords, b.structure.coords)
        assert (a.weight, a.repeat, a.ccc) == (b.weight, b.repeat, b.ccc)
        assert np.array_equal(a.corresp_anchors, b.corresp_anchors)


@pytest.mark.parametrize("n", [3, 4])
def test_dock_on_shards_of_one_card(cuda, dimer, n):
    args, want = dimer
    reset_launches()
    with recording(docking, "exact_rescore") as rescue:
        got = docking.dock_structure(*args, verbose=False, n_copies=1,
                                     mesh=make_mesh(n, devices=[cuda] * n))
    counts = launch_counts()
    assert all(counts[k] > 0 for k in MESH_KERNELS), counts
    assert len(rescue) == 1 and counts["exact_repeat"] > n
    _bit_equal(got, want)


def test_match_and_refine_on_shards_of_one_card(cuda, dimer):
    (m, s, moved, dmap, _res, cfg), _want = dimer
    mc = MatchConfig(exact_top=64)
    one = match_descriptors(m, s, dmap.shape, dmap.origin, dmap.voxsp, mc,
                            device=cuda)
    got = match_descriptors(m, s, dmap.shape, dmap.origin, dmap.voxsp, mc,
                            mesh=make_mesh(4, devices=[cuda] * 4))
    for k in ("cc", "repeat", "hi_idx", "lo_idx", "rot", "hi_coord"):
        assert np.array_equal(getattr(got, k), getattr(one, k)), k
    rng = np.random.default_rng(2)
    data = rng.random((24, 24, 24)).astype(np.float32)
    starts = (rng.normal(size=(6, 40, 3)) * 4 + 22).astype(np.float32)
    g = grid_from_numpy(data, np.zeros(3), 2.0, device=cuda)
    r1 = refine_candidates(g, starts, RefineConfig(n_steps=40), device=cuda)
    r8 = refine_candidates(g, starts, RefineConfig(n_steps=40),
                           mesh=make_mesh(8, devices=[cuda] * 8))
    for k in ("coords", "rot", "trans", "converged", "steps", "failed"):
        assert np.array_equal(getattr(r8, k), getattr(r1, k)), k


def test_multichip_step_on_one_card(cuda):
    assert multichip_step(4, devices=[cuda] * 4) >= 1


def test_dock_on_two_cards(dimer):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    args, want = dimer
    with recording(match, "approx_repeat") as pairs, \
            recording(k16, "post_rows") as rows:
        got = docking.dock_structure(*args, verbose=False,
                                     n_copies=1, mesh=make_mesh(2))
    cards = {torch.device("cuda", 0), torch.device("cuda", 1)}
    assert {a[6].device for a in pairs} == cards
    assert {a[0].device for a in rows} == cards
    _bit_equal(got, want)
