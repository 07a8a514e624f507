"""Port parity: the dock's shard bodies on a mesh (mad_tpu_torch's
``match_pairs``, ``match_descriptors``, ``exact_rescore`` and
``refine_candidates`` with ``mesh=``, and K16's stages over shards)
against the port's single-device run and against mad_tpu's mesh bodies on
its virtual 8-device CPU mesh (tests/conftest.py), fed the same numpy
inputs. The port's mesh here is shards on the CPU
(``make_mesh(n, devices=["cpu"] * n)``), with the plain versions of the
kernels; shards with no row are included (6 candidates on 8 shards, 4 and
6 lanes on 8).

Required (mad_tpu's own gates between its mesh and single-device runs,
tests/test_parallel.py:84-125):
  * the pair head on 3 and 4 shards: the single-device keys, so the same
    (cosine, row, column) triples in the same order; against mad_tpu's
    mesh head the same pair set, cosines within 2e-6;
  * the match table on 8 shards, keyed by pair: repeatabilities within
    1e-4 and rotations within 1e-6 of the single-device table and of
    mad_tpu's mesh table; the exact re-score of a row subset likewise;
  * the refinement of 6 candidates on 8 shards: the single-device coords
    within 1e-4, converged flags and step counts equal; against mad_tpu's
    mesh run the port's outcome gates (tests/test_torch_refine.py: CA-RMSD
    within 0.1 A, flags equal), the loops rounding in other orders;
  * K16's stages over 3 and 8 shards: the whole round's vector, its
    decisions (hits, counts, accepted, slots, rows) equal and the moved
    anchors within 1e-12 A, in a first and a rescue round.
"""

from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from mad_tpu.core.config import MatchConfig as JMatch
from mad_tpu.core.config import RefineConfig as JRefine
from mad_tpu.core.grid import DensityGrid as JGrid
from mad_tpu.engine import match as jm
from mad_tpu.engine import refine as jref
from mad_tpu.engine.pipeline import DescriptorSet as JSet
from mad_tpu.parallel.mesh import make_mesh as jmake_mesh
from mad_tpu_torch.convert import descriptor_set_from_numpy, grid_from_numpy
from mad_tpu_torch.core.config import MadConfig as TConfig
from mad_tpu_torch.core.config import MatchConfig as TMatch
from mad_tpu_torch.core.config import RefineConfig as TRefine
from mad_tpu_torch.engine import docking as tdock
from mad_tpu_torch.engine import match as tm
from mad_tpu_torch.engine import refine as tref
from mad_tpu_torch.kernels import post as k16
from mad_tpu_torch.parallel.mesh import make_mesh
from mad_tpu_torch.testing import post_round, post_scenario, recording

torch.set_num_threads(1)

CC_TOL, REPEAT_TOL, ROT_TOL = 2e-6, 1e-4, 1e-6
COORD_TOL, POSE_TOL, ANCHOR_TOL = 1e-4, 0.1, 1e-12
GRID = ((64, 64, 64), (0.0, 0.0, 0.0), 2.0)

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs mad_tpu's 8-device CPU mesh")


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _random_sets(n=48, seed=5):
    """tests/test_parallel.py's random descriptor tables, as a mad_tpu and
    a port DescriptorSet each (map, subunit)."""
    rng = np.random.default_rng(seed)

    def rots(k):
        q, _ = np.linalg.qr(rng.normal(size=(k, 3, 3)))
        det = np.linalg.det(q)
        q[:, :, 0] *= np.sign(det)[:, None]
        return q.astype(np.float32)

    def mkset(name):
        desc = rng.integers(0, 50, size=(n, 1024))
        coords = rng.normal(size=(n, 3)) * 12 + 60
        fields = dict(coords=coords.astype(np.float32), map_coords=coords,
                      subv_coords=coords, rfinal=rots(n),
                      octave=np.zeros(n, np.int32),
                      anchor_id=np.arange(n, dtype=np.int32),
                      main_bin=np.zeros(n, np.int32),
                      sec_bin=np.zeros(n, np.int32))
        norm = desc.astype(np.float32)
        norm /= np.linalg.norm(norm, axis=1, keepdims=True)
        return (JSet(desc=desc.astype(np.int16), desc_norm=norm, name=name,
                     **fields),
                descriptor_set_from_numpy(desc=desc, name=name,
                                          device="cpu", **fields))

    (jmap, tmap), (jsub, tsub) = mkset("map"), mkset("sub")
    return jmap, jsub, tmap, tsub


@pytest.fixture(scope="module")
def sets():
    return _random_sets()


def _keyed(t):
    key = t.hi_idx.astype(np.int64) * 1_000_000 + t.lo_idx
    order = np.argsort(key)
    return key[order], t.cc[order], t.repeat[order], t.rot[order]


def _same_table(got, want):
    kg, ccg, repg, rotg = _keyed(got)
    kw, ccw, repw, rotw = _keyed(want)
    np.testing.assert_array_equal(kg, kw)
    np.testing.assert_allclose(ccg, ccw, rtol=0, atol=CC_TOL)
    np.testing.assert_allclose(repg, repw, rtol=0, atol=REPEAT_TOL)
    np.testing.assert_allclose(rotg, rotw, rtol=0, atol=ROT_TOL)


@needs_devices
@pytest.mark.parametrize("n", [3, 4])
def test_pair_head_on_shards(sets, n):
    jmap, jsub, tmap, tsub = sets
    cfg = TMatch(cc_threshold=0.6, max_pairs=4096, exact_top=64)
    one = tm.match_pairs(tmap, tsub, cfg)
    got = tm.match_pairs(tmap, tsub, cfg, mesh=cpu_mesh(n))
    for k in ("ccs", "rows", "cols"):
        np.testing.assert_array_equal(got[k], one[k])
    ref = jm.match_pairs(jmap, jsub, JMatch(cc_threshold=0.6, max_pairs=4096,
                                            exact_top=64),
                         mesh=jmake_mesh(4))
    key = lambda d: d["rows"].astype(np.int64) * 1_000_000 + d["cols"]
    og, orf = np.argsort(key(got)), np.argsort(key(ref))
    np.testing.assert_array_equal(key(got)[og], key(ref)[orf])
    np.testing.assert_allclose(got["ccs"][og], ref["ccs"][orf], rtol=0,
                               atol=CC_TOL)


@needs_devices
def test_match_table_on_shards(sets):
    jmap, jsub, tmap, tsub = sets
    tcfg = TMatch(cc_threshold=0.6, max_pairs=4096, exact_top=64)
    t1 = tm.match_descriptors(tmap, tsub, *GRID, tcfg, min_exact=256,
                              device="cpu")
    t8 = tm.match_descriptors(tmap, tsub, *GRID, tcfg, min_exact=256,
                              mesh=cpu_mesh(8))
    assert t8.n == t1.n > 256
    _same_table(t8, t1)
    j8 = jm.match_descriptors(jmap, jsub, *GRID,
                              JMatch(cc_threshold=0.6, max_pairs=4096,
                                     exact_top=64),
                              min_exact=256, mesh=jmake_mesh(8))
    _same_table(t8, j8)


@needs_devices
def test_exact_rescore_on_shards(sets):
    jmap, jsub, tmap, tsub = sets
    tcfg = TMatch(cc_threshold=0.6, max_pairs=4096, exact_top=64)
    table = tm.match_descriptors(tmap, tsub, *GRID, tcfg, device="cpu")
    rows = np.random.default_rng(7).choice(table.n, 37, replace=False)
    one = tm.exact_rescore(table, rows, 4.0, "cpu")
    got = tm.exact_rescore(table, rows, 4.0, "cpu", mesh=cpu_mesh(8))
    np.testing.assert_allclose(got, one, rtol=0, atol=REPEAT_TOL)
    jtable = jm.MatchTable(**{k: getattr(table, k) for k in (
        "cc", "repeat", "hi_idx", "lo_idx", "rot", "hi_coord", "lo_coord",
        "hi_cloud", "lo_cloud")})
    ref = jm.exact_rescore(jtable, rows, 4.0, mesh=jmake_mesh(8))
    np.testing.assert_allclose(got, ref, rtol=0, atol=REPEAT_TOL)
    assert len(tm.exact_rescore(table, rows[:0], 4.0, "cpu",
                                mesh=cpu_mesh(8))) == 0


@needs_devices
def test_refine_on_shards_with_empty_ones():
    """tests/test_parallel.py:110-124's case: 6 candidates on 8 shards."""
    rng = np.random.default_rng(2)
    data = rng.random((24, 24, 24)).astype(np.float32)
    starts = (rng.normal(size=(6, 40, 3)) * 4 + 22).astype(np.float32)
    tmap = grid_from_numpy(data, np.zeros(3), 2.0, device="cpu")
    r1 = tref.refine_candidates(tmap, starts, TRefine(n_steps=40),
                                device="cpu")
    r8 = tref.refine_candidates(tmap, starts, TRefine(n_steps=40),
                                mesh=cpu_mesh(8))
    np.testing.assert_allclose(r8.coords, r1.coords, rtol=0, atol=COORD_TOL)
    np.testing.assert_array_equal(r8.converged, r1.converged)
    np.testing.assert_array_equal(r8.steps, r1.steps)
    np.testing.assert_array_equal(r8.failed, r1.failed)
    assert all(t.shape[0] == 6 for t in r8.device_out)
    j8 = jref.refine_candidates(JGrid(data=data, origin=np.zeros(3),
                                      voxsp=2.0), starts,
                                JRefine(n_steps=40), mesh=jmake_mesh(8))
    np.testing.assert_array_equal(r8.failed, j8.failed)
    for a, b in zip(r8.coords, j8.coords):
        assert np.sqrt(((a - b) ** 2).sum(-1).mean()) <= POSE_TOL


@pytest.mark.parametrize("last,n_rows,n_top", [(0, 160, 40),
                                               (1, 3000, 2000)],
                         ids=["first", "rescue"])
def test_post_stages_over_shards(last, n_rows, n_top):
    """K16's lane, point and row stages on 3 and 8 shards (lanes, cloud
    points and table rows cut into blocks, some empty on 8: 6 and 4
    lanes) against the whole round, the plain versions throughout."""
    sc = post_scenario(seed=4, n_rows=n_rows)
    table = SimpleNamespace(hi_cloud=sc["hi_cloud"], lo_cloud=sc["lo_cloud"],
                            lo_coord=sc["lo_rows"])
    sols = []
    for r in range(last + 1):
        cands, res = post_round(sc, r, "cpu")
        with recording(tdock, "post") as calls:
            tdock._merge_refined(res, cands, sols, sc["sub"],
                                 SimpleNamespace(voxsp=2.0), table,
                                 TConfig(), "cpu", n_top)
    args = calls[0][:17]
    C, A = args[0].shape[0], args[8].shape[0]
    want = k16.split_post(k16.post_plain(*args).numpy(), C, A, n_top)
    assert want[3].any() and len(want[5]) > 0
    for n in (3, 8):
        got = k16.split_post(k16.post(*args, cpu_mesh(n)).numpy(), C, A,
                             n_top)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
        assert np.abs(got[0] - want[0]).max() <= ANCHOR_TOL
