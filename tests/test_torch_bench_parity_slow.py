"""bench.py's fit and mad_tpu's ensemble bench through both packages on
the CPU at full size, held stage by stage against each other and against
the card's witness (tests/torch_witness/bench_h100.json, written by
scripts/torch_witness.py on an H100).

The system is bench.py's: make_assembly(10, 260, seed 0, spread 115,
shell), 10 A at 1.4 A, reduce_void, the decoy of ``_decoy_transform``,
``MadConfig()`` with one rescue round; no scale cut. mad_tpu runs its CPU
paths (``describe_grid`` and ``describe_structure`` called directly, its
split dock as tests/test_torch_slice.py runs it), the port its plain
versions on ``device="cpu"``. Each test is one stage, in pipeline order:

  * the map, within 1e-5 of its maximum (bit equality printed);
  * both DescriptorSets: row counts, anchors a octave, row keys, anchors
    within 1e-4 A, rows equal in >= 99 % (K7's standing tolerance);
  * the match table: the same pair set with the same cosines (swaps within
    1e-6), the same head of exactly scored rows, and the approximate
    repeatability of every pair (K12's plain version against mad_tpu's
    ``_approx_repeat_body`` on the same inputs; pairs with a moved anchor
    within 1e-4 voxel of a .5 edge counted);
  * the first round's candidates; the solutions (10/10 on both sides,
    poses within 0.5 A and 0.05 A median, weights, CCCs within 1e-4);
    the models;
  * mad_tpu's and the port's CPU records held to the witness;
  * the ensemble (scripts/ensemble_bench.py's inputs) through both ``MaD``
    sessions and the witness: the four ``score_ensembles`` columns and
    each conformer's solutions side by side.

``-s`` prints each stage's numbers, seconds and the process's peak memory.
"""

import dataclasses
import os
import resource
import time

import numpy as np
import pytest
import torch

from mad_tpu_torch import witness as W

pytestmark = pytest.mark.slow

torch.set_num_threads(8)

RES, VOXSP, N_COPIES = 10.0, 1.4, 10
SIM_TOL = 1e-6          # similarity swaps (ROADMAP standing tolerance)
ROW_L1 = 8              # K7's standing tolerance for a row
ANCHOR_VOX = 2e-4       # octave voxels, an anchor given mad_tpu's map (Queue 3)
ANCHOR_MATCH = 1e-3     # A, a candidate's anchors given mad_tpu's sets
# rows unequal to mad_tpu's, the port given mad_tpu's grid (recorded on the
# CPU; Queue 3: samples on zone bounds that the last bits decide)
ROWS_UNEQUAL = {"map_set": 10, "sub_set": 8}
CONF0_REL = 1e-3        # the true conformer's four scores, relative
# rows of the card's witness that may differ from a CPU run's, matched by
# what they describe (recorded; Queue 3)
WITNESS_ROWS = {"mad_tpu": {"sub_set": 4}, "the port on the CPU": {"sub_set": 6}}
SEC = {}


def _peak_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _say(what, t0):
    SEC[what] = time.perf_counter() - t0
    print(f"\nbench parity> {what}: {SEC[what]:.1f} s, process peak "
          f"{_peak_gib():.1f} GiB", flush=True)


def _cfg(C):
    c = C()
    return c.replace(filter=dataclasses.replace(c.filter, rescue_rounds=1))


def _mad_tpu_fit(work):
    """mad_tpu's bench fit on the CPU: its map, sets, table (through its
    matching cache), first-round candidates, solutions and models."""
    from mad_tpu.api import _decoy_transform
    from mad_tpu.core.config import MadConfig
    from mad_tpu.engine import assemble as asm
    from mad_tpu.engine import docking, pipeline
    from mad_tpu.ops.simulate import simulate_density
    from mad_tpu.testing import make_assembly
    from mad_tpu import cache
    cfg = _cfg(MadConfig)
    t0 = time.perf_counter()
    sub, copies = make_assembly(n_copies=N_COPIES, n_res=260, seed=0,
                                spread=115.0, shell=True)
    dmap = simulate_density(np.concatenate([c.coords for c in copies]), RES,
                            VOXSP, masses=np.concatenate(
                                [c.masses for c in copies])).reduce_void()
    moved = _decoy_transform(sub)
    _say("mad_tpu build_system", t0)
    t0 = time.perf_counter()
    map_set = pipeline.describe_grid(dmap, cfg, name="bench_map")
    _say("mad_tpu describe_grid", t0)
    t0 = time.perf_counter()
    sub_set = pipeline.describe_structure(moved, RES, dmap.voxsp, cfg,
                                          name="bench_sub")
    _say("mad_tpu describe_structure", t0)
    path = os.path.join(work, "mad_tpu_matching.h5")
    cands = []
    os.environ["MAD_TPU_FUSED_DOCK"] = "0"
    try:
        t0 = time.perf_counter()
        sols = docking.dock_structure(map_set, sub_set, moved, dmap, RES,
                                      cfg, N_COPIES, False, path,
                                      cands.append)
        _say("mad_tpu dock_structure", t0)
    finally:
        del os.environ["MAD_TPU_FUSED_DOCK"]
    t0 = time.perf_counter()
    structures = [s.structure for s in sols]
    ov = asm.solution_overlap(structures, cfg.assembly, defer=True)
    tuples, sums, stds, maxs = asm.enumerate_homomultimer(
        len(sols), min(N_COPIES, len(sols)), ov)
    models = asm.score_models(tuples, sums, stds, maxs, structures, dmap,
                              cfg.assembly, 10, 0.1)
    _say("mad_tpu assembly", t0)
    sg = simulate_density(moved, RES, dmap.voxsp,
                          shape_bucket=cfg.shape_bucket)
    return dict(cfg=cfg, sub=sub, copies=copies, moved=moved,
                dmap=W.host(dmap.data), grid=dmap, sub_grid=W.host(sg.data),
                sub_grid_at=(sg.origin, sg.voxsp), map_set=map_set,
                sub_set=sub_set, table=cache.load_matching(path),
                cands=cands[0], sols=sols, models=models)


def _port_fit(work):
    """The same through the port on the CPU (its plain versions)."""
    from mad_tpu_torch import cache
    from mad_tpu_torch.core.config import MadConfig
    from mad_tpu_torch.engine import docking, pipeline
    from mad_tpu_torch.ops.simulate import simulate_density
    from mad_tpu_torch.testing import (assemble_solutions, build_system,
                                       decoy_transform)
    cfg = _cfg(MadConfig)
    t0 = time.perf_counter()
    sub, copies, dmap = build_system(N_COPIES, 260, VOXSP, RES, 115.0, 0,
                                     device="cpu")
    moved = decoy_transform(sub)
    _say("port build_system", t0)
    t0 = time.perf_counter()
    map_set = pipeline.describe_grid(dmap, cfg, name="bench_map",
                                     device="cpu")
    _say("port describe_grid", t0)
    t0 = time.perf_counter()
    sub_set = pipeline.describe_structure(moved, RES, dmap.voxsp, cfg,
                                          name="bench_sub", device="cpu")
    _say("port describe_structure", t0)
    path = cache.matching_filename(work, "port", cfg.match.cc_threshold,
                                   cfg.filter.weight_threshold,
                                   cfg.filter.n_samples * N_COPIES)
    cands = []
    t0 = time.perf_counter()
    sols = docking.dock_structure(map_set, sub_set, moved, dmap, RES, cfg,
                                  N_COPIES, False, path,
                                  on_filtered=cands.append, device="cpu")
    _say("port dock_structure", t0)
    t0 = time.perf_counter()
    a = assemble_solutions([s.structure for s in sols], dmap, cfg, N_COPIES,
                           device="cpu")
    _say("port assembly", t0)
    return dict(cfg=cfg, copies=copies, moved=moved, dmap=dmap.host(),
                grid=dmap, map_set=map_set, sub_set=sub_set,
                sub_grid=simulate_density(
                    moved, RES, dmap.voxsp, shape_bucket=cfg.shape_bucket,
                    device="cpu").host(),
                table=cache.load_matching(path), cands=cands[0], sols=sols,
                models=a["models"])


def _record(f, approx=None):
    n = f["cfg"].filter.n_samples * N_COPIES
    return W.fit_record(f["dmap"], f["map_set"], f["sub_set"], f["table"], n,
                        f["sols"], f["moved"], f["copies"], f["models"],
                        approx)


def _fed(j, work):
    """Each port stage given mad_tpu's input to it: ``describe_grid`` of
    mad_tpu's map and of its simulated subunit, the match stage and the
    dock on mad_tpu's DescriptorSets, map and decoy."""
    from mad_tpu_torch import cache
    from mad_tpu_torch.convert import descriptor_set_from_numpy, \
        grid_from_numpy
    from mad_tpu_torch.core.config import MadConfig
    from mad_tpu_torch.engine import docking, pipeline
    cfg = _cfg(MadConfig)
    t0 = time.perf_counter()
    jg = j["grid"]
    grid = grid_from_numpy(j["dmap"], jg.origin, jg.voxsp, device="cpu")
    map_set = pipeline.describe_grid(grid, cfg, name="bench_map",
                                     device="cpu")
    sub_set = pipeline.describe_grid(
        grid_from_numpy(j["sub_grid"], *j["sub_grid_at"], device="cpu"),
        cfg, name="bench_sub", device="cpu")
    _say("port describe, given mad_tpu's map and subunit grid", t0)
    sets = [descriptor_set_from_numpy(device="cpu", **_fields(j[k]))
            for k in ("map_set", "sub_set")]
    path = os.path.join(work, "port_fed_matching.h5")
    cands = []
    t0 = time.perf_counter()
    sols = docking.dock_structure(*sets, j["moved"], grid, RES, cfg,
                                  N_COPIES, False, path,
                                  on_filtered=cands.append, device="cpu")
    _say("port dock_structure, given mad_tpu's sets", t0)
    return dict(map_set=map_set, sub_set=sub_set,
                table=cache.load_matching(path),
                cands=cands[0], sols=sols)


def _fields(ds):
    n = ds.n
    return dict(desc=W.host(ds.desc)[:n], coords=ds.coords,
                map_coords=ds.map_coords, subv_coords=ds.subv_coords,
                rfinal=ds.rfinal, octave=ds.octave, anchor_id=ds.anchor_id,
                main_bin=ds.main_bin, sec_bin=ds.sec_bin,
                eqsp_size=ds.eqsp_size, subeqsp_size=ds.subeqsp_size,
                name=ds.name)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("bench_parity"))
    j = _mad_tpu_fit(work)
    t = _port_fit(work)
    f = _fed(j, work)
    stages = W.hold_fit(_record(j), _record(t), _ca(j["moved"]))
    print("\nbench parity> the port's chain against mad_tpu's on the CPU, "
          "by stage: " + "; ".join(
              f"{s['stage']} {'ok' if s['ok'] else 'DIFFERS'}"
              for s in stages)
          + f"; first stage that differs: {W.first_difference(stages)}")
    for s in stages:
        print(f"  {s}")
    return dict(j=j, t=t, f=f)


def _ca(moved):
    return np.asarray(moved.coords, np.float64)[moved.ca_idx]


def test_map(fits):
    """Each package's map and its decoy's simulated grid (describe_structure's
    input) within 1e-5 of the maximum; bit equality printed."""
    for what, j, t in (("map", fits["j"]["dmap"], fits["t"]["dmap"]),
                       ("subunit grid", fits["j"]["sub_grid"],
                        fits["t"]["sub_grid"])):
        assert t.shape == j.shape
        err = float(np.abs(t - j).max())
        print(f"\nbench parity> {what} {t.shape}: max diff {err:g} (gate "
              f"{1e-5 * np.abs(j).max():g}); voxels unequal "
              f"{int((t != j).sum())} of {t.size}; bit for bit "
              f"{np.array_equal(t.view(np.uint32), j.view(np.uint32))}")
        assert err <= 1e-5 * np.abs(j).max()
    np.testing.assert_array_equal(fits["t"]["grid"].origin,
                                  fits["j"]["grid"].origin)


@pytest.mark.parametrize("which", ["map_set", "sub_set"])
def test_descriptor_sets(fits, which):
    """The port's describe given mad_tpu's grid: mad_tpu's rows, anchors
    a octave and keys; anchors within ANCHOR_VOX of an octave voxel; every
    row within K7's L1 of 8 and exactly the recorded rows unequal (Queue
    3). The two chains' own sets (each from its own map) printed."""
    j, t = fits["j"][which], fits["f"][which]
    assert t.n == j.n > 100
    for o in np.unique(j.octave):
        assert (len(np.unique(t.anchor_id[t.octave == o]))
                == len(np.unique(j.anchor_id[j.octave == o])))
    np.testing.assert_array_equal(W.row_keys(t), W.row_keys(j))
    voxsp = np.where(j.octave == 0, 0.5, 1.0)[:, None] * VOXSP
    off = float((np.abs(t.subv_coords - j.subv_coords) / voxsp).max())
    dj = W.host(j.desc)[:j.n].astype(np.int32)
    dt = W.host(t.desc)[:t.n].astype(np.int32)
    l1 = np.abs(dt - dj).sum(axis=1)
    own = W.hold_set(which, W.set_record(fits["j"][which]),
                     W.set_record(fits["t"][which]))
    print(f"\nbench parity> {which}, the port given mad_tpu's grid: {t.n} "
          f"rows, anchors a octave "
          f"{[int(len(np.unique(j.anchor_id[j.octave == o]))) for o in np.unique(j.octave)]}, "
          f"anchors within {off:g} voxel, rows unequal {int((l1 > 0).sum())} "
          f"(L1 {sorted(l1[l1 > 0].tolist())}); each chain on its own "
          f"map: {own}")
    assert off <= ANCHOR_VOX
    assert l1.max() <= ROW_L1
    assert int((l1 > 0).sum()) == ROWS_UNEQUAL[which]


def _japprox(table, grid, cfg):
    """mad_tpu's stage A (field and ``_approx_repeat_body``) on the rows of
    ``table``, padded as mad_tpu's match_descriptors pads them."""
    import jax.numpy as jnp
    from mad_tpu.core.config import bucket
    from mad_tpu.engine import match as jm
    n = table.n
    p = jm.batch_bucket(n, 256, None)
    a_hi = bucket(table.hi_cloud.shape[0], 256)
    a_lo = bucket(table.lo_cloud.shape[0], 256)
    hi = jm._pad_rows(np.asarray(table.hi_cloud, np.float32), a_hi)
    hv = np.zeros(a_hi, bool)
    hv[:table.hi_cloud.shape[0]] = True
    lo = jm._pad_rows(np.asarray(table.lo_cloud, np.float32), a_lo)
    lv = np.zeros(a_lo, bool)
    lv[:table.lo_cloud.shape[0]] = True
    rot = jm._pad_rows(np.asarray(table.rot, np.float32), p)
    rot[n:] = np.eye(3)
    r_vox = max(1, int(round(cfg.anchor_dist / grid.voxsp)))
    lo_vox = np.clip(np.round((lo - np.asarray(grid.origin, np.float32))
                              / grid.voxsp).astype(np.int32), 0,
                     np.asarray(grid.shape) - 1)
    field = jm._compiled_field(tuple(grid.shape), r_vox)(
        jnp.asarray(lo_vox), jnp.asarray(lv))
    rep = jm._compiled_approx_repeat(tuple(grid.shape), a_hi, p, 256)(
        field, jnp.asarray(hi), jnp.asarray(hv),
        jnp.asarray(np.asarray(grid.origin, np.float32)),
        jnp.float32(1.0 / grid.voxsp), jnp.asarray(rot),
        jnp.asarray(jm._pad_rows(np.asarray(table.hi_coord, np.float32), p)),
        jnp.asarray(jm._pad_rows(np.asarray(table.lo_coord, np.float32), p)))
    return np.asarray(rep)[:n]


def test_match_table(fits):
    """The port's match stage given mad_tpu's sets: mad_tpu's pairs with
    its cosines (swaps within 1e-6) and its exactly scored head; K12's
    plain version and mad_tpu's ``_approx_repeat_body`` on every pair of
    mad_tpu's table (the .5-edge pairs counted). The chains' own tables
    printed."""
    j, f = fits["j"], fits["f"]
    jt, tt = j["table"], f["table"]
    assert tt.n == jt.n > 0
    jk, tk = W.pair_keys(jt), W.pair_keys(tt)
    assert set(jk.tolist()) == set(tk.tolist())
    jo, to = np.argsort(jk), np.argsort(tk)
    cc = np.abs(np.asarray(jt.cc)[jo] - np.asarray(tt.cc)[to]).max()
    n = j["cfg"].filter.n_samples * N_COPIES
    head = W.hold_table(W.table_record(jt, n), W.table_record(tt, n))
    t0 = time.perf_counter()
    mine = W.approx_all(jt, j["grid"], j["cfg"].match, "cpu")
    ref = _japprox(jt, j["grid"], j["cfg"].match)
    edge = W.edge_pairs(jt, j["grid"].origin, j["grid"].voxsp)
    differ = mine != ref
    _say("approximate repeat, both packages, all pairs", t0)
    rj, rt = _record(j), _record(fits["t"])
    own = W.hold_table(rj["table"], rt["table"],
                       W.match_rows(rj["sub_set"], rt["sub_set"]),
                       W.match_rows(rj["map_set"], rt["map_set"]))
    print(f"\nbench parity> table, the port given mad_tpu's sets: {tt.n} "
          f"pairs, the same pair set, cosines max diff {cc:g}; head {head}; "
          f"approximate repeat of all {jt.n} pairs: {int(differ.sum())} "
          f"differ; {int(edge.sum())} pairs with a moved anchor within "
          f"{W.EDGE_TOL} voxel of a .5 edge, of which "
          f"{int((differ & edge).sum())} differ; each chain's own table: "
          f"{own}")
    assert cc <= SIM_TOL
    assert head["ok"], head
    assert not differ.any()


def test_candidates(fits):
    """The port's first-round candidates given mad_tpu's sets: mad_tpu's,
    each with its anchors within ANCHOR_MATCH, its weight and its rotation
    within 1e-5."""
    j, t = fits["j"]["cands"], fits["f"]["cands"]
    print(f"\nbench parity> first-round candidates, the port given "
          f"mad_tpu's sets: {len(t)} / {len(j)} (port / mad_tpu); each "
          f"chain's own: {len(fits['t']['cands'])}")
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
        assert np.abs(a.hi_coord - b.hi_coord).max() <= ANCHOR_MATCH
        assert np.abs(a.lo_coord - b.lo_coord).max() <= ANCHOR_MATCH
        assert a.weight == b.weight
        np.testing.assert_allclose(a.rot, b.rot, rtol=0, atol=1e-5)


def test_solutions_and_models(fits):
    """Each chain's own solutions and models (10/10 on both sides, poses
    within 0.5 A and 0.05 A median, weights, CCCs, model tuples), and the
    port's dock given mad_tpu's sets against mad_tpu's solutions."""
    j, t = fits["j"], fits["t"]
    rt, rj = _record(t), _record(j)
    ca = _ca(j["moved"])
    s = W.hold_solutions(rj["solutions"], rt["solutions"], ca,
                         (rj["recovered"], rt["recovered"]))
    m = W.hold_models(rj["models"], rt["models"])
    fed = W.hold_solutions(rj["solutions"], W.solutions_record(
        fits["f"]["sols"], j["moved"]), ca)
    print(f"\nbench parity> each chain's own: solutions {s}; models {m}; "
          f"the port's dock given mad_tpu's sets: {fed}")
    assert rt["recovered"] == rj["recovered"] == N_COPIES
    assert s["ok"] and m["ok"] and fed["ok"]


def test_witness_fit(fits):
    """mad_tpu's CPU fit held to the card's witness, every stage, rows
    matched by what they describe (the recorded rows may differ, Queue 3);
    the port's CPU fit printed beside it."""
    w = W.load()
    j, t = fits["j"], fits["t"]
    ca = _ca(j["moved"])
    out = {}
    for name, f in (("mad_tpu", j), ("the port on the CPU", t)):
        r = _record(f, W.approx_all(f["table"], f["grid"], f["cfg"].match,
                                    "cpu"))
        out[name] = W.hold_fit(w["fit"], r, ca, WITNESS_ROWS[name])
        print(f"\nbench parity> the card's witness ({w['card']}, "
              f"{w['commit']}) against {name}: first stage that differs "
              f"{W.first_difference(out[name])}")
        for st in out[name]:
            print(f"  {st}")
    assert W.first_difference(out["mad_tpu"]) is None


def _mad_tpu_ensemble(work: str) -> dict:
    """scripts/ensemble_bench.py's steps through mad_tpu's ``MaD`` in
    ``work``: the ensemble record (``witness.ensemble_record``)."""
    import contextlib
    import io
    from mad_tpu import MaD
    from mad_tpu.core.grid import write_mrc
    from mad_tpu.core.structure import write_pdb
    from mad_tpu.ops.simulate import simulate_density
    from mad_tpu.testing import deform_structure, make_assembly
    from mad_tpu_torch.testing import DECOY_SCALES
    ens = os.path.join(work, "conformers")
    os.makedirs(ens)
    sub, copies = make_assembly(n_copies=N_COPIES, n_res=260, seed=0,
                                spread=115.0, shell=True)
    dmap = simulate_density(np.concatenate([c.coords for c in copies]), RES,
                            VOXSP, masses=np.concatenate(
                                [c.masses for c in copies])).reduce_void()
    write_mrc(dmap, os.path.join(work, "bench_map.mrc"))
    write_pdb(sub, os.path.join(ens, "conf_0.pdb"))
    for i, scale in enumerate(DECOY_SCALES, start=1):
        write_pdb(deform_structure(sub, scale, seed=i),
                  os.path.join(ens, f"conf_{i}.pdb"))
    mad = MaD(workdir=work)
    with contextlib.redirect_stdout(io.StringIO()):
        mad.add_map(os.path.join(work, "bench_map.mrc"), resolution=RES)
        mad.add_subunit(ens, n_copies=N_COPIES, identifier="conformers")
        mad.run(transform_subunits=True)
        rows = mad.score_ensembles()["conformers"]
    return W.ensemble_record(rows, mad.solutions)


def test_ensemble(tmp_path):
    """scripts/ensemble_bench.py's inputs through mad_tpu's MaD and the
    port's (``testing.run_ensemble_bench``) on the CPU, beside the card's
    witness: the four columns and each conformer's solutions. mad_tpu's
    session runs in a process of its own on one CPU device: under the
    tests' virtual 8-device mesh its replay of compiled programs can wait
    on a collective that never completes (ROADMAP, the known race)."""
    import contextlib
    import io
    import json
    import subprocess
    import sys
    from mad_tpu_torch.testing import run_ensemble_bench
    work = tmp_path / "mad_tpu"
    work.mkdir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [root] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    env.pop("XLA_FLAGS", None)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, __file__, str(work),
                    str(tmp_path / "mad_tpu.json")], env=env, check=True,
                   timeout=3600)
    with open(tmp_path / "mad_tpu.json") as fh:
        jrec = json.load(fh)
    _say("mad_tpu ensemble (its own process, peak "
         f"{resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2 ** 20:.1f}"
         " GiB)", t0)
    t0 = time.perf_counter()
    (tmp_path / "port").mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        r = run_ensemble_bench(str(tmp_path / "port"), device="cpu",
                               log=lambda line: None)
    trec = W.ensemble_record(r["rows"], r["mad"].solutions)
    _say("port ensemble", t0)
    cols = ("Repeatability", "Weight", "mCC", "RWmCC")
    print("\nbench parity> ensemble, mad_tpu (CPU) / port (CPU): "
          + repr((jrec, trec)))
    wrec = W.load()["ensemble"]
    print("\nbench parity> ensemble, mad_tpu (CPU) / port (CPU) / port "
          "(card's witness):")
    for a, b, c in zip(jrec["rows"], trec["rows"], wrec["rows"]):
        print(f"  {a[0]}: " + "; ".join(
            f"{n} {a[k]:.4f} / {b[k]:.4f} / {c[k]:.4f}"
            for k, n in enumerate(cols, start=1)))
    for k in jrec["solutions"]:
        print(f"  {k} (repeat, weight, CC) mad_tpu {jrec['solutions'][k]}"
              f"\n    port {trec['solutions'][k]}"
              f"\n    card {wrec['solutions'][k]}")
    for k, n in enumerate(cols, start=1):
        print(f"  top by {n}: {W.ensemble_top(jrec['rows'], k)} / "
              f"{W.ensemble_top(trec['rows'], k)} / "
              f"{W.ensemble_top(wrec['rows'], k)}")
    names = [x[0] for x in jrec["rows"]]
    assert names == [x[0] for x in trec["rows"]] == [x[0] for x in
                                                     wrec["rows"]]
    # the same conformer first by each of the four columns on all three
    # (mad_tpu's Weight too: Queue 3), and the true conformer's row
    for k in range(1, 5):
        assert (W.ensemble_top(jrec["rows"], k) == W.ensemble_top(
            trec["rows"], k) == W.ensemble_top(wrec["rows"], k) == "conf_0")
    for rec in (trec, wrec):
        a, b = jrec["rows"][0][1:], rec["rows"][0][1:]
        assert max(abs(x - y) / abs(x) for x, y in zip(a, b)) <= CONF0_REL


if __name__ == "__main__":
    import json
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    with open(sys.argv[2], "w") as fh:
        json.dump(_mad_tpu_ensemble(sys.argv[1]), fh)
