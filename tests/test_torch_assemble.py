"""Port parity: the assembly step (mad_tpu_torch/engine/assemble.py with
the plain versions of K9 and K18) against mad_tpu on the same numpy
solutions, on the CPU.

Solution sets: tests/test_assemble.py's fixture (4 copies + 1 duplicate),
its mixed-size case, and 14 solutions (8 copies on a ring + 6 perturbed
duplicates), handed to the port through convert.structure_from_numpy.

Tolerances:
  * solution_overlap: atol 1e-6, plus, where a solution has voxels whose
    unclamped 5 A density lies within 1e-5 of the 0.2 isovalue (on either
    side), the most those voxels can move the fractions
    (testing.overlap_slack);
  * score_models: the same model components, CCC within 1e-5, the
    overlap statistics within 1e-6;
  * the assembly step as a whole (overlap -> enumerate_homomultimer on
    the device branch, C(14, 8) = 3,003 > 4 * 256 -> score_models): the
    same model list, CCC within 1e-5;
  * batched_simulate (K9 plain + K1 plain): 1e-5 of the volume's max, as
    in test_torch_simulate_scalespace.py; the scatter's dropped corners
    against a float64 numpy scatter: 1e-5 of the grid's max.
"""

import numpy as np
import pytest
import torch

from mad_tpu.core.config import AssemblyConfig as JAssembly
from mad_tpu.core.structure import Structure as JStructure
from mad_tpu.engine import assemble as jasm
from mad_tpu.ops import simulate as jsim
from mad_tpu.testing import make_assembly as jmake_assembly
from mad_tpu_torch.convert import grid_from_numpy, structure_from_numpy
from mad_tpu_torch.core.config import AssemblyConfig as TAssembly
from mad_tpu_torch.engine import assemble as tasm
from mad_tpu_torch.kernels import scatter
from mad_tpu_torch.ops import simulate as tsim
from mad_tpu_torch.ops.simulate import scatter_args
from mad_tpu_torch.testing import near_isovalue, overlap_slack

torch.set_num_threads(1)

OV_ATOL, CCC_TOL, STAT_TOL, REL = 1e-6, 1e-5, 1e-6, 1e-5


def _port(structs):
    out = [structure_from_numpy(s.coords, s.masses, s.ca_idx, s.bb_idx,
                                source=s.source) for s in structs]
    for a, b in zip(out, structs):
        assert a.coords.dtype == np.float64 and a.masses.dtype == np.float32
        assert a.n_atoms == b.n_atoms and a.coords is not b.coords
    return out


@pytest.fixture(scope="module")
def five():
    _sub, copies = jmake_assembly(n_copies=4, n_res=30, seed=5, spread=30.0)
    return copies + [copies[0].with_coords(copies[0].coords + 1.0)]


def _fourteen():
    rng = np.random.default_rng(21)
    _sub, copies = jmake_assembly(n_copies=8, n_res=30, seed=6, spread=34.0)
    dups = [c.with_coords(c.coords + rng.normal(scale=1.5, size=3))
            for c in copies[:6]]
    return copies, copies + dups


def _solution_set(name, five):
    if name == "five":
        return five
    if name == "mixed":
        s = five[3]
        small = JStructure(coords=s.coords[:100], masses=s.masses[:100],
                           ca_idx=np.arange(0), bb_idx=np.arange(0))
        return five[:3] + [small]
    return _fourteen()[1]


def _near(sols, tsols):
    """Near-isovalue and occupied voxel counts, the larger of both sides."""
    coords, masses = tasm.atom_batch([[s] for s in tsols])
    cfg = JAssembly()
    dj, _ = jsim.batched_simulate(coords, masses, cfg.sim_resolution,
                                  cfg.sim_voxsp)
    dj = np.asarray(dj)
    near_j = (np.abs(dj - cfg.sim_isovalue) <= 1e-5).sum(axis=(1, 2, 3))
    near_t, occ = near_isovalue(tsols, TAssembly(), "cpu")
    return np.maximum(near_t, near_j), occ


@pytest.mark.parametrize("name", ["five", "mixed", "fourteen"])
def test_solution_overlap(five, name):
    sols = _solution_set(name, five)
    tsols = _port(sols)
    ref = jasm.solution_overlap(sols, JAssembly())
    got = tasm.solution_overlap(tsols, TAssembly(), "cpu")
    assert got.shape == ref.shape == (len(sols), len(sols))
    assert got.dtype == np.float64 and np.all(np.tril(got) == 0)
    tol = overlap_slack(*_near(sols, tsols), OV_ATOL)
    assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()
    if name != "mixed":
        assert got.max() > 0.5                 # the duplicates overlap


def _same_models(got, ref):
    assert [m.components for m in got] == [m.components for m in ref]
    for a, b in zip(got, ref):
        assert abs(a.ccc - b.ccc) <= CCC_TOL, (a.ccc, b.ccc)
        for f in ("sum_overlap", "std_overlap", "max_overlap"):
            assert abs(getattr(a, f) - getattr(b, f)) <= STAT_TOL


def test_score_models(five):
    cfg = JAssembly()
    coords = np.concatenate([s.coords for s in five[:4]])
    masses = np.concatenate([s.masses for s in five[:4]])
    jmap = jsim.simulate_density(coords, 8.0, 2.0, masses=masses)
    tmap = grid_from_numpy(np.asarray(jmap.data), jmap.origin, jmap.voxsp,
                           device="cpu")
    ov = jasm.solution_overlap(five, cfg)
    tuples, sums, stds, maxs = jasm.enumerate_homomultimer(5, 4, ov)
    ref = jasm.score_models(tuples, sums, stds, maxs, five, jmap, cfg,
                            max_models=3, max_overlap=0.1)
    got = tasm.score_models(tuples, sums, stds, maxs, _port(five), tmap,
                            TAssembly(), max_models=3, max_overlap=0.1)
    assert ref and ref[0].components == [0, 1, 2, 3]
    _same_models(got, ref)


def test_assembly_step():
    copies, sols = _fourteen()
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    jmap = jsim.simulate_density(coords, 8.0, 2.0, masses=masses)
    tmap = grid_from_numpy(np.asarray(jmap.data), jmap.origin, jmap.voxsp,
                           device="cpu")
    jcfg, tcfg = JAssembly(), TAssembly()
    jasm.pop_enum_notes()
    tasm.pop_enum_notes()

    ov = jasm.solution_overlap(sols, jcfg)
    jt = jasm.enumerate_homomultimer(len(sols), 8, ov)
    ref = jasm.score_models(*jt, sols, jmap, jcfg, 10, 0.1)

    tsols = _port(sols)
    tov = tasm.solution_overlap(tsols, tcfg, "cpu")
    tt = tasm.enumerate_homomultimer(len(tsols), 8, tov, device="cpu")
    got = tasm.score_models(*tt, tsols, tmap, tcfg, 10, 0.1)

    assert len(jt[0]) == 256                   # the device branch ran
    np.testing.assert_array_equal(tt[0], jt[0])
    assert tasm.pop_enum_notes() == jasm.pop_enum_notes()
    assert len(ref) > 1 and sorted(ref[0].components) == list(range(8))
    _same_models(got, ref)


@pytest.mark.parametrize("res,voxsp,iso", [(5.0, 2.0, 0.2), (4.0, 1.4, 0.0)])
def test_batched_simulate_padded(five, res, voxsp, iso):
    """The overlap's and the model scores' simulations: mixed atom counts
    padded with zero-mass atoms, through K9's plain version."""
    coords, masses = tasm.atom_batch([[s] for s in
                                      _solution_set("mixed", five)])
    dj, oj = jsim.batched_simulate(coords, masses, res, voxsp, isovalue=iso)
    dt, ot = tsim.batched_simulate(coords, masses, res, voxsp, "cpu",
                                   isovalue=iso)
    np.testing.assert_array_equal(ot, oj)
    dj = np.asarray(dj)
    assert dt.shape == dj.shape
    assert np.abs(dt.numpy() - dj).max() <= REL * np.abs(dj).max()


def test_scatter_drops_corners_off_the_box(five):
    """Atoms moved across every face of the box: corners outside are
    dropped, those inside still land, as mode="drop" does."""
    coords = np.stack([s.coords for s in five])
    masses = np.stack([s.masses for s in five])
    c, w, vm, box, margin, voxsp = scatter_args(coords, masses, 2.0, "cpu")
    vm = vm + torch.tensor([[6.0, 0, 0], [-6.0, 0, 0], [0, 6.0, -6.0],
                            [0, 0, 0], [-200.0, -200.0, -200.0]])
    got = scatter.scatter_atoms(c, w, vm, box, margin, voxsp).numpy()
    ref = np.zeros((len(five),) + box)
    g = margin + (c.double().numpy() - vm.double().numpy()[:, None]) / voxsp
    i0 = np.floor(g).astype(int)
    f = g - i0
    for s in range(len(five)):
        for corner in np.ndindex(2, 2, 2):
            idx = i0[s] + corner
            wt = masses[s].astype(np.float64)
            for a in range(3):
                wt = wt * (f[s, :, a] if corner[a] else 1 - f[s, :, a])
            keep = ((idx >= 0) & (idx < box)).all(axis=1)
            np.add.at(ref[s], tuple(idx[keep].T), wt[keep])
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()
    assert got[4].sum() == 0.0                 # all off the box
    assert 0 < got[0].sum() < got[3].sum()     # some corners dropped
