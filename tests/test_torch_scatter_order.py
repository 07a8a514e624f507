"""K9's order: the plain scatter against numpy and the kernel's buckets.

A voxel's value is the float32 sum, from 0, of its contributions in
(corner, atom) order, the order of mad_tpu's eight ``.at[].add``
scatters (mad_tpu/ops/simulate.py:94-101). ``scatter_atoms_plain`` must
be ``np.add.at`` applied corner by corner, bit for bit, on inputs built to
collide (many atoms on one cell, 60,000+ updates, corners out of the box,
zero masses); a rendering of ``csrc/scatter.cu``'s tile order (count
per voxel tile of the shifted floor cells, exclusive scan, fill in any
order, each tile's candidates sorted by (cell, atom), then per voxel the
cells v - corner in corner order, each cell's atoms in ascending index:
``tile_order`` of test_torch_simulate_tiles.py) must equal it bit for
bit. ``simulate_density`` and ``batched_simulate`` stay
within test_torch_simulate_scalespace.py's tolerance of mad_tpu.
"""

import numpy as np
import pytest
import torch

from mad_tpu.ops import simulate as jsim
from mad_tpu.testing import make_assembly
from mad_tpu_torch.kernels import build, scatter
from mad_tpu_torch.ops import simulate as tsim
from test_torch_simulate_tiles import tile_order

torch.set_num_threads(1)

REL = 1e-5
BOX, MARGIN, VOXSP = (11, 9, 10), 2, 1.4
CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def colliding(seed=0, M=2, N=12000):
    """Atoms around and beyond the box, a quarter of them on one cell and
    one in nine of zero mass: over 60,000 corner updates in the box."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4.0, 17.0, size=(M, N, 3)).astype(np.float32)
    c[:, : N // 4] = np.float32(5.3)
    m = rng.uniform(0.5, 16.0, size=(M, N)).astype(np.float32)
    m[:, ::9] = 0.0
    vm = rng.uniform(-1.0, 1.0, size=(M, 3)).astype(np.float32)
    return c, m, vm


def positions(c, vm):
    g = MARGIN + (c - vm[:, None, :]) / np.float32(VOXSP)
    g0 = np.floor(g)
    w1 = g - g0
    return g0.astype(np.int64), np.float32(1.0) - w1, w1


def weight(m, w0, w1, corner):
    dx, dy, dz = corner
    return (m * (w1[..., 0] if dx else w0[..., 0])
            * (w1[..., 1] if dy else w0[..., 1])
            * (w1[..., 2] if dz else w0[..., 2]))


def numpy_order(c, m, vm):
    i0, w0, w1 = positions(c, vm)
    out = np.zeros((c.shape[0],) + BOX, np.float32)
    for corner in CORNERS:
        w = weight(m, w0, w1, corner)
        idx = i0 + np.asarray(corner)
        keep = ((idx >= 0) & (idx < np.asarray(BOX))).all(-1)
        for s in range(c.shape[0]):
            k = keep[s]
            np.add.at(out[s], tuple(idx[s][k].T), w[s][k])
    return out


def test_plain_is_np_add_at_corner_by_corner():
    c, m, vm = colliding()
    got = scatter.scatter_atoms_plain(torch.as_tensor(c), torch.as_tensor(m),
                                      torch.as_tensor(vm), BOX, MARGIN,
                                      VOXSP)
    ref = numpy_order(c, m, vm)
    i0 = positions(c, vm)[0]
    kept = sum(int(((i0 + np.asarray(k) >= 0)
                    & (i0 + np.asarray(k) < np.asarray(BOX))).all(-1).sum())
               for k in CORNERS)
    assert kept > 60000
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))


def test_kernel_bucket_order_is_the_plain_order():
    """The tile order on a box of one ragged tile, with a crowded cell."""
    c, m, vm = colliding(seed=1, N=3000)
    got, crowded, _pool = tile_order(c, m, vm, box=BOX)
    assert crowded == 2
    got = torch.as_tensor(got)
    ref = scatter.scatter_atoms_plain(torch.as_tensor(c), torch.as_tensor(m),
                                      torch.as_tensor(vm), BOX, MARGIN,
                                      VOXSP)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")
    monkeypatch.setattr(build, "library", no_library)
    before = scatter.launches
    c, m, vm = colliding(seed=2, M=1, N=500)
    got = scatter.scatter_atoms(torch.as_tensor(c), torch.as_tensor(m),
                                torch.as_tensor(vm), BOX, MARGIN, VOXSP)
    assert np.array_equal(got.numpy(), numpy_order(c, m, vm))
    assert scatter.launches == before


def _close(got, ref):
    got = got.detach().cpu().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= REL * scale


@pytest.fixture(scope="module")
def dimer():
    _sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    return (np.concatenate([x.coords for x in copies]),
            np.concatenate([x.masses for x in copies]), _sub)


def test_simulate_density_stays_close_to_mad_tpu(dimer):
    coords, masses, _sub = dimer
    j = jsim.simulate_density(coords, 8.0, 2.0, masses=masses)
    t = tsim.simulate_density(coords, 8.0, 2.0, device="cpu", masses=masses)
    np.testing.assert_array_equal(t.origin, j.origin)
    _close(t.data, j.data)


def test_batched_simulate_stays_close_to_mad_tpu(dimer):
    _c, _m, sub = dimer
    rng = np.random.default_rng(4)
    coords = np.stack([sub.coords + rng.normal(scale=3.0, size=3)
                       for _ in range(4)])
    masses = np.tile(sub.masses, (4, 1))
    dj, oj = jsim.batched_simulate(coords, masses, 10.0, 1.4)
    dt, ot = tsim.batched_simulate(coords, masses, 10.0, 1.4, "cpu")
    np.testing.assert_array_equal(ot, oj)
    _close(dt, dj)
