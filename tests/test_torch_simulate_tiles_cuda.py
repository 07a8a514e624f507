"""K9's voxel tiles, the simulation body in kernels (K9 with its max, K1's
blur with its divide and max epilogues, the scale-and-clamp pass) and K19 /
K20 reading K18's overlap, against their plain versions on the card. Every
test here needs a CUDA card and skips without one; the file imports
neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_simulate_tiles_cuda.py

Tolerances: bit for bit (a float's sign of zero included). K9 adds a
voxel's terms in mad_tpu's (corner, atom) order, as the plain version does
on the CPU (``index_add_`` on the card adds with atomics, so the plain
scatter runs on the CPU); a NaN voxel compares as NaN (its payload is the
card's or the CPU's). The body equals the plain body whose scatter runs on
the CPU. The heads' keys are unique, so their order is defined exactly.
Their CPU counterparts are tests/test_torch_simulate_tiles.py.
"""

import math

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import AssemblyConfig
from mad_tpu_torch.engine import assemble as asm
from mad_tpu_torch.kernels import conv1d, hetero, maxkey, scatter
from mad_tpu_torch.kernels import enumerate as k_enum
from mad_tpu_torch.ops import convolve
from mad_tpu_torch.ops import simulate as tsim
from mad_tpu_torch.testing import make_assembly

pytestmark = pytest.mark.cuda

K9_REPEATS = 5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def same_bits(a, b):
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32),
                            b[~nan].view(torch.int32)))


def atoms(seed, M, N, box, crowd=0, margin=2, voxsp=1.4):
    """Atoms over and beyond the box, a third of them on tile boundaries
    and faces, ``crowd`` of them on one cell; zero, negative and NaN
    masses."""
    rng = np.random.default_rng(seed)
    span = np.asarray(box) * voxsp
    c = rng.uniform(-3 * voxsp, span + 2 * voxsp,
                    size=(M, N, 3)).astype(np.float32)
    vm = rng.uniform(-1.0, 1.0, size=(M, 3)).astype(np.float32)
    for s in range(M):
        for a in range(3):
            cells = np.arange(-1, box[a], 8)
            pick = rng.choice(np.append(cells, box[a] - 1), size=N // 3)
            c[s, : N // 3, a] = vm[s, a] + (pick + 0.5 - margin) * voxsp
    c[:, N // 3: N // 3 + crowd] = c[:, :1] + np.float32(0.1)
    m = rng.uniform(0.5, 16.0, size=(M, N)).astype(np.float32)
    m[:, ::7] *= -1.0
    m[:, ::9] = 0.0
    m[:, 5:N:997] = np.nan
    return [torch.as_tensor(x) for x in (c, m, vm)]


def k9_against_plain(cpu, box, cuda):
    want = scatter.scatter_atoms_plain(*cpu, box, 2, 1.4)
    before = scatter.launches
    got = []
    for _ in range(K9_REPEATS):
        keys = maxkey.new_keys(cpu[1].shape[0], cuda)
        got.append((scatter.scatter_atoms(*[x.to(cuda) for x in cpu], box, 2,
                                          1.4, max_into=keys), keys))
    assert scatter.launches == before + K9_REPEATS
    assert all(same_bits(g, want) for g, _k in got)
    assert all(torch.equal(k, got[0][1]) for _g, k in got)
    assert torch.equal(got[0][1].cpu(), maxkey.merge_(
        maxkey.new_keys(want.shape[0], "cpu"), want))
    return want


def test_k9_is_the_cpu_plain_version_every_launch(cuda):
    """Ragged tiles on every axis and one shape of the bench's size (the
    models' box), five launches equal, the maxima equal to amax's."""
    box = (45, 37, 70)
    want = k9_against_plain(atoms(1, 3, 20000, box, crowd=300), box, cuda)
    assert torch.isnan(want).any() and (want < 0).any()
    rng = np.random.default_rng(2)
    box = (288, 256, 288)
    c = rng.normal(200.0, 40.0, size=(2, 10400, 3)).astype(np.float32)
    m = np.full((2, 10400), 12.011, np.float32)
    vm = np.full((2, 3), 60.0, np.float32)
    k9_against_plain([torch.as_tensor(x) for x in (c, m, vm)], box, cuda)


def test_k9_crowded_tiles(cuda):
    """5,000 atoms on one cell: the tiles that read it hold more than the
    shared memory's 1,024 candidates and take the pool."""
    box = (40, 24, 64)
    k9_against_plain(atoms(3, 2, 9000, box, crowd=5000), box, cuda)
    c = torch.full((1, 5000, 3), 10.05)
    k9_against_plain([c, torch.ones(1, 5000), torch.zeros(1, 3)], box, cuda)


def _plain_body(args, taps, iso):
    """The plain body with its scatter on the CPU and its blur the plain
    shift-adds on the card."""
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
    grids = scatter.scatter_atoms_plain(*cpu).to(args[0].device)
    real = convolve.conv1d_along
    convolve.conv1d_along = conv1d.conv1d_along_plain
    try:
        return tsim.finish_plain(grids, taps, iso)
    finally:
        convolve.conv1d_along = real


def test_the_body_in_kernels_is_the_plain_body(cuda):
    _sub, copies = make_assembly(n_copies=4, n_res=60, seed=5, spread=30.0)
    coords = np.stack([c.coords for c in copies])
    masses = np.stack([c.masses for c in copies])
    masses[2, ::11] *= -1.0
    args = tsim.scatter_args(coords, masses, 2.0, cuda)
    taps = tsim._blur_taps(10.0 / (math.pi * math.sqrt(2.0)) / 2.0, 4)
    names = ("launches", "divide_launches", "max_launches")
    for iso in (0.0, 0.2):
        before = ([getattr(conv1d, n) for n in names], scatter.launches,
                  scatter.scale_launches)
        got = tsim._simulate_batch(*args, taps, iso)
        after = ([getattr(conv1d, n) for n in names], scatter.launches,
                 scatter.scale_launches)
        assert after[0] == [b + d for b, d in zip(before[0], (3, 1, 1))]
        assert after[1:] == (before[1] + 1, before[2] + 1)
        assert same_bits(got, _plain_body(args, taps, iso))
    # one structure (simulate_density's batch of one)
    one = [a[:1] if torch.is_tensor(a) else a for a in args]
    assert same_bits(tsim._simulate_batch(*one, taps, 0.1),
                     _plain_body(one, taps, 0.1))


def test_conv1d_epilogues(cuda):
    """Null epilogue pointers: the single-axis entry as before, bit for bit
    with the plain shift-add; with them: the wrapper's CPU form."""
    rng = np.random.default_rng(6)
    batch = torch.as_tensor(rng.normal(size=(3, 21, 18, 37))
                            .astype(np.float32))
    taps = tsim._blur_taps(1.3, 4)
    for vol in (batch, batch[0]):
        for axis in range(3):
            for mode in ("same", "full"):
                got = conv1d.conv1d_along(vol.to(cuda), taps, axis, mode)
                assert same_bits(got, conv1d.conv1d_along_plain(
                    vol, taps, axis, mode))
    keys = maxkey.merge_(maxkey.new_keys(3, "cpu"), batch.abs() * 2.0)
    keys[1] = maxkey.merge_(maxkey.new_keys(1, "cpu"),
                            torch.zeros(1, 4))[0]        # max 0: divisor 1e-30
    for vol, k in ((batch, keys), (batch[0], keys[:1])):
        for axis in range(3):
            cpu_max = maxkey.new_keys(k.shape[0], "cpu")
            want = conv1d.conv1d_along(vol, taps, axis, "full", divide_by=k,
                                       max_into=cpu_max)
            card_max = maxkey.new_keys(k.shape[0], cuda)
            got = conv1d.conv1d_along(vol.to(cuda), taps, axis, "full",
                                      divide_by=k.to(cuda),
                                      max_into=card_max)
            assert same_bits(got, want)
            assert torch.equal(card_max.cpu(), cpu_max)


def test_heads_read_k18s_overlap(cuda):
    """K19 on the first t solutions of K18's matrix of a solution set, and
    K20 with the overlap staged in shared memory (80 solutions) and read
    from device memory (150): the keys of the plain staging and heads."""
    _sub, copies = make_assembly(n_copies=8, n_res=30, seed=6, spread=34.0)
    rng = np.random.default_rng(21)
    sols = copies + [c.with_coords(c.coords + rng.normal(scale=1.5, size=3))
                     for c in copies[:6]]
    ov = asm.device_overlap(sols, AssemblyConfig(), cuda)
    for t, k in ((14, 6), (12, 5)):
        tab = torch.as_tensor(k_enum.comb_table(t, k), device=cuda)
        before = k_enum.launches
        got = k_enum.enumerate_head(ov, tab, 64)
        assert k_enum.launches == before + 1
        assert torch.equal(got, k_enum.enumerate_head_plain(ov, tab, 64))
    for n_per, n_groups in ((16, 5), (50, 3)):
        n = n_per * n_groups
        ov = torch.as_tensor(np.triu(rng.random((n, n)) * 0.2, k=1),
                             dtype=torch.float32, device=cuda)
        lists = torch.arange(n, dtype=torch.int32, device=cuda)[
            torch.as_tensor(rng.permutation(n), device=cuda)].reshape(
                n_groups, n_per)
        before = hetero.launches
        got = hetero.hetero_head(ov, lists, [n_per] * n_groups, 256)
        assert hetero.launches == before + 1
        assert torch.equal(got, hetero.hetero_head_plain(
            ov, lists, [n_per] * n_groups, 256))


def test_the_body_raises_on_mixed_devices(cuda):
    _sub, copies = make_assembly(n_copies=2, n_res=20, seed=7, spread=20.0)
    coords = np.stack([c.coords for c in copies])
    masses = np.stack([c.masses for c in copies])
    args = list(tsim.scatter_args(coords, masses, 2.0, cuda))
    taps = tsim._blur_taps(1.3, 4)
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError):
        tsim._simulate_batch(*bad, taps, 0.0)
    vol = torch.zeros((2, 8, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        conv1d.conv1d_along(vol, taps, 0, "full",
                            divide_by=maxkey.new_keys(2, "cpu"))
    with pytest.raises(ValueError):
        scatter.scale_clamp(vol, maxkey.new_keys(2, "cpu"), 0.1)
    with pytest.raises(ValueError):
        scatter.scatter_atoms(*args, max_into=maxkey.new_keys(3, cuda))
