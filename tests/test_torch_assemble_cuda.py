"""The assembly step's CUDA kernels (K9 scatter, K18 overlap, K19 and K20
enumeration heads) against their plain PyTorch versions, on the card.
Every test here needs a CUDA card and skips without one; the file imports
neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_assemble_cuda.py

Tolerances:
  * K9: bit for bit with the plain version run on the CPU (both add a
    voxel's contributions in mad_tpu's (corner, atom) order), atoms off
    the box edge dropped the same way;
  * K18, K19, K20: equal (integer counts and one IEEE division; the head
    keys (score, rank) are unique, so the selected set and its order are
    defined exactly).
The parity of the plain versions with mad_tpu is held on the CPU by
tests/test_torch_assemble.py and tests/test_torch_assemble_enum.py.
"""

import math

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.config import AssemblyConfig
from mad_tpu_torch.engine import assemble as asm
from mad_tpu_torch.kernels import enumerate as k_enum
from mad_tpu_torch.kernels import hetero, overlap, scatter
from mad_tpu_torch.ops.simulate import scatter_args
from mad_tpu_torch.testing import make_assembly

pytestmark = pytest.mark.cuda

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def solutions():
    """8 copies on a ring and 6 perturbed duplicates of the first six."""
    rng = np.random.default_rng(21)
    _sub, copies = make_assembly(n_copies=8, n_res=30, seed=6, spread=34.0)
    dups = [c.with_coords(c.coords + rng.normal(scale=1.5, size=3))
            for c in copies[:6]]
    return copies + dups


def test_k9_scatter(cuda, solutions):
    coords = np.stack([s.coords for s in solutions])
    masses = np.stack([s.masses for s in solutions])
    masses[3, ::5] = 0.0                          # zero-mass padding atoms
    args = list(scatter_args(coords, masses, 2.0, cuda))
    # Shift two structures so that atoms fall off the box on both sides.
    args[2] = args[2].clone()
    args[2][1] += 6.0
    args[2][2] -= 6.0
    before = scatter.launches
    got = scatter.scatter_atoms(*args)
    assert scatter.launches == before + 1
    want = scatter.scatter_atoms_plain(*[a.cpu() if torch.is_tensor(a)
                                         else a for a in args])
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert float(want[1].sum()) < float(want[0].sum())   # atoms dropped


def test_k18_pack_overlap(cuda, solutions):
    dens, off, frame = asm.overlap_inputs(solutions, AssemblyConfig(), cuda)
    before = overlap.launches
    got = overlap.pack_overlap(dens, off, frame)
    assert overlap.launches == before + 1
    want = overlap.pack_overlap_plain(dens, off, frame)
    assert torch.equal(got, want)
    assert float(got.max()) > 0.3                 # the duplicates overlap


def _ov(ov, cuda):
    """K18's upper-triangular float32 overlap, which the heads read."""
    return torch.as_tensor(ov, dtype=torch.float32, device=cuda)


def _overlap(n, seed, ties):
    """Upper-triangular overlap; ties=True: 65 % zeros, the rest 0.1 or
    0.2, so most tuple maxima tie and the rank decides the head order."""
    rng = np.random.default_rng(seed)
    if ties:
        ov = np.where(rng.random((n, n)) < 0.35,
                      rng.integers(1, 3, (n, n)) * 0.1, 0.0)
    else:
        ov = rng.random((n, n)) * 0.3
    return np.triu(ov, k=1)


@pytest.mark.parametrize("n,k,head,ties", [(14, 6, 32, False),
                                           (25, 6, 16, False),
                                           (16, 8, 64, True)])
def test_k19_enumerate_head(cuda, n, k, head, ties):
    """C(25, 6) = 177,100 ranks span many blocks and the second pass; the
    tie-heavy case pins the (max, rank) order."""
    ov = _ov(_overlap(n, n + k, ties), cuda)
    tab = torch.as_tensor(k_enum.comb_table(n, k), device=cuda)
    before = k_enum.launches
    got = k_enum.enumerate_head(ov, tab, head)
    assert k_enum.launches == before + 1
    want = k_enum.enumerate_head_plain(ov, tab, head)
    assert len(got) == head and torch.equal(got, want)
    ranks, _scores = k_enum.split_keys(got)
    assert len(set(ranks.tolist())) == head < math.comb(n, k)


@pytest.mark.parametrize("n_per,n_groups", [(16, 5), (50, 3)])
def test_k20_hetero_head(cuda, n_per, n_groups):
    """16^5 = 1,048,576 tuples over 80 solutions (sym in shared memory),
    and 50^3 over 150 solutions (sym read from device memory)."""
    rng = np.random.default_rng(12)
    n_sol = n_per * n_groups
    ov = _ov(np.triu(rng.random((n_sol, n_sol)) * 0.2, k=1), cuda)
    lists = torch.arange(n_sol, dtype=torch.int32, device=cuda).reshape(
        n_groups, n_per)
    sizes = [n_per] * n_groups
    before = hetero.launches
    got = hetero.hetero_head(ov, lists, sizes, 256)
    assert hetero.launches == before + 1
    want = hetero.hetero_head_plain(ov, lists, sizes, 256)
    assert len(got) == 256 and torch.equal(got, want)


def test_wrappers_raise_on_mixed_devices(cuda, solutions):
    args = list(scatter_args(np.stack([s.coords for s in solutions[:2]]),
                             np.stack([s.masses for s in solutions[:2]]),
                             2.0, cuda))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError):
        scatter.scatter_atoms(*args)
    dens, off, frame = asm.overlap_inputs(solutions[:3], AssemblyConfig(),
                                          cuda)
    with pytest.raises(ValueError):
        overlap.pack_overlap(dens, off.cpu(), frame)
    sym = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError):
        k_enum.enumerate_head(sym, torch.as_tensor(k_enum.comb_table(8, 3)),
                              4)
    with pytest.raises(ValueError):
        hetero.hetero_head(sym, torch.zeros((2, 4), dtype=torch.int32),
                           [4, 4], 4)
