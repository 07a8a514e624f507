"""K21 (csrc/select_exact.cu: the one launch, each CTA of a cluster
selecting its chunk's head and the first joining them, and the three
launches above its size) and K8 (csrc/gather_norm.cu: rows in registers
with 16-byte access, and the scalar path) against their plain PyTorch
versions on the card. Every test here needs a CUDA card and skips
without one; the file imports neither JAX nor mad_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_select_gather_cuda.py

Tolerance: none, every output bit for bit. K21 on both sides of the one
launch's limits (n_use 2,048 and 2,049; 65,536 and 65,537 rows), P
below the cluster's 8 CTAs, ties at the n_use-th key across the CTAs'
chunks, NaN, -inf and signed zeros, n_use = P at 60,000 rows, and
chip_smoke.K21_EDGE; the one launch equal to the three launches forced
at the same shapes. K8 at the bench's 1,024 bins and at D 8 and 2,048
(one and eight 16-byte loads a lane), with empty octaves and zero rows,
and through the scalar path (a table 2 bytes off alignment, D 1,020); its
quotients (from the row's rounded reciprocal and two FMA corrections)
equal to the card's division for every int16 count and 20,000 rows.
The launch counters count the launches each call makes (K21 one, or two
or three; K8 one). The CPU renderings are held against mad_tpu by
tests/test_torch_select_gather_layout.py.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mad_tpu_torch.kernels import gather_norm as k8
from mad_tpu_torch.kernels import select_exact as k21

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def _same(a, b):
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints).cpu(), b.contiguous().view(ints).cpu())


def _reps(P, seed, cuda, levels=40):
    """Quantized repeatabilities (ties in every CTA's chunk) with signed
    zeros, NaN and infinities, and the rows' poses."""
    rng = np.random.default_rng(seed)
    rep = (rng.integers(0, levels, P) * 2.5).astype(np.float32)
    for value, share in ((0.0, 0.1), (-0.0, 0.1), (np.nan, 0.02),
                         (-np.inf, 0.02), (np.inf, 0.001)):
        rep[rng.random(P) < share] = value
    return [torch.as_tensor(a, device=cuda) for a in (
        rep, rng.normal(size=(P, 3, 3)).astype(np.float32),
        rng.normal(size=(P, 3)).astype(np.float32),
        rng.normal(size=(P, 3)).astype(np.float32))]


def _check_k21(args, n_use, launches):
    k21.launches = 0
    got = k21.select_exact(*args, n_use)
    assert k21.launches == launches
    want = k21.select_exact_plain(*args, n_use)
    assert all(_same(g, w) for g, w in zip(got, want))
    np.testing.assert_array_equal(got[0].cpu().numpy(), np.argsort(
        -args[0].cpu().numpy(), kind="stable")[:n_use])
    return got


# (P, n_use) the one launch takes: P below the cluster's 8 CTAs, chunks
# smaller than n_use, one and two keys a thread in the sort, the bench,
# both limits
ONE = ((1, 1), (7, 3), (7, 7), (333, 64), (5000, 1024), (9000, 2048),
       (20_000, 1025), (46_848, 1024), (46_848, 2048), (65_536, 64))
# just above each limit, and n_use = P (no select)
THREE = ((46_848, 2049), (65_537, 64), (46_848, 46_848))


def test_k21_one_launch_equals_plain_and_three(cuda, monkeypatch):
    """The one launch bit for bit with the plain version and with the
    three launches (forced) on the same inputs."""
    for P, n_use in ONE:
        assert k21.one_launch(P, n_use)
        args = _reps(P, P + n_use, cuda, levels=max(2, P // 400))
        got = _check_k21(args, n_use, 1)
        with monkeypatch.context() as m:
            m.setattr(k21, "one_launch", lambda P, n: False)
            again = _check_k21(args, n_use, 2 if n_use == P else 3)
        assert all(_same(a, b) for a, b in zip(got, again)), (P, n_use)


def test_k21_above_the_one_launch(cuda):
    for P, n_use in THREE:
        assert not k21.one_launch(P, n_use)
        _check_k21(_reps(P, 3 * P + n_use, cuda), n_use,
                   2 if n_use == P else 3)


def test_k21_at_n_use_p_above_shared_memory_and_edge(cuda):
    args = _reps(60_000, 7, cuda)
    _check_k21(args, 60_000, 2)
    # the n_use-th key inside a run of ties, and every key one value
    _check_k21(args, 31_000, 3)
    flat = [torch.full_like(args[0], 12.5)] + args[1:]
    _check_k21(flat, 777, 1)
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    edge = cs.k21_edge_args(cuda)
    _check_k21(edge, cs.K21_EDGE["n_use"], 1)
    _check_k21(edge, cs.K21_EDGE["P"], 2)


def _tables(cuda, D, seed, offset=0):
    """Three octave tables of (L, D) int16 counts with zero rows, the
    middle one kept empty; ``offset`` elements into a flat buffer."""
    rng = np.random.default_rng(seed)
    tables, keeps = [], []
    for L, n in ((300, 120), (40, 0), (500, 333)):
        t = rng.integers(0, 24, (L, D)) * (rng.random((L, D)) < 0.3)
        t[3] = 0
        flat = torch.zeros(L * D + offset, dtype=torch.int16, device=cuda)
        flat[offset:] = torch.as_tensor(t.reshape(-1).astype(np.int16))
        tables.append(flat[offset:].view(L, D))
        keeps.append(torch.as_tensor(np.sort(np.r_[
            3, rng.choice(np.arange(4, L), max(n - 1, 0), replace=False)])
            [:n], device=cuda))
    return tables, keeps


def _check_k8(cuda, D, offset, vector):
    tables, keeps = _tables(cuda, D, D + offset, offset)
    assert k8.vector_path(tables) == vector
    k8.launches = 0
    got = k8.gather_norm(tables, keeps)
    assert k8.launches == 1
    want = k8.gather_norm_plain(tables, keeps)
    assert _same(got[0], want[0]) and _same(got[1], want[1]), (D, offset)
    assert not got[1][0].any() and not got[1][120].any()


def test_k8_vector_path_equals_plain(cuda):
    """The bench's 1,024 bins (four 16-byte loads a lane), 8 (one lane's
    word) and 2,048 (eight a lane)."""
    for D in (1024, 8, 2048):
        _check_k8(cuda, D, 0, True)


def test_k8_scalar_path_equals_plain(cuda):
    """A table 2 bytes off 16-byte alignment, D not a multiple of 8, D
    above the 16-byte path's 2,048."""
    for D, offset in ((1024, 1), (1020, 0), (4096, 0)):
        _check_k8(cuda, D, offset, False)


def test_k8_vector_and_scalar_paths_agree_on_big_rows(cuda):
    """Rows whose squares pass 2^24 and 2^31 in sum: the integer sum of
    both paths alike (the plain float32 sum may round there)."""
    D = 1024
    big = torch.zeros((4, D), dtype=torch.int16, device=cuda)
    big[0, 0], big[0, 1:17] = 2048, 1024
    big[1, :] = 32767
    big[2, ::2] = -32768
    big[3, 5] = -7
    keep = [torch.arange(4, device=cuda)]
    flat = torch.zeros(4 * D + 1, dtype=torch.int16, device=cuda)
    flat[1:] = big.reshape(-1)
    odd = [flat[1:].view(4, D)]
    assert k8.vector_path([big]) and not k8.vector_path(odd)
    v, s = k8.gather_norm([big], keep), k8.gather_norm(odd, keep)
    assert _same(v[0], s[0]) and _same(v[1], s[1])
    c = big.cpu().numpy().astype(np.int64)
    lens = np.sqrt((c * c).sum(axis=1).astype(np.float32))
    np.testing.assert_array_equal(
        v[1].cpu().numpy(), c.astype(np.float32) / lens[:, None])


def test_k8_quotients_equal_the_division(cuda):
    """Every int16 count (64 rows of 1,024 consecutive counts from -32,768)
    and 20,000 rows of random counts at random scales, both paths: each
    unit row equal to the card's IEEE division of the row by the rounded
    root of its exact sum of squares."""
    D = 1024
    g = torch.Generator(device=cuda).manual_seed(18)
    scale = torch.randint(1, 32768, (20_000, 1), device=cuda, generator=g)
    rows = torch.randint(-32768, 32768, (20_000, D), device=cuda,
                         generator=g) % (scale + 1)
    keep = torch.rand((20_000, D), device=cuda, generator=g) < 0.3
    rows = torch.cat([torch.arange(-32768, 32768, device=cuda).view(64, D),
                      rows * keep]).to(torch.int16)
    ss = (rows.double() ** 2).sum(dim=1)
    lens = torch.sqrt(ss.float())[:, None]
    want = torch.where(lens > 0, rows.float() / lens, rows.float())
    keeps = [torch.arange(rows.shape[0], device=cuda)]
    flat = torch.zeros(rows.numel() + 1, dtype=torch.int16, device=cuda)
    flat[1:] = rows.reshape(-1)
    for tables in ([rows], [flat[1:].view(rows.shape)]):
        _desc, unit = k8.gather_norm(tables, keeps)
        assert _same(unit, want)
