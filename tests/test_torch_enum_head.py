"""K19 and K20's thresholded select (mad_tpu_torch/csrc/enumerate.cu),
modelled in numpy on the CPU, against the plain heads and mad_tpu.

The model follows the kernel step by step: the kernel's scorers (K19's
table decode and masked max, its diagonal folded into the pairs, its rule
for non-finite entries; K20's mixed radix by multiply-shift divisions);
blocks of rank tiles, each keeping a key only below the smaller of its own
head-th kept key and the global word, radix-selecting its buffer (each
pass's digit right below the live keys' highest differing bit, 11 bits
first, then 8, a rank finish at 64 keys) when the next tile might not fit,
and publishing the head-th key; then the final head: the head of each
CTA's share of the blocks' kept keys at or below the final word, the head
of those heads, sorted. Blocks take their tiles in turns, in a given
order. The heads must equal ``enumerate_head_plain`` and
``hetero_head_plain`` bit for bit (keys are unique, so any exact selection
gives the same bits), whatever the order; the enumerations with the model
in place of the kernels must equal mad_tpu's (tuples equal, statistics
within 1e-6, as tests/test_torch_assemble_enum.py).
"""

import math

import numpy as np
import pytest
import torch

from mad_tpu.engine import assemble as jasm
from mad_tpu_torch.engine import assemble as tasm
from mad_tpu_torch.kernels import build
from mad_tpu_torch.kernels import enumerate as k_enum
from mad_tpu_torch.kernels import hetero

torch.set_num_threads(1)

U = np.uint64
NONE = U(0xFFFFFFFFFFFFFFFF)
SMS = 132                           # the H100's SMs, which bound the plan
_C = build.constants("enumerate.cu")


def _pack(scores, ranks):
    s = np.asarray(scores, np.float32)
    bits = np.where(s > 0, s, np.float32(0)).view(np.uint32).astype(U)
    return (bits << U(32)) | np.asarray(ranks).astype(U)


def combo_keys(ov, n, k, ranks):
    """K19's scorer as the kernel forms it."""
    sym = k_enum.sym_trim_plain(torch.as_tensor(ov), n).numpy()
    tab = k_enum.comb_table(n, k).astype(np.int64)
    rem = np.asarray(ranks, np.int64).copy()
    slot = np.zeros_like(rem)
    mask = np.zeros((len(rem), n), bool)
    for x in range(n):
        c = np.where(slot < k, tab[x][np.minimum(slot, k - 1)], 0)
        take = rem < c
        mask[:, x] = take
        slot += take
        rem -= np.where(take, 0, c)
    inside = mask[:, :, None] & mask[:, None, :]
    bad = ~np.isfinite(sym)
    nf = int(bad.sum())
    if nf == 0:
        d = np.diag(sym)
        fold = np.maximum(sym, np.maximum(d[:, None], d[None, :]))
        pairs = inside & (np.triu(np.ones((n, n), bool), 1) if k > 1
                          else np.eye(n, dtype=bool))
        vals = np.where(pairs, fold if k > 1 else sym, -np.inf)
        best = np.maximum(vals.max(axis=(1, 2)), 0)
    else:
        vals = np.where(inside & ~np.isnan(sym), sym, -np.inf)
        best = np.maximum(vals.max(axis=(1, 2)), 0)
        nan = (inside & np.isnan(sym)).any(axis=(1, 2))
        count = (inside & bad).sum(axis=(1, 2))
        best = np.where(nan | (count < nf), 0, best)
    return _pack(best.astype(np.float32), ranks)


def product_keys(ov, lists, sizes, ranks):
    """K20's scorer as the kernel forms it: members by the radix table's
    multiply-shift divisions, the f32 sum in combinations order."""
    sizes, strides, _total = hetero._radix(sizes)
    table = hetero.radix_table(sizes, strides).view(np.uint32).astype(U)
    sym = k_enum.sym_trim_plain(torch.as_tensor(ov), len(ov)).numpy()
    r = np.asarray(ranks).astype(U)

    def quot(g):                        # r // stride_g, 0 above group 0
        return (r * table[g][1]) >> table[g][2] if g >= 0 else U(0) * r

    def member(g):                      # digit q_g - size_g q_{g-1}
        digit = quot(g) - quot(g - 1) * table[g][0]
        return lists[g][digit.astype(np.int64)]

    s = np.zeros(len(r), np.float32)
    for i0 in range(len(sizes)):
        a = member(i0)
        for i1 in range(i0 + 1, len(sizes)):
            s = (s + sym[a, member(i1)]).astype(np.float32)
    return _pack(s, ranks)


def radix_select(keys, need):
    """group_select: the need smallest of the unique keys are those with
    (key & mask) <= prefix. Each pass takes the live keys' AND and OR and
    counts the digit right below their highest differing bit (11 bits
    wide first, then 8); a bin of at most 64 keys is ranked."""
    mask, prefix = U(0), U(0)
    for p in range(64):
        live = keys[(keys & mask) == prefix]
        a = np.bitwise_and.reduce(live)
        top = int(a ^ np.bitwise_or.reduce(live)).bit_length() - 1
        width = min(11 if p == 0 else 8, top + 1)
        shift = top + 1 - width
        digit = U((1 << width) - 1)
        mask = U(0) if top == 63 else U(((1 << 64) - 1)
                                        ^ ((1 << (top + 1)) - 1))
        prefix = a & mask
        bins = np.bincount(((live >> U(shift)) & digit).astype(np.int64),
                           minlength=2048)
        cum = np.cumsum(bins)
        b = int(np.searchsorted(cum, need))
        need -= int(cum[b] - bins[b])
        cnt = int(bins[b])
        prefix |= U(b) << U(shift)
        mask |= digit << U(shift)
        if cnt == need or shift == 0:
            return mask, prefix
        if cnt <= 64:
            fin = np.sort(keys[(keys & mask) == prefix])
            return NONE, fin[need - 1]
    raise AssertionError("the select did not end")


def model_head(keys, head, blocks, tile, room, order, stats=None):
    """The two launches over the rank keys (scored up front: the scorers
    are pure), block b over the tiles b, b + blocks, ..., the blocks taking
    their tiles in turns in ``order``."""
    total = len(keys)
    word = NONE
    buf = [np.empty(0, U) for _ in range(blocks)]
    own = [NONE] * blocks

    def reduce(b):
        nonlocal word
        mask, prefix = radix_select(buf[b], head)
        buf[b] = buf[b][(buf[b] & mask) <= prefix]
        assert len(buf[b]) == head
        own[b] = buf[b].max()
        word = min(word, own[b])
        if stats is not None:
            stats["selects"] += 1

    tiles = [list(range(b * tile, total, blocks * tile)) for b in range(blocks)]
    while any(tiles):
        for b in order:
            if not tiles[b]:
                continue
            base = tiles[b].pop(0)
            if len(buf[b]) + tile > head + room:
                reduce(b)
            tau = min(own[b], word if blocks > 1 else NONE)
            fresh = keys[base:base + tile]
            buf[b] = np.concatenate([buf[b], fresh[fresh < tau]])
    for b in order:
        if len(buf[b]) > head:
            reduce(b)
    if blocks == 1:
        return np.sort(buf[0])

    def head_of(keys):
        if len(keys) <= head:
            return keys
        mask, prefix = radix_select(keys, head)
        return keys[(keys & mask) <= prefix]

    # the final head: each CTA the head of its blocks' keys at or below the
    # word, then the head of those heads
    ctas = (1 if blocks * head <= _C["kOneCta"]
            else min(_C["kCluster"], _C["kFinalKeys"] // head))
    heads = []
    for c in range(ctas):
        mine = np.concatenate(buf[c::ctas])
        heads.append(head_of(mine[mine <= word]))
    kept = np.concatenate(heads)
    assert len(kept) >= min(head, total)      # the invariant
    kept = head_of(kept)
    assert len(kept) == min(head, total)
    return np.sort(kept)


def _orders(blocks, seed):
    rng = np.random.default_rng(seed)
    return {"forward": list(range(blocks)),
            "reversed": list(range(blocks))[::-1],
            "shuffled": list(rng.permutation(blocks))}


def _overlap(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        # 65 % zeros, the rest 0.1 or 0.2; a few diagonal entries too
        ov = np.where(rng.random((n, n)) < 0.35,
                      rng.integers(1, 3, (n, n)) * 0.1, 0.0)
        ov = np.triu(ov, k=1)
        ov[np.diag_indices(n)] = np.where(rng.random(n) < 0.2, 0.15, 0.0)
        return ov
    if kind == "zeros":
        return np.zeros((n, n))
    if kind == "nan":
        ov = np.triu(rng.random((n, n)) * 0.3, k=1)
        ov[1, 4] = ov[3, n - 2] = np.nan
        return ov
    # falling: entries fall with the solution index, so the tuples' keys
    # fall with rank and the threshold prunes least
    i = np.arange(n)
    return np.triu(1.0 / (1.0 + i[:, None] + i[None, :]), k=1)


@pytest.mark.parametrize("kind", ["ties", "zeros", "nan", "falling"])
def test_two_passes_match_the_plain_heads(kind):
    """Small tiles and rooms, so that blocks select and publish often."""
    n, k = 12, 5
    ov = _overlap(n, kind, 3)
    ranks = np.arange(math.comb(n, k))
    keys = combo_keys(ov, n, k, ranks)
    tab = torch.as_tensor(k_enum.comb_table(n, k))
    sizes = [5, 4, 6, 3]
    n_sol = sum(sizes)
    ovh = _overlap(n_sol, kind, 4)
    lists = np.zeros((4, 6), np.int32)
    perm = (np.arange(n_sol) if kind == "falling"
            else np.random.default_rng(5).permutation(n_sol))
    for g, (a, z) in enumerate(zip(np.cumsum([0] + sizes[:-1]),
                                   np.cumsum(sizes))):
        lists[g, : sizes[g]] = perm[a:z]
    hkeys = product_keys(ovh, lists, sizes, np.arange(int(np.prod(sizes))))
    for head, blocks in ((16, 5), (1, 3), (40, 1), (200, 4)):
        want = k_enum.enumerate_head_plain(torch.as_tensor(ov), tab, head)
        hwant = hetero.hetero_head_plain(torch.as_tensor(ovh),
                                         torch.as_tensor(lists), sizes, head)
        for name, order in _orders(blocks, head).items():
            stats = {"selects": 0}
            got = model_head(keys, head, blocks, 24, 48, order, stats)
            assert np.array_equal(got.view(np.int64), want.numpy()), name
            got = model_head(hkeys, head, blocks, 24, 48, order, stats)
            assert np.array_equal(got.view(np.int64), hwant.numpy()), name
            assert stats["selects"] > 0 or head == 200
    if kind == "falling":
        for kk in (keys, hkeys):
            score = (kk >> U(32)).astype(np.uint32).view(np.float32)
            assert np.corrcoef(np.arange(len(kk)), score)[0, 1] < -0.5
    if kind in ("zeros", "nan"):          # K19: keys by rank alone
        assert np.array_equal(keys, ranks.astype(U))


def test_radix_table_divides_exactly():
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.integers(0, 2 ** 31, 20000),
                        [0, 1, 2 ** 31 - 1, 2 ** 31 - 2]]).astype(U)
    for d in [1, 2, 3, 5, 7, 16, 50, 641, 65536, 99991, 2 ** 30 + 3,
              2 ** 31 - 1]:
        m, s = hetero._magic(d)
        assert m < 2 ** 32
        got = (x * U(m)) >> U(s)
        assert np.array_equal(got, x // U(d)), d
        y = (x // U(d)) * U(d)           # multiples, and one below them
        assert np.array_equal((y * U(m)) >> U(s), x // U(d))
        z = y[y > 0] - U(1)
        assert np.array_equal((z * U(m)) >> U(s), z // U(d))


def _same(got, ref, got_notes, ref_notes):
    np.testing.assert_array_equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert got_notes == ref_notes


def test_homomultimer_at_the_fit_shape(monkeypatch):
    """C(16, 10) ranks, head 256, tied maxima: the enumeration with the
    model (the card's plan and tiles) in place of K19 against mad_tpu."""
    n, k, head = 16, 10, 256
    ov = _overlap(n, "ties", 24)
    ov[np.diag_indices(n)] = 0.0
    calls = []

    def model(ovt, tab, h):
        total = math.comb(n, k)
        blocks = k_enum.plan(total, h, SMS)
        calls.append(blocks)
        keys = combo_keys(ovt.numpy(), n, k, np.arange(total))
        return torch.as_tensor(model_head(
            keys, h, blocks, _C["kTile"], _C["kRoom"],
            list(range(blocks))).view(np.int64))

    monkeypatch.setattr(k_enum, "enumerate_head", model)
    jasm.pop_enum_notes()
    tasm.pop_enum_notes()
    ref = jasm.enumerate_homomultimer(n, k, ov, head=head)
    ref_notes = jasm.pop_enum_notes()
    got = tasm.enumerate_homomultimer(n, k, ov, head=head, device="cpu")
    _same(got, ref, tasm.pop_enum_notes(), ref_notes)
    assert calls == [8] and len(ref[0]) == head
    assert ref[3][head - 1] == ref[3][head // 2]       # ties in the head


def test_heteromer_above_four_heads(monkeypatch):
    """10^5 tuples over 50 solutions, head 256: the enumeration with the
    model in place of K20, its blocks taking their tiles in reverse, against
    mad_tpu."""
    sizes, head = [10] * 5, 256
    n_sol = sum(sizes)
    rng = np.random.default_rng(13)
    ov = np.triu(rng.random((n_sol, n_sol)) * 0.2, k=1)
    perm = rng.permutation(n_sol)
    groups = {f"s{g}": [int(x) for x in perm[10 * g: 10 * g + 10]]
              for g in range(5)}
    calls = []

    def model(ovt, lists, sz, h):
        total = int(np.prod(sz))
        blocks = k_enum.plan(total, h, SMS)
        calls.append(blocks)
        keys = product_keys(ovt.numpy(), lists.numpy(), sz,
                            np.arange(total))
        return torch.as_tensor(model_head(
            keys, h, blocks, _C["kTile"], _C["kRoom"],
            list(range(blocks))[::-1]).view(np.int64))

    monkeypatch.setattr(hetero, "hetero_head", model)
    jasm.pop_enum_notes()
    tasm.pop_enum_notes()
    ref = jasm.enumerate_heteromer(groups, ov, head=head)
    ref_notes = jasm.pop_enum_notes()
    got = tasm.enumerate_heteromer(groups, ov, head=head, device="cpu")
    _same(got, ref, tasm.pop_enum_notes(), ref_notes)
    assert calls == [98] and len(ref[0]) == head
