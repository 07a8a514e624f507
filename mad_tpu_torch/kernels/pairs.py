"""K10's head: the descriptor pairs that matching keeps.

Replaces the selection of mad_tpu/engine/match.py:74-91
(``_compiled_similarity``: ``lax.top_k`` per subunit row, ``lax.top_k``
over the flat row heads, then the ``> threshold`` mask); the cosine
product before it stays ``torch.matmul``. The CUDA source
``csrc/pairs.cu`` keeps each row's head, sorted, by a radix select in
shared memory, then takes the smallest keys of those sorted runs a
bucket of about equal count a block (from a sample of the runs), each
sorted in shared memory (its note has the details): two kernels a call,
and ``launches`` counts both. :func:`pair_head_plain` is the plain
PyTorch version: threshold, sort per row by (value desc, column asc),
cut, and a stable global sort.

Both return int64 keys (``pair_keys``), ascending as unsigned 64-bit
integers, which is the order (value descending, row ascending, column
ascending) of the two ``top_k`` calls, padded with -1 (all bits set) to
``head_length``; :func:`split_pair_keys` turns them back into (cosines,
rows, columns) on the host.

On a mesh (``engine.match.match_pairs(mesh=)``) each shard's head covers
its block of rows, whose first global row ``row0`` goes into the keys, and
:func:`pair_merge`, the second entry of ``csrc/pairs.cu`` (tiles sorted in
shared memory, then the head's global stage over them: two kernels,
``merge_launches`` counts both), keeps the smallest keys of the shards'
heads: the global top of mad_tpu's ``lax.top_k`` over the flat row heads.
:func:`pair_merge_plain` sorts the keys as unsigned integers.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0            # pair_head kernels since the last reset (2 a call)
merge_launches = 0      # pair_merge kernels since the last reset (2 a call)

_C = build.constants("pairs.cu")
PLAN_WORDS = _C["kPlan"]        # the runs' bounds and counts, by atomics
TILE = _C["kTile"]              # keys in each of the merge's sorted runs

_U32 = 1 << 32
_SIGN = 1 << 31


def head_length(dh: int, dl: int, row_cap: int, max_pairs: int) -> int:
    return min(max_pairs, dh * min(row_cap, dl))


def pair_keys(v: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
              dl: int) -> torch.Tensor:
    """int64 keys (~orderable(bits(v))) << 32 | (row * dl + col), stored
    as the two's complement of the unsigned key."""
    u = v.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & (_U32 - 1)
    orderable = torch.where(u >= _SIGN, (_U32 - 1) - u, u | _SIGN)
    hi = (_U32 - 1) - orderable
    hi = torch.where(hi >= _SIGN, hi - _U32, hi)
    return hi * _U32 + (rows.to(torch.int64) * dl + cols.to(torch.int64))


def split_pair_keys(keys: np.ndarray, dl: int):
    """Host decode of a key vector (-1 padding dropped): cosines float32,
    rows and columns int64."""
    k = np.asarray(keys, dtype=np.int64)
    k = k[k != -1].view(np.uint64)
    orderable = ~(k >> np.uint64(32)).astype(np.uint32)
    bits = np.where(orderable & np.uint32(_SIGN),
                    orderable & np.uint32(_SIGN - 1), ~orderable)
    idx = (k & np.uint64(_U32 - 1)).astype(np.int64)
    return bits.astype(np.uint32).view(np.float32), idx // dl, idx % dl


def pair_head_plain(sim: torch.Tensor, row_cap: int, max_pairs: int,
                    threshold: float, row0: int = 0,
                    rows: int = None) -> torch.Tensor:
    dh, dl = sim.shape
    out = torch.full((head_length(dh, dl, row_cap, max_pairs),), -1,
                     dtype=torch.int64, device=sim.device)
    r, c = torch.nonzero(sim > threshold, as_tuple=True)   # row-major
    v = sim[r, c]
    # rank within each row by (value desc, column asc)
    o = torch.sort(v, descending=True, stable=True).indices
    o = o[torch.sort(r[o], stable=True).indices]
    rr = r[o]
    start = torch.searchsorted(rr, rr, right=False)
    rank = torch.arange(rr.shape[0], device=rr.device) - start
    sel = o[rank < min(row_cap, dl)]               # (row, rank) order
    g = torch.sort(v[sel], descending=True, stable=True).indices[:max_pairs]
    sel = sel[g]
    out[:sel.shape[0]] = pair_keys(v[sel], r[sel] + row0, c[sel], dl)
    return out


def pair_head(sim: torch.Tensor, row_cap: int, max_pairs: int,
              threshold: float, row0: int = 0,
              rows: int = None) -> torch.Tensor:
    """Keys of the pairs (row, col) with sim > threshold (compared in
    float32), at most ``row_cap`` per row by (value desc, col asc), then at
    most ``max_pairs`` overall by (value desc, row asc, col asc).

    sim (dh, dl) float32: rows row0 .. row0 + dh - 1 of a table of
    ``rows`` rows (default row0 + dh) with rows * dl < 2**32. Returns
    (head_length,) int64, ascending as unsigned, padded with -1."""
    if sim.device.type == "cpu":
        return pair_head_plain(sim, row_cap, max_pairs, threshold, row0)
    global launches
    sim = sim.to(torch.float32).contiguous()
    build.require_cuda("pair_head", sim)
    dh, dl = sim.shape
    rows = row0 + dh if rows is None else rows
    if rows * dl >= _U32 or row_cap < 1 or not 0 <= row0 <= rows - dh:
        raise ValueError(f"pair_head: {dh} x {dl} cosines do not fit the "
                         "32-bit pair index (or row_cap < 1)")
    k = min(row_cap, dl)
    L = head_length(dh, dl, row_cap, max_pairs)
    out = torch.empty(L, dtype=torch.int64, device=sim.device)
    if L == 0:
        return out
    # each row's sorted run of pow2(k) slots, its count of keys, the plan
    heads = torch.empty(dh * (1 << (k - 1).bit_length()), dtype=torch.int64,
                        device=sim.device)
    counts = torch.empty(dh, dtype=torch.int32, device=sim.device)
    plan = torch.empty(PLAN_WORDS, dtype=torch.int64, device=sim.device)
    build.launch(
        build.library().mad_pair_head, sim.device, sim.data_ptr(), dh, dl, k,
        float(threshold), int(row0), L, heads.data_ptr(), counts.data_ptr(),
        plan.data_ptr(), out.data_ptr())
    launches += 2
    return out


_FLIP = -(1 << 63)      # xor with the sign bit: unsigned order as signed


def pair_merge_plain(keys: torch.Tensor, L: int) -> torch.Tensor:
    return torch.sort(keys ^ _FLIP).values[:L] ^ _FLIP


def pair_merge(keys: torch.Tensor, L: int) -> torch.Tensor:
    """The smallest ``L`` of the int64 keys (as unsigned), ascending: the
    global head of the shards' heads concatenated. L <= len(keys)."""
    if keys.device.type == "cpu":
        return pair_merge_plain(keys, L)
    global merge_launches
    if keys.dtype != torch.int64 or keys.dim() != 1 or not 0 <= L <= len(keys):
        raise ValueError(f"pair_merge: need 1-d int64 keys and L <= "
                         f"{len(keys)}, got {keys.dtype} and {L}")
    build.require_cuda("pair_merge", keys)
    out = torch.empty(L, dtype=torch.int64, device=keys.device)
    if L == 0:
        return out
    work = keys.clone()                    # sorted in place by tiles
    counts = torch.empty(-(-work.shape[0] // TILE), dtype=torch.int32,
                         device=keys.device)
    plan = torch.empty(PLAN_WORDS, dtype=torch.int64, device=keys.device)
    build.launch(build.library().mad_pair_merge, keys.device,
                 work.data_ptr(), work.shape[0], L, counts.data_ptr(),
                 plan.data_ptr(), out.data_ptr())
    merge_launches += 2
    return out
