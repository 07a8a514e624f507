"""K19: head of the C(n, k) homomultimer ranking by max pair overlap.

Replaces mad_tpu/engine/assemble.py:336-402 (``_compiled_enumerate_head``)
and, folded into its staging, :316-333 (``_compiled_embed_sym``). The heads
read K18's (n, n) upper-triangular overlap ``ov`` and symmetrize its first
t rows and columns as they stage them: ``sym = ov[:t, :t] + ov[:t, :t].T``
(one float32 add an element; one of each off-diagonal pair is 0, so it
equals the float64 sum rounded). :func:`sym_trim_plain` is that staging in
PyTorch, which the heads' plain versions call.

A key is (float bits of the score, clamped at 0) << 32 | rank, so sorting
keys sorts by (score, rank): the tie order of the JAX body's running
``lax.top_k`` merge (earlier chunks and lower ranks first). Keys are
unique, so any exact selection of the ``head`` smallest gives the same
bits.

The CUDA source ``csrc/enumerate.cu`` is a thresholded select in two
launches (its header has the design): blocks of ranks score their tiles
(the combination decoded from the binomial table into a uint64 membership
mask, the masked max of sym) and keep a key only below the smaller of
their own head-th kept key and a global threshold word, radix-selecting
their buffer down to ``head`` keys when it fills and publishing that key
by ``atomicMin``; then one CTA, or a cluster of up to 8 whose CTAs each
select the head of their share of the blocks' kept keys at or below the
final word and gather it in the first, takes the ``head`` smallest and
sorts them. Each threshold is the ``head``-th of ``head`` real keys, so no
key of the head is ever dropped. :func:`plan` sizes the first launch; one block
writes the sorted head in one launch. :func:`enumerate_head_plain` is the
plain PyTorch version: the JAX body's scanned decode into occupancy masks
and masked max, chunked, with a running merge of the same keys. The
helpers here (keys, merge, plan, buffers) serve K20 (:mod:`.hetero`) as
well.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import profiling
from . import build

launches = 0            # kernel launches since the last reset

MAX_RANKS = 2 ** 31 - 1


def comb_table(n: int, k: int) -> np.ndarray:
    """(n, k) int32 table tab[x, i] = C(n-1-x, k-1-i), each entry clamped
    to C(n, k): the decode compares ranks below C(n, k) against it, so the
    clamp changes no decision and keeps every entry in int32."""
    total = math.comb(n, k)
    if total > MAX_RANKS:
        raise ValueError(f"C({n}, {k}) = {total} ranks do not fit int32")
    tab = np.zeros((n, k), np.int32)
    for x in range(n):
        for i in range(k):
            tab[x, i] = min(math.comb(n - 1 - x, k - 1 - i), total)
    return tab


def check_overlap(name: str, ov: torch.Tensor, t: int) -> None:
    """Raise unless ov is a square matrix of at least t rows, t >= 0."""
    if ov.dim() != 2 or ov.shape[0] != ov.shape[1] or not 0 <= t <= len(ov):
        raise ValueError(f"{name}: need a square overlap of at least {t} "
                         f"rows, got {tuple(ov.shape)}")


def sym_trim_plain(ov: torch.Tensor, t: int) -> torch.Tensor:
    """(t, t) float32 ov[:t, :t] + ov[:t, :t]^T of an (n, n) overlap."""
    check_overlap("sym_trim", ov, t)
    block = ov[:t, :t].to(torch.float32)
    return block + block.T


def keys_of(scores: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """int64 keys (bits of max(score, 0)) << 32 | rank."""
    s = torch.where(scores > 0, scores, torch.zeros_like(scores))
    bits = s.to(torch.float32).view(torch.int32).to(torch.int64)
    return (bits << 32) | ranks.to(torch.int64)


def merge_head(best: torch.Tensor, keys: torch.Tensor,
               head: int) -> torch.Tensor:
    return torch.sort(torch.cat([best, keys])).values[:head]


def split_keys(keys: torch.Tensor):
    """Sorted keys -> (ranks int64, scores float32) numpy arrays."""
    k = profiling.pull(keys).numpy().astype(np.int64)
    scores = (k >> 32).astype(np.uint32).view(np.float32)
    return k & 0xFFFFFFFF, scores


_C = build.constants("enumerate.cu")
TILE = _C["kTile"]                  # ranks a first-launch block scores a tile
MAX_HEAD = _C["kMaxHead"]


def plan(total: int, head: int, sms: int) -> int:
    """Blocks of a head's first launch on a card of ``sms`` SMs: a tile of
    ranks each at least, at most one an SM, and no more than the final
    launch's CTAs hold the heads of (each CTA kFinalKeys keys of them, and
    at most kCluster CTAs whose heads together fit in kFinalKeys)."""
    if not 1 <= head <= MAX_HEAD:
        raise ValueError(f"head must be in [1, {MAX_HEAD}], got {head}")
    per_cta = _C["kFinalKeys"] // head
    return max(1, min(-(-total // TILE), sms,
                      min(_C["kCluster"], per_cta) * per_cta))


def card_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def head_buffers(blocks: int, head: int, device):
    """One int64 buffer: the output's ``head`` words, then, with more than
    one block, the first launch's scratch (blocks x head kept keys, the
    threshold word, the blocks' int32 counts)."""
    scratch = blocks * head + 1 + (blocks + 1) // 2 if blocks > 1 else 0
    return torch.empty(head + scratch, dtype=torch.int64, device=device)


def enumerate_head_plain(ov: torch.Tensor, tab: torch.Tensor, head: int,
                         chunk: int = 1 << 14) -> torch.Tensor:
    n, k = tab.shape
    sym = sym_trim_plain(ov, n)
    total = math.comb(n, k)
    dev = sym.device
    tab = tab.to(torch.int64)
    chunk = max(1, min(chunk, (1 << 24) // max(n * n, 1)))
    best = torch.empty(0, dtype=torch.int64, device=dev)
    for c0 in range(0, total, chunk):
        r = torch.arange(c0, min(c0 + chunk, total), device=dev)
        rem, slot = r.clone(), torch.zeros_like(r)
        m2 = torch.zeros((r.shape[0], n), dtype=torch.float32, device=dev)
        for x in range(n):
            c = torch.where(slot < k, tab[x][slot.clamp(max=k - 1)],
                            torch.zeros_like(slot))
            take = rem < c
            m2[:, x] = take.to(torch.float32)
            slot = slot + take.to(torch.int64)
            rem = rem - torch.where(take, torch.zeros_like(c), c)
        s = (sym[None] * m2[:, :, None] * m2[:, None, :]).amax(dim=(1, 2))
        best = merge_head(best, keys_of(s, r), head)
    return best


def enumerate_head(ov: torch.Tensor, tab: torch.Tensor,
                   head: int) -> torch.Tensor:
    """The min(head, C(n, k)) smallest keys (max pair overlap, rank) over
    the C(n, k) ranks, ascending; ov (n_ov, n_ov) float32 overlap, of which
    the first n rows and columns give sym = ov + ov^T, tab = comb_table(n,
    k) as int32 on the same device, n <= 64, 1 <= head <= MAX_HEAD."""
    if ov.device.type == "cpu":
        return enumerate_head_plain(ov, tab, head)
    global launches
    ov = ov.to(torch.float32).contiguous()
    tab = tab.to(torch.int32).contiguous()
    build.require_cuda("enumerate_head", ov, tab)
    n, k = tab.shape
    check_overlap("enumerate_head", ov, n)
    if n > 64 or not 1 <= k <= n:
        raise ValueError(f"enumerate_head: bad table {tuple(tab.shape)} "
                         "(1 <= k <= n <= 64)")
    total = math.comb(n, k)
    blocks = plan(total, head, card_sms(ov.device))
    buf = head_buffers(blocks, head, ov.device)
    lib = build.library()
    build.launch(
        lib.mad_enumerate_head, ov.device, ov.data_ptr(), ov.shape[0],
        tab.data_ptr(), n, k, total, head, blocks, buf.data_ptr() + 8 * head,
        buf.data_ptr())
    launches += 1
    return buf[:min(head, total)]
