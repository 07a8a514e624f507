"""K4: LoG peak mask + compaction, then the exact top-k by response.

Replaces mad_tpu/ops/detect.py:48-52 and 165-212 (``_maxpool3``, the peak
mask of ``detect_counts`` and ``topk_flat``). The CUDA kernel
``csrc/peaks.cu`` streams the own rows and appends every peak as one
64-bit key (:func:`peak_keys_plain`: the value's descending order, then
the flat index), sorts up to ``SORT_MAX`` keys in one block and writes the
first ``capacity`` with their values read back from the volume; the
wrapper sorts more keys with ``torch.sort`` to the same effect
(:func:`topk_from_keys`). Either gives the order (-value, flat index) of
``lax.top_k``, +0.0 above -0.0 included. :func:`peak_topk_plain` is the
plain version: ``max_pool3d`` + mask + ``nonzero`` + a stable sort by
(-value, index) (:func:`_order`).

Both take an offset form for capacity mode (mad_tpu/ops/detect.py:236-275,
``detect_shard``): ``vol`` is a shard's x-slab extended by its neighbours'
rows, of which rows ``[row0, row0 + rows)`` are the shard's own; the
others only serve the 3x3x3 neighbourhood. ``x0`` is the global x of own
row 0: the border test is in global coordinates and the indices returned
are global (int64), so an x-sharded field may hold 2^31 voxels or more as
long as one shard's own rows hold fewer. The defaults are the whole volume.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import build

launches = 0            # kernel launches since the last reset

# First guesses of the key buffer and of the candidate buffer (csrc/
# peaks.cu: a fill count and a region a warp of its stream); a volume with
# more peaks, or a warp with more candidates than its region, is rerun
# with the room the first launch measured.
_FIRST_CAPACITY = 1 << 16
_FIRST_CANDIDATES = 1 << 21
# the most peaks the kernel's own order pass sorts (more: torch.sort of
# the keys, topk_from_keys)
SORT_MAX = build.constants("peaks.cu")["kSortMax"]


_LOW = 0xFFFFFFFF
_SIGN = 0x80000000


def value_keys(vals: torch.Tensor) -> torch.Tensor:
    """int64 keys in [-2^31, 2^31) whose ascending order is the float32
    values' descending order as ``lax.top_k`` ranks them: a total order of
    the float's bits, +0.0 above -0.0 (``torch.sort`` ties the two)."""
    bits = vals.contiguous().view(torch.int32).to(torch.int64) & _LOW
    up = torch.where(bits >= _SIGN, _LOW - bits, bits | _SIGN)
    return (_SIGN - 1) - up


def _order(vals: torch.Tensor, idx: torch.Tensor, capacity: int):
    """Sort by (-value, index), values in ``lax.top_k``'s order
    (:func:`value_keys`), and keep the first ``capacity``."""
    idx, perm = torch.sort(idx, stable=True)
    vals = vals[perm]
    _, perm = torch.sort(value_keys(vals), stable=True)
    return vals[perm][:capacity], idx[perm][:capacity]


def peak_keys_plain(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's int64 key of each (float32 value, own-row index < 2^31):
    the high 32 bits :func:`value_keys`, the low 32 bits the index.
    Ascending keys are :func:`_order`'s order."""
    return value_keys(vals) * (1 << 32) + idx.to(torch.int64)


def key_index(keys: torch.Tensor) -> torch.Tensor:
    """The own-row flat index (int64) of each key."""
    return keys & _LOW


def topk_from_keys(vol: torch.Tensor, keys: torch.Tensor, capacity: int,
                   row0: int, rows: int, x0: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``capacity`` peaks of the own rows' keys (in any order):
    their values read from ``vol`` and their global flat indices (int64),
    in :func:`_order`'s order."""
    Y, Z = vol.shape[1:]
    idx = key_index(torch.sort(keys).values[:capacity])
    vals = vol[row0:row0 + rows].reshape(-1)[idx]
    if x0:
        idx += int(x0) * Y * Z
    return vals, idx


def _interior(shape, real_shape, border: int, device, x0: int = 0
              ) -> torch.Tensor:
    m = []
    for a in range(3):
        r = torch.arange(shape[a], device=device) + (x0 if a == 0 else 0)
        m.append((r >= border) & (r < real_shape[a] - border))
    return m[0][:, None, None] & m[1][None, :, None] & m[2][None, None, :]


def _own_rows(vol, row0: int, rows) -> int:
    rows = vol.shape[0] - row0 if rows is None else int(rows)
    if row0 < 0 or rows < 0 or row0 + rows > vol.shape[0]:
        raise ValueError(f"peak_topk: own rows [{row0}, {row0 + rows}) "
                         f"outside a block of {vol.shape[0]}")
    return rows


def peak_topk_plain(vol: torch.Tensor, real_shape, threshold: float,
                    border: int, capacity: int, row0: int = 0, rows=None,
                    x0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    rows = _own_rows(vol, row0, rows)
    pooled = F.max_pool3d(vol[None, None], 3, stride=1,
                          padding=1)[0, 0, row0:row0 + rows]
    own = vol[row0:row0 + rows]
    is_peak = ((own >= pooled) & (own > threshold)
               & _interior(own.shape, real_shape, border, vol.device, x0))
    idx = torch.nonzero(is_peak.reshape(-1)).reshape(-1)
    return _order(own.reshape(-1)[idx],
                  idx + x0 * vol.shape[1] * vol.shape[2], capacity)


def compact(vol: torch.Tensor, real_shape, threshold: float, border: int,
            row0: int, rows: int, x0: int, keys: torch.Tensor,
            cand: torch.Tensor, counter: torch.Tensor, vals: torch.Tensor,
            idx: torch.Tensor) -> None:
    """One launch of K4 on a contiguous CUDA volume: the own rows' peaks as
    keys into ``keys`` (int64, in no order); ``cand`` (int32) the
    candidates' scratch; ``counter`` (3,) int32: the number of peaks, the
    most candidates one warp of the stream found and its warps. Peaks past
    ``len(keys)``, or candidates past a warp's region
    (:func:`candidate_room`), are lost and call for a rerun with room. With
    at most ``SORT_MAX`` peaks, ``vals`` (float32) and ``idx`` (int64,
    global) get the first ``len(vals)`` in :func:`_order`'s order."""
    global launches
    X, Y, Z = vol.shape
    rx, ry, rz = (int(s) for s in real_shape)
    build.launch(
        build.library().mad_peak_mask_compact, vol.device, vol.data_ptr(), X,
        Y, Z, int(row0), int(rows), int(x0), rx, ry, rz, int(border),
        float(threshold), keys.data_ptr(), len(keys), cand.data_ptr(),
        len(cand), counter.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        len(vals))
    launches += 1


def candidate_room(n_cand: int, warps: int) -> int:
    """The candidates a warp's region holds in a buffer of ``n_cand``."""
    return (n_cand - warps) // warps


def peak_topk(vol: torch.Tensor, real_shape, threshold: float, border: int,
              capacity: int, row0: int = 0, rows=None, x0: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``capacity`` LoG peaks of the own rows: (values (K,) float32,
    global flat indices (K,) int64), by descending value, ties in
    flat-index order."""
    if vol.device.type == "cpu":
        return peak_topk_plain(vol, real_shape, threshold, border, capacity,
                               row0, rows, x0)
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError(f"peak_topk: need a 3D float32 volume, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    rows = _own_rows(vol, row0, rows)
    X, Y, Z = vol.shape
    if rows * Y * Z >= 2 ** 31:
        raise ValueError("peak_topk: own rows too large for int32 indices")
    vol = vol.contiguous()
    build.require_cuda("peak_topk", vol)
    dev = vol.device
    counter = torch.empty(3, dtype=torch.int32, device=dev)
    vals = torch.empty(capacity, dtype=torch.float32, device=dev)
    idx = torch.empty(capacity, dtype=torch.int64, device=dev)
    cap, n_cand = _FIRST_CAPACITY, _FIRST_CANDIDATES
    while True:
        keys = torch.empty(cap, dtype=torch.int64, device=dev)
        cand = torch.empty(n_cand, dtype=torch.int32, device=dev)
        compact(vol, real_shape, threshold, border, row0, rows, x0, keys,
                cand, counter, vals, idx)
        n, most, warps = counter.tolist()     # sizes the output: one sync
        if warps and most > candidate_room(n_cand, warps):
            n_cand = warps * (most + 1)
        elif n > cap:
            cap = n
        else:
            break
    if n <= SORT_MAX:
        k = min(n, capacity)
        return vals[:k], idx[:k]
    return topk_from_keys(vol, keys[:n], capacity, row0, rows, x0)
