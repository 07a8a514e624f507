"""K4: LoG peak mask + compaction, then the exact top-k by response.

Replaces mad_tpu/ops/detect.py:48-52 and 165-212 (``_maxpool3``, the peak
mask of ``detect_counts`` and ``topk_flat``). The CUDA kernel
``csrc/peaks.cu`` appends every peak as (value, flat index) through one
atomic counter; :func:`peak_topk` then orders the survivors by
(-value, flat index) -- the tie order of ``lax.top_k`` -- and keeps the
first ``capacity``. :func:`peak_topk_plain` is the plain version:
``max_pool3d`` + mask + ``nonzero`` + the same ordering.

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

# First guess of the survivor buffer; a volume with more peaks is rerun
# with a buffer of the exact count the first pass measured.
_FIRST_CAPACITY = 1 << 16


def _order(vals: torch.Tensor, idx: torch.Tensor, capacity: int):
    """Sort by (-value, index) and keep the first ``capacity``."""
    idx, perm = torch.sort(idx, stable=True)
    vals = vals[perm]
    vals, perm = torch.sort(vals, descending=True, stable=True)
    idx = idx[perm]
    return vals[:capacity], idx[:capacity]


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


def peak_topk(vol: torch.Tensor, real_shape, threshold: float, border: int,
              capacity: int, row0: int = 0, rows=None, x0: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``capacity`` LoG peaks of the own rows: (values (K,) float32,
    global flat indices (K,) int64), by descending value, ties in
    flat-index order."""
    if vol.device.type == "cpu":
        return peak_topk_plain(vol, real_shape, threshold, border, capacity,
                               row0, rows, x0)
    global launches
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError(f"peak_topk: need a 3D float32 volume, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    rows = _own_rows(vol, row0, rows)
    X, Y, Z = vol.shape
    if rows * Y * Z >= 2 ** 31:
        raise ValueError("peak_topk: own rows too large for int32 indices")
    vol = vol.contiguous()
    build.require_cuda("peak_topk", vol)
    lib = build.library()
    rx, ry, rz = (int(s) for s in real_shape)
    cap = _FIRST_CAPACITY
    while True:
        vals = torch.empty(cap, dtype=torch.float32, device=vol.device)
        idx = torch.empty(cap, dtype=torch.int32, device=vol.device)
        counter = torch.zeros(1, dtype=torch.int32, device=vol.device)
        build.launch(
            lib.mad_peak_mask_compact, vol.device, vol.data_ptr(), X, Y, Z,
            int(row0), rows, int(x0), rx, ry, rz, int(border),
            float(threshold), vals.data_ptr(), idx.data_ptr(),
            counter.data_ptr(), cap)
        launches += 1
        n = int(counter.item())
        if n <= cap:
            break
        cap = n
    idx = idx[:n].long()
    if x0:
        idx += int(x0) * Y * Z
    return _order(vals[:n], idx, capacity)
