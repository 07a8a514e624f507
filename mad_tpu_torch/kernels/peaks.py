"""K4: LoG peak mask + compaction, then the exact top-k by response.

Replaces mad_tpu/ops/detect.py:48-52 and 165-212 (``_maxpool3``, the peak
mask of ``detect_counts`` and ``topk_flat``). The CUDA kernel
``csrc/peaks.cu`` appends every peak as (value, flat index) through one
atomic counter; :func:`peak_topk` then orders the survivors by
(-value, flat index) -- the tie order of ``lax.top_k`` -- and keeps the
first ``capacity``. :func:`peak_topk_plain` is the plain version:
``max_pool3d`` + mask + ``nonzero`` + the same ordering.
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


def _interior(shape, real_shape, border: int, device) -> torch.Tensor:
    m = []
    for a in range(3):
        r = torch.arange(shape[a], device=device)
        m.append((r >= border) & (r < real_shape[a] - border))
    return m[0][:, None, None] & m[1][None, :, None] & m[2][None, None, :]


def peak_topk_plain(vol: torch.Tensor, real_shape, threshold: float,
                    border: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    pooled = F.max_pool3d(vol[None, None], 3, stride=1, padding=1)[0, 0]
    is_peak = ((vol >= pooled) & (vol > threshold)
               & _interior(vol.shape, real_shape, border, vol.device))
    idx = torch.nonzero(is_peak.reshape(-1)).reshape(-1)
    return _order(vol.reshape(-1)[idx], idx, capacity)


def peak_topk(vol: torch.Tensor, real_shape, threshold: float, border: int,
              capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``capacity`` LoG peaks: (values (K,) float32, flat indices (K,)
    int64), by descending value, ties in flat-index order."""
    if vol.device.type == "cpu":
        return peak_topk_plain(vol, real_shape, threshold, border, capacity)
    global launches
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError(f"peak_topk: need a 3D float32 volume, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    if vol.numel() >= 2 ** 31:
        raise ValueError("peak_topk: volume too large for int32 indices")
    vol = vol.contiguous()
    build.require_cuda("peak_topk", vol)
    lib = build.library()
    X, Y, Z = vol.shape
    rx, ry, rz = (int(s) for s in real_shape)
    cap = _FIRST_CAPACITY
    while True:
        vals = torch.empty(cap, dtype=torch.float32, device=vol.device)
        idx = torch.empty(cap, dtype=torch.int32, device=vol.device)
        counter = torch.zeros(1, dtype=torch.int32, device=vol.device)
        code = lib.mad_peak_mask_compact(
            vol.data_ptr(), X, Y, Z, rx, ry, rz, int(border),
            float(threshold), vals.data_ptr(), idx.data_ptr(),
            counter.data_ptr(), cap, build.stream_ptr(vol.device))
        build.check(code, "mad_peak_mask_compact")
        launches += 1
        n = int(counter.item())
        if n <= cap:
            break
        cap = n
    return _order(vals[:n], idx[:n].long(), capacity)
