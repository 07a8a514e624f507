"""K17: the CCC of each model grid against the map over the model's box.

Replaces mad_tpu/engine/score.py:31-59 (``_compiled_batched_ccc``). For
model m with box corner ``starts[m]`` (a voxel of the map, possibly
outside it), over the voxels of its box that lie inside the map:
olap = sum(map * model), n1 = sum(map^2), n2 = sum(model^2), and
ccc = olap / max(sqrt(n1 * n2), 1e-30). Voxels outside the map add
nothing: mad_tpu zero-pads the map (nothing to olap and n1) and masks the
model to the real map (nothing to n2).

The CUDA kernel ``csrc/ccc.cu`` reads the unpadded map with bounds checks
and sums in float64 over a (model, block of rows) grid, then reduces the
blocks' partial sums in a fixed order (its note says how);
:func:`batched_ccc_plain` is the plain PyTorch version, the float32 loop
over the models on a zero-padded copy of the map.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import build

launches = 0            # kernel launches since the last reset

THREADS = 256
BLOCKS = 1024           # blocks over all models, at most (two waves' worth)


def batched_ccc_plain(data: torch.Tensor, models: torch.Tensor,
                      starts: torch.Tensor) -> torch.Tensor:
    M = models.shape[0]
    out = torch.empty(M, dtype=torch.float32, device=models.device)
    if M == 0:
        return out
    model_shape = tuple(models.shape[1:])
    shape = np.asarray(data.shape)
    st = starts.cpu().numpy().astype(np.int64)
    pad_lo = np.maximum(0, -st.min(axis=0))
    pad_hi = np.maximum(0, (st + model_shape).max(axis=0) - shape)
    map_pad = F.pad(data, (int(pad_lo[2]), int(pad_hi[2]), int(pad_lo[1]),
                           int(pad_hi[1]), int(pad_lo[0]), int(pad_hi[0])))
    in_lo, in_hi = pad_lo, pad_lo + shape
    for i, s in enumerate(st + pad_lo):
        sub = map_pad[s[0]:s[0] + model_shape[0], s[1]:s[1] + model_shape[1],
                      s[2]:s[2] + model_shape[2]]
        inb = None
        for a in range(3):
            r = torch.arange(model_shape[a], device=sub.device) + int(s[a])
            m = (r >= int(in_lo[a])) & (r < int(in_hi[a]))
            m = m.reshape([-1 if b == a else 1 for b in range(3)])
            inb = m if inb is None else inb & m
        model = models[i] * inb
        olap = (sub * model).sum()
        n1 = (sub * sub).sum()
        n2 = (model * model).sum()
        out[i] = olap / torch.clamp(torch.sqrt(n1 * n2), min=1e-30)
    return out


def blocks_per_model(M: int, rows: int) -> int:
    """Blocks of one model's (x, y) rows: about four rows a warp, and at
    most BLOCKS blocks over all models."""
    warps = THREADS // 32
    return max(1, min(-(-rows // (4 * warps)), BLOCKS // max(M, 1)))


def batched_ccc(data: torch.Tensor, models: torch.Tensor,
                starts: torch.Tensor) -> torch.Tensor:
    """(M,) float32 CCC of each model grid against the map.

    data (X, Y, Z) float32 map; models (M, bx, by, bz) float32 grids;
    starts (M, 3) integer map voxel of each box's (0, 0, 0) corner."""
    if data.device.type == "cpu":
        return batched_ccc_plain(data, models, starts)
    global launches
    if (data.dim() != 3 or models.dim() != 4 or starts.dim() != 2
            or starts.shape != (models.shape[0], 3)):
        raise ValueError(f"batched_ccc: bad shapes {tuple(data.shape)}, "
                         f"{tuple(models.shape)}, {tuple(starts.shape)}")
    if data.dtype != torch.float32 or models.dtype != torch.float32:
        raise ValueError(f"batched_ccc: float32 map and models, got "
                         f"{data.dtype}, {models.dtype}")
    data, models = data.contiguous(), models.contiguous()
    starts = starts.to(torch.int32).contiguous()
    build.require_cuda("batched_ccc", data, models, starts)
    M, bx, by, bz = models.shape
    dev = data.device
    out = torch.empty(M, dtype=torch.float32, device=dev)
    if M == 0:
        return out
    nblk = blocks_per_model(M, bx * by)
    partial = torch.empty((M, nblk, 3), dtype=torch.float64, device=dev)
    build.launch(
        build.library().mad_batched_ccc, dev, data.data_ptr(), *data.shape,
        models.data_ptr(), M, bx, by, bz, starts.data_ptr(), nblk,
        partial.data_ptr(), out.data_ptr())
    launches += 1
    return out
