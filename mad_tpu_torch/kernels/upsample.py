"""K2: x2 Catmull-Rom upsampling of a 3D float32 volume along one axis.

Replaces mad_tpu/ops/convolve.py:184-215 (``_upsample_axis``; its banded
``_upsample_matrix`` is a TPU matrix-unit form and stays behind). Along
the axis, n samples become 2n - 1: even outputs copy the input, odd output
2i + 1 is ``((t0 + t1) + t2) + t3`` with ``t_m = w[3-m] * v[clamp(i+m-1)]``
(edges replicated). The CUDA kernel ``csrc/upsample.cu`` gives one thread
to each output voxel and rounds every product and sum in that order, so it
equals :func:`upsample_axis_plain` (the shift-add of the JAX original in
torch ops) bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0            # kernel launches since the last reset

# Catmull-Rom weights for the half-sample points of a x2 upsampling.
CR_HALF = np.array([-1.0 / 16, 9.0 / 16, 9.0 / 16, -1.0 / 16],
                   dtype=np.float32)


def upsample_axis_plain(vol: torch.Tensor, axis: int) -> torch.Tensor:
    """x2 upsample along one axis: n -> 2n-1 (original samples on even
    indices, Catmull-Rom half samples with edge replication on odd ones)."""
    n = vol.shape[axis]
    padded = torch.cat([vol.narrow(axis, 0, 1), vol,
                        vol.narrow(axis, n - 1, 1)], dim=axis)
    half = None
    for m in range(4):
        term = padded.narrow(axis, m, n - 1) * float(CR_HALF[3 - m])
        half = term if half is None else half.add_(term)
    del padded
    shape = list(vol.shape)
    shape[axis] = 2 * n - 1
    out = vol.new_empty(shape)
    idx = [slice(None)] * vol.dim()
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = vol
    idx[axis] = slice(1, None, 2)
    if half is not None:
        out[tuple(idx)] = half
    return out


def upsample_axis(vol: torch.Tensor, axis: int) -> torch.Tensor:
    """(.., n, ..) -> (.., 2n - 1, ..) along ``axis`` of a 3D volume."""
    if vol.device.type == "cpu":
        return upsample_axis_plain(vol, axis)
    global launches
    if vol.dim() != 3 or vol.dtype != torch.float32 or not 0 <= axis < 3:
        raise ValueError(f"upsample_axis: need a 3D float32 volume and an "
                         f"axis in 0-2, got {tuple(vol.shape)} {vol.dtype} "
                         f"axis {axis}")
    if vol.shape[axis] < 1:
        raise ValueError("upsample_axis: empty axis")
    vol = vol.contiguous()
    build.require_cuda("upsample_axis", vol)
    shape = list(vol.shape)
    n = shape[axis]
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    shape[axis] = 2 * n - 1
    out = torch.empty(shape, dtype=torch.float32, device=vol.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    build.launch(
        lib.mad_upsample_axis, vol.device, vol.data_ptr(), out.data_ptr(),
        outer, n, inner)
    launches += 1
    return out
