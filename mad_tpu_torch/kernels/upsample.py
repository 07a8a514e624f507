"""K2: x2 Catmull-Rom upsampling of a 3D float32 volume,
(X, Y, Z) -> (2X - 1, 2Y - 1, 2Z - 1).

Replaces mad_tpu/ops/convolve.py:184-215 (``upsample2`` and its
``_upsample_axis``; the banded ``_upsample_matrix`` is a TPU matrix-unit
form and stays behind). Along each axis in turn, n samples become 2n - 1:
even outputs copy the input, odd output 2i + 1 is ``((t0 + t1) + t2) + t3``
with ``t_m = w[3-m] * v[clamp(i+m-1)]`` (edges replicated). The CUDA kernel
``csrc/upsample.cu`` does all three axes in one launch: a block copies a
tile of ``TILE`` input cells with the taps' halo into shared memory and
runs the x, y and z passes there, rounding every product and sum in the
per-axis order, so it equals :func:`upsample2_plain` (the three passes of
the JAX original's shift-add in torch ops) bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0            # kernel launches since the last reset

# Catmull-Rom weights for the half-sample points of a x2 upsampling.
CR_HALF = np.array([-1.0 / 16, 9.0 / 16, 9.0 / 16, -1.0 / 16],
                   dtype=np.float32)
# A block's input cells along x, y, z, as csrc/upsample.cu declares them
# (kTX, kTY, kTZ); its tile holds one more cell before and two after along
# each axis.
_C = build.constants("upsample.cu")
TILE = (_C["kTX"], _C["kTY"], _C["kTZ"])
# The kernel takes 64-bit offsets once the output reaches this many
# elements (it clamps it to 2^32); a test lowers it to run that path on a
# small volume.
WIDE_FROM = 1 << 32


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


def upsample2_plain(vol: torch.Tensor) -> torch.Tensor:
    """Separable x2 upsampling: :func:`upsample_axis_plain` along x, y,
    then z."""
    for axis in range(3):
        vol = upsample_axis_plain(vol, axis)
    return vol


def upsample2(vol: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) -> (2X - 1, 2Y - 1, 2Z - 1) of a 3D float32 volume."""
    if vol.device.type == "cpu":
        return upsample2_plain(vol)
    global launches
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError(f"upsample2: need a 3D float32 volume, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    if min(vol.shape) < 1:
        raise ValueError(f"upsample2: empty axis in {tuple(vol.shape)}")
    vol = vol.contiguous()
    build.require_cuda("upsample2", vol)
    X, Y, Z = vol.shape
    out = torch.empty((2 * X - 1, 2 * Y - 1, 2 * Z - 1), dtype=torch.float32,
                      device=vol.device)
    lib = build.library()
    build.launch(lib.mad_upsample2, vol.device, vol.data_ptr(),
                 out.data_ptr(), X, Y, Z, WIDE_FROM)
    launches += 1
    return out
