"""K22: per-axis occupancy flags, and K23: crop and zero re-pad.

K22 replaces mad_tpu/core/grid.py:31-42 (``_compiled_axis_any``): the
flags ``any(v != 0)`` of each x-, y- and z-plane of a float32 volume
(a NaN counts, a -0.0 does not), as one uint8 vector of X + Y + Z flags
so the host pulls them in one copy. K23 replaces mad_tpu/core/grid.py:45-57
(``_compiled_crop_pad``) and mad_tpu/ops/scalespace.py:68-80
(``_compiled_prepare_pad``, without its bucket padding): a box of the
volume copied into a zero volume ``pad`` voxels larger on every side.

The CUDA kernels are in ``csrc/crop_pad.cu`` (K22: a memset and one launch
that streams the volume in 16-byte loads, each block over a contiguous
span, the flags gathered in shared memory; K23: one launch writing every
output voxel once, four a thread with a 16-byte store). :func:`axis_flags_plain`
and :func:`crop_pad_plain` are the plain PyTorch versions (``torch.any``
reductions; a slice and ``F.pad``). Both kernels move the values as bits,
so they equal their plain versions bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

launches = 0            # K22 launches since the last reset
pad_launches = 0        # K23 launches since the last reset


def axis_flags_plain(vol: torch.Tensor) -> torch.Tensor:
    occ = vol != 0
    return torch.cat([occ.any(dim=2).any(dim=1), occ.any(dim=2).any(dim=0),
                      occ.any(dim=1).any(dim=0)]).to(torch.uint8)


def axis_flags(vol: torch.Tensor) -> torch.Tensor:
    """uint8 (X + Y + Z,): 1 where the x-plane, then the y-plane, then the
    z-plane at that index holds a nonzero voxel of the float32 (X, Y, Z)
    volume ``vol``."""
    if vol.device.type == "cpu":
        return axis_flags_plain(vol)
    global launches
    _check("axis_flags", vol)
    X, Y, Z = vol.shape
    flags = torch.empty(X + Y + Z, dtype=torch.uint8, device=vol.device)
    build.launch(build.library().mad_axis_flags, vol.device, vol.data_ptr(),
                 X, Y, Z, flags.data_ptr())
    launches += 1
    return flags


def crop_pad_plain(vol: torch.Tensor, lo, box, pad: int) -> torch.Tensor:
    (lx, ly, lz), (bx, by, bz) = lo, box
    return F.pad(vol[lx:lx + bx, ly:ly + by, lz:lz + bz], (pad,) * 6)


def crop_pad(vol: torch.Tensor, lo, box, pad: int) -> torch.Tensor:
    """The box ``vol[lo : lo + box]`` of the float32 (X, Y, Z) volume
    ``vol`` inside ``pad`` zero voxels on every side: a new (box + 2 pad)
    volume."""
    if vol.device.type == "cpu":
        return crop_pad_plain(vol, lo, box, pad)
    global pad_launches
    _check("crop_pad", vol)
    lo, box, pad = [int(v) for v in lo], [int(v) for v in box], int(pad)
    if pad < 0 or any(l < 0 or b < 0 or l + b > s
                      for l, b, s in zip(lo, box, vol.shape)):
        raise ValueError(f"crop_pad: box {box} at {lo} (pad {pad}) is not "
                         f"inside {tuple(vol.shape)}")
    out = torch.empty([b + 2 * pad for b in box], dtype=torch.float32,
                      device=vol.device)
    build.launch(build.library().mad_crop_pad, vol.device, vol.data_ptr(),
                 *vol.shape, *lo, *box, pad, out.data_ptr())
    pad_launches += 1
    return out


def _check(name: str, vol: torch.Tensor) -> None:
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError(f"{name}: a float32 (X, Y, Z) volume, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    build.require_cuda(name, vol)
