"""K11: occupancy field of the map anchors, dilated by a voxel sphere.

Replaces mad_tpu/engine/match.py:94-117 (``_field_body``). The CUDA kernel
``csrc/field.cu`` clears the int8 field and gives one thread to each
(anchor, offset of the sphere's bounding cube): an offset inside the
sphere whose voxel lies in the grid writes 1 there. Every writer writes
the same byte, so the result is exact with no atomics.
:func:`anchor_field_plain` is the plain PyTorch version: all spheres'
voxels built as one index list and set by ``index_put_``.

The JAX body ORs shifted copies of the anchor occupancy over the sphere's
offsets; the offset set is symmetric, so that is the same field as the
union of the spheres around the anchors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0            # kernel launches since the last reset


def sphere_offsets(r: int) -> np.ndarray:
    """(n, 3) integer offsets of the voxel sphere of radius r, in the
    order of mad_tpu's ``_field_body``."""
    g = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1]
    return np.argwhere(np.sum(g * g, axis=0) <= r * r) - r


def anchor_field_plain(shape, lo_vox: torch.Tensor, radius_vox: int
                       ) -> torch.Tensor:
    offs = torch.as_tensor(sphere_offsets(radius_vox), device=lo_vox.device)
    pts = (lo_vox.long()[:, None, :] + offs[None]).reshape(-1, 3)
    dims = torch.as_tensor(shape, device=lo_vox.device)
    pts = pts[((pts >= 0) & (pts < dims)).all(dim=1)]
    field = torch.zeros(tuple(shape), dtype=torch.int8, device=lo_vox.device)
    field[pts[:, 0], pts[:, 1], pts[:, 2]] = 1
    return field


def anchor_field(shape, lo_vox: torch.Tensor, radius_vox: int
                 ) -> torch.Tensor:
    """int8 (X, Y, Z) field: 1 at every voxel within ``radius_vox`` voxels
    (Euclidean, in voxel units) of an anchor voxel, else 0.

    lo_vox (A, 3) integer voxel indices of the map anchors (clipped to the
    grid by the caller)."""
    if lo_vox.device.type == "cpu":
        return anchor_field_plain(shape, lo_vox, radius_vox)
    global launches
    lo_vox = lo_vox.to(torch.int32).contiguous()
    build.require_cuda("anchor_field", lo_vox)
    X, Y, Z = (int(s) for s in shape)
    if lo_vox.dim() != 2 or lo_vox.shape[1] != 3 or radius_vox < 0:
        raise ValueError("anchor_field: lo_vox must be (A, 3), radius >= 0")
    field = torch.empty((X, Y, Z), dtype=torch.int8, device=lo_vox.device)
    lib = build.library()
    build.launch(
        lib.mad_anchor_field, lo_vox.device, lo_vox.data_ptr(),
        lo_vox.shape[0], X, Y, Z, int(radius_vox), field.data_ptr())
    launches += 1
    return field
