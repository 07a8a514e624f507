"""K9: mass-weighted trilinear scatter of a batch of structures.

Replaces the scatter of mad_tpu/ops/simulate.py:78-110 and :115-149 (the
``.at[].add(mode="drop")`` over the 8 cell corners, one scatter a corner).
A voxel's value is the float32 sum, from 0, of its contributions in
(corner, atom) order: the corners in mad_tpu's ``dx, dy, dz`` loop order,
within a corner the atoms in index order.

:func:`scatter_atoms_plain` is the plain PyTorch version: one
``index_add_`` on the flattened grids a corner, over the atoms in order
(``index_put_(accumulate=True)`` does not keep the order of duplicates on
the CPU at every size). The CUDA kernel ``csrc/scatter.cu`` buckets the
atoms by floor cell with integer counts and gathers each voxel's
contributions in the same order, so the two agree bit for bit and the
kernel gives the same grid in every run.

Both compute g = margin + (c - vox_min) / voxsp with a true division (the
plain version divides by a tensor: PyTorch turns a division by a Python
float on the card into a product with its reciprocal) and the weights as
((m * wx) * wy) * wz.
"""

from __future__ import annotations

import torch

from . import build

launches = 0            # kernel launches since the last reset

SCAN_CHUNK = 4096       # counts a block of the kernel's scan takes


def _check(coords, masses, vox_min, box):
    M, N = masses.shape
    if coords.shape != (M, N, 3) or vox_min.shape != (M, 3) or len(box) != 3:
        raise ValueError(f"scatter_atoms: bad shapes {tuple(coords.shape)}, "
                         f"{tuple(masses.shape)}, {tuple(vox_min.shape)}, "
                         f"{box}")


def scatter_atoms_plain(coords: torch.Tensor, masses: torch.Tensor,
                        vox_min: torch.Tensor, box, margin: int,
                        voxsp: float) -> torch.Tensor:
    _check(coords, masses, vox_min, box)
    box = tuple(int(b) for b in box)
    dev = coords.device
    M, N = masses.shape
    grids = torch.zeros(M * box[0] * box[1] * box[2], dtype=torch.float32,
                        device=dev)
    g = margin + (coords - vox_min[:, None, :]) / torch.tensor(
        voxsp, dtype=torch.float32, device=dev)
    g0 = torch.floor(g)
    w1 = g - g0
    w0 = 1.0 - w1
    i0 = g0.to(torch.int64)
    dims = torch.as_tensor(box, device=dev)
    sid = torch.arange(M, device=dev)[:, None].expand(M, N)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (masses
                     * (w1[..., 0] if dx else w0[..., 0])
                     * (w1[..., 1] if dy else w0[..., 1])
                     * (w1[..., 2] if dz else w0[..., 2]))
                idx = i0 + torch.as_tensor([dx, dy, dz], device=dev)
                keep = ((idx >= 0) & (idx < dims)).all(dim=-1)
                flat = ((sid * box[0] + idx[..., 0]) * box[1]
                        + idx[..., 1]) * box[2] + idx[..., 2]
                # structure-major, atoms in index order within a structure
                grids.index_add_(0, flat[keep], w[keep])
    return grids.reshape((M,) + box)


def scatter_atoms(coords: torch.Tensor, masses: torch.Tensor,
                  vox_min: torch.Tensor, box, margin: int,
                  voxsp: float) -> torch.Tensor:
    """Scatter M structures of N atoms each onto (M, X, Y, Z) float32 grids.

    coords (M, N, 3), masses (M, N), vox_min (M, 3) float32 on one device;
    corner weights land at floor(g) + {0, 1} per axis, corners outside
    ``box`` are dropped."""
    if coords.device.type == "cpu":
        return scatter_atoms_plain(coords, masses, vox_min, box, margin,
                                   voxsp)
    global launches
    args = [t.to(torch.float32).contiguous()
            for t in (coords, masses, vox_min)]
    build.require_cuda("scatter_atoms", *args)
    coords, masses, vox_min = args
    _check(coords, masses, vox_min, box)
    M, N = masses.shape
    X, Y, Z = (int(b) for b in box)
    dev = coords.device
    grids = torch.empty((M, X, Y, Z), dtype=torch.float32, device=dev)
    if grids.numel() == 0:
        return grids
    # scratch: a count (then a start) per (structure, floor cell) bucket
    # and one past the end, the scan's chunk sums, each atom's bucket and
    # slot, the buckets' atom indices
    n = M * (X + 1) * (Y + 1) * (Z + 1) + 1
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    sums = torch.empty(-(-n // SCAN_CHUNK), dtype=torch.int32, device=dev)
    cell_of = torch.empty(M * N, dtype=torch.int64, device=dev)
    slot = torch.empty(M * N, dtype=torch.int32, device=dev)
    ids = torch.empty(M * N, dtype=torch.int32, device=dev)
    build.launch(
        build.library().mad_scatter_atoms, dev, coords.data_ptr(),
        masses.data_ptr(), vox_min.data_ptr(), M, N, X, Y, Z, float(margin),
        float(voxsp), counts.data_ptr(), sums.data_ptr(), cell_of.data_ptr(),
        slot.data_ptr(), ids.data_ptr(), grids.data_ptr())
    launches += 1
    return grids
