"""K9: mass-weighted trilinear scatter of a batch of structures.

Replaces the scatter of mad_tpu/ops/simulate.py:78-110 and :115-149 (the
``.at[].add(mode="drop")`` over the 8 cell corners). The CUDA kernel
``csrc/scatter.cu`` takes one thread per (structure, atom) and scatters
the whole batch in one launch with ``atomicAdd``;
:func:`scatter_atoms_plain` is the plain PyTorch version: per structure,
one ``index_put_(accumulate=True)`` per corner.

Both compute g = margin + (c - vox_min) / voxsp with a true division (the
plain version divides by a tensor: PyTorch turns a division by a Python
float on the card into a product with its reciprocal) and the weights as
((m * wx) * wy) * wz, so they differ only in the order of the f32 adds.
"""

from __future__ import annotations

import torch

from . import build

launches = 0            # kernel launches since the last reset


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
    grids = torch.zeros((coords.shape[0],) + box, dtype=torch.float32,
                        device=dev)
    g = margin + (coords - vox_min[:, None, :]) / torch.tensor(
        voxsp, dtype=torch.float32, device=dev)
    g0 = torch.floor(g)
    w1 = g - g0
    w0 = 1.0 - w1
    i0 = g0.to(torch.int64)
    dims = torch.as_tensor(box, device=dev)
    for s in range(coords.shape[0]):
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = (masses[s]
                         * (w1[s, :, 0] if dx else w0[s, :, 0])
                         * (w1[s, :, 1] if dy else w0[s, :, 1])
                         * (w1[s, :, 2] if dz else w0[s, :, 2]))
                    idx = i0[s] + torch.as_tensor([dx, dy, dz], device=dev)
                    keep = ((idx >= 0) & (idx < dims)).all(dim=1)
                    idx, w = idx[keep], w[keep]
                    grids[s].index_put_((idx[:, 0], idx[:, 1], idx[:, 2]),
                                        w, accumulate=True)
    return grids


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
    grids = torch.zeros((M, X, Y, Z), dtype=torch.float32,
                        device=coords.device)
    if M * N == 0:
        return grids
    lib = build.library()
    build.launch(
        lib.mad_scatter_atoms, coords.device, coords.data_ptr(),
        masses.data_ptr(), vox_min.data_ptr(), M, N, X, Y, Z, float(margin),
        float(voxsp), grids.data_ptr())
    launches += 1
    return grids
