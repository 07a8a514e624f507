"""K9: mass-weighted trilinear scatter of a batch of structures, and the
simulation body's closing scale-and-clamp pass.

Replaces the scatter of mad_tpu/ops/simulate.py:78-110 and :115-149 (the
``.at[].add(mode="drop")`` over the 8 cell corners, one scatter a corner).
A voxel's value is the float32 sum, from 0, of its contributions in
(corner, atom) order: the corners in mad_tpu's ``dx, dy, dz`` loop order,
within a corner the atoms in index order.

:func:`scatter_atoms_plain` is the plain PyTorch version: one
``index_add_`` on the flattened grids a corner, over the atoms in order
(``index_put_(accumulate=True)`` does not keep the order of duplicates on
the CPU at every size). The CUDA kernel ``csrc/scatter.cu`` bins the atoms
by voxel tile with integer counts, sorts each tile's candidates by (cell,
atom) and sums each voxel's contributions in the same order, so the two
agree bit for bit and the kernel gives the same grid in every run. It can
merge each structure's max into order keys (:mod:`.maxkey`) as it writes.

Both compute g = margin + (c - vox_min) / voxsp with a true division (the
plain version divides by a tensor: PyTorch turns a division by a Python
float on the card into a product with its reciprocal) and the weights as
((m * wx) * wy) * wz.

:func:`scale_clamp` is the body's last step on the blurred batch, in
place: each structure divided by max(its max, 1e-30), then values below
the isovalue set to 0 (mad_tpu/ops/simulate.py:104-107);
:func:`scale_clamp_plain` is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build, maxkey

launches = 0            # kernel launches since the last reset
scale_launches = 0      # scale-and-clamp launches since the last reset

SCAN_CHUNK = 4096       # counts a block of the kernel's scan takes
TILE = (8, 8, 32)       # a voxel tile (csrc/scatter.cu kTX, kTY, kTZ)
TILE_CAP = 1024         # candidates a tile sorts in shared memory (kCap)
POOL_PER_ATOM = 16      # keys of the crowded tiles' pool, per atom
# bytes an element of each scratch part takes
_ITEM_BYTES = dict(counts=4, sums=4, bin_of=4, slot=4, ids=4, cell_of=8,
                   ent_cell=8, atom_w=4, pool=8, pool_used=8)


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


def scratch_sizes(M: int, N: int, box) -> dict:
    """The kernel's scratch for M structures of N atoms in ``box``, in
    elements: one count a bin (a voxel tile's cells) and one past the
    end, the scan's chunk sums, per atom its bin, slot, index, packed cell
    (int64; again in bin order) and (m, w1) (4 float32), the crowded
    tiles' pool of keys (int64) and its counter."""
    bins = M
    for dim, tile in zip(box, TILE):
        bins *= -(-int(dim) // tile) + 1
    atoms = M * N
    return dict(counts=bins + 1, sums=-(-(bins + 1) // SCAN_CHUNK),
                bin_of=atoms, slot=atoms, ids=atoms, cell_of=atoms,
                ent_cell=atoms,
                atom_w=4 * atoms, pool=POOL_PER_ATOM * atoms + 1,
                pool_used=1)


def scatter_atoms(coords: torch.Tensor, masses: torch.Tensor,
                  vox_min: torch.Tensor, box, margin: int, voxsp: float,
                  max_into: torch.Tensor = None) -> torch.Tensor:
    """Scatter M structures of N atoms each onto (M, X, Y, Z) float32 grids.

    coords (M, N, 3), masses (M, N), vox_min (M, 3) float32 on one device;
    corner weights land at floor(g) + {0, 1} per axis, corners outside
    ``box`` are dropped. ``max_into``: (M,) int32 max keys
    (:mod:`.maxkey`) into which each structure's max merges."""
    if coords.device.type == "cpu":
        grids = scatter_atoms_plain(coords, masses, vox_min, box, margin,
                                    voxsp)
        if max_into is not None:
            maxkey.merge_(max_into, grids)
        return grids
    global launches
    args = [t.to(torch.float32).contiguous()
            for t in (coords, masses, vox_min)]
    build.require_cuda("scatter_atoms", *args)
    coords, masses, vox_min = args
    _check(coords, masses, vox_min, box)
    M, N = masses.shape
    X, Y, Z = (int(b) for b in box)
    dev = coords.device
    if max_into is None:
        keys = maxkey.new_keys(M, dev)
    else:
        keys = max_into
        build.require_cuda("scatter_atoms", coords, keys)
        if keys.shape != (M,) or keys.dtype != torch.int32:
            raise ValueError(f"scatter_atoms: max keys {tuple(keys.shape)} "
                             f"{keys.dtype}, need ({M},) int32")
    grids = torch.empty((M, X, Y, Z), dtype=torch.float32, device=dev)
    if grids.numel() == 0:
        return grids
    sizes = scratch_sizes(M, N, box)
    # the pool's (uint64) counter and the counts zeroed in one buffer
    zeroed = torch.zeros(sizes["counts"] + 2, dtype=torch.int32, device=dev)
    pool_used, counts = zeroed[:2], zeroed[2:]
    # the rest in one buffer, each part 16-byte aligned
    at, off = 0, {}
    for k in ("atom_w", "cell_of", "ent_cell", "pool", "sums", "bin_of",
              "slot", "ids"):
        off[k] = at
        at += -(-sizes[k] * _ITEM_BYTES[k] // 16) * 16
    rest = torch.empty(at // 8, dtype=torch.int64, device=dev)
    ptr = {k: rest.data_ptr() + o for k, o in off.items()}
    build.launch(
        build.library().mad_scatter_atoms, dev, coords.data_ptr(),
        masses.data_ptr(), vox_min.data_ptr(), M, N, X, Y, Z, float(margin),
        float(voxsp), counts.data_ptr(), ptr["sums"], ptr["bin_of"],
        ptr["slot"], ptr["ids"], ptr["cell_of"], ptr["ent_cell"],
        ptr["atom_w"], ptr["pool"], sizes["pool"], pool_used.data_ptr(),
        grids.data_ptr(), keys.data_ptr())
    launches += 1
    return grids


def scale_clamp_plain(dens: torch.Tensor, max_keys: torch.Tensor,
                      isovalue: float) -> torch.Tensor:
    """dens / max(m_s, 1e-30), then where(< isovalue, 0): the torch ops of
    the body's last step (a new tensor)."""
    shape = (-1,) + (1,) * (dens.dim() - 1)
    dens = dens / maxkey.divisors(max_keys).view(shape)
    if isovalue:
        dens = torch.where(dens < isovalue, torch.zeros_like(dens), dens)
    return dens


def scale_clamp(dens: torch.Tensor, max_keys: torch.Tensor,
                isovalue: float) -> torch.Tensor:
    """In place on a CUDA batch (M, ...) float32: each structure divided by
    max(its max, 1e-30) (max_keys: (M,) int32 order keys), then values
    below ``isovalue`` (when set) made +0. On a CPU tensor: the plain
    version's new tensor."""
    if dens.device.type == "cpu":
        return scale_clamp_plain(dens, max_keys, isovalue)
    global scale_launches
    build.require_cuda("scale_clamp", dens, max_keys)
    M = dens.shape[0]
    if dens.dtype != torch.float32 or max_keys.shape != (M,) \
            or max_keys.dtype != torch.int32:
        raise ValueError(f"scale_clamp: {tuple(dens.shape)} {dens.dtype} "
                         f"with keys {tuple(max_keys.shape)} "
                         f"{max_keys.dtype}")
    if dens.numel() == 0:
        return dens
    # the comparison of torch.where(dens < isovalue) takes the float32 of
    # the Python float
    iso = float(np.float32(isovalue)) if isovalue else 0.0
    build.launch(
        build.library().mad_simulate_scale, dens.device, dens.data_ptr(), M,
        dens.numel() // M, max_keys.data_ptr(), iso, int(bool(isovalue)))
    scale_launches += 1
    return dens
