"""Plain PyTorch density simulation, cross-correlation and overlap.

A straightforward rendering of the method (mad/PDB.py:131-208,
mad/Dmap.py:73-90 and 153-258, mad/MaD.py:659-668) with no code of the
program under test: it makes the benchmark's maps, and it scores the
program's poses and models again. ``dtype`` is the type the volumes are
computed in: float32 as the method states it, bfloat16 for the control.

- :func:`simulate`: M structures onto one common lattice-registered box
  (margin 2 voxels, each axis rounded up to ``shape_bucket``): the
  mass-weighted trilinear scatter (on the CPU, in a fixed order), normalized to max 1, the Gaussian blur
  of sigma = resolution / (pi sqrt 2) / voxsp truncated at ceil(3 sigma)
  as a *full* convolution, normalized to max 1, clamped below the
  isovalue. Returns the volumes and each structure's origin (A).
- :func:`reduce_void`: crop to the nonzero bounding box, pad 10 zeros.
- :func:`ccc`: each model's correlation with the map over the model's box,
  map voxels outside the map counting as zero and model voxels there
  dropped.
- :func:`overlap`: the share of solution i's occupied voxels (density
  > 0 at 5 A / 2 A / isovalue 0.2) that solution j also occupies.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def bucket(n: int, b: int) -> int:
    return ((int(n) + b - 1) // b) * b


def blur_taps(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def conv_full(vol: torch.Tensor, taps: np.ndarray, axis: int
              ) -> torch.Tensor:
    """'full' convolution along spatial ``axis`` of (M, X, Y, Z):
    out[i] = sum_m taps[k-1-m] * padded[i + m], zero padding k-1 a side."""
    k = len(taps)
    dim = axis + 1
    n = vol.shape[dim]
    shape = list(vol.shape)
    shape[dim] = n + 2 * (k - 1)
    padded = vol.new_zeros(shape)
    padded.narrow(dim, k - 1, n).copy_(vol)
    out = None
    for m in range(k):
        term = padded.narrow(dim, m, n + k - 1) * float(taps[k - 1 - m])
        out = term if out is None else out + term
    return out


def _plan(coords: np.ndarray, voxsp: float, shape_bucket: int):
    mins = voxsp * np.floor(coords.min(axis=1) / voxsp)          # (M, 3)
    maxs = voxsp * np.ceil(coords.max(axis=1) / voxsp)
    margin = 2
    dims = np.ceil((maxs - mins) / voxsp).astype(int) + 2 * margin + 1
    box = tuple(bucket(int(d), shape_bucket) for d in dims.max(axis=0))
    return mins, box, margin


def simulate(coords: np.ndarray, masses: np.ndarray, resolution: float,
             voxsp: float, device, isovalue: float = 0.0,
             shape_bucket: int = 16, dtype=torch.float32):
    """coords (M, N, 3), masses (M, N) -> (volumes (M, X, Y, Z), origins
    (M, 3) float64)."""
    coords = np.asarray(coords, dtype=np.float64)
    M, N = coords.shape[:2]
    mins, box, margin = _plan(coords, voxsp, shape_bucket)
    # the scatter runs on the CPU: its sums then fall in one fixed order
    # (structure, corner, atom), whatever the device
    f32 = dict(dtype=torch.float32, device="cpu")
    c = torch.as_tensor(coords, **f32)
    w_m = torch.as_tensor(np.array(np.broadcast_to(masses, (M, N))), **f32)
    vmin = torch.as_tensor(mins, **f32)
    g = margin + (c - vmin[:, None, :]) / torch.tensor(voxsp, **f32)
    g0 = torch.floor(g)
    w1 = g - g0
    w0 = 1.0 - w1
    i0 = g0.to(torch.int64)
    dims = torch.as_tensor(box)
    sid = torch.arange(M)[:, None].expand(M, N)
    grids = torch.zeros(M * box[0] * box[1] * box[2], **f32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (w_m * (w1[..., 0] if dx else w0[..., 0])
                     * (w1[..., 1] if dy else w0[..., 1])
                     * (w1[..., 2] if dz else w0[..., 2]))
                idx = i0 + torch.as_tensor([dx, dy, dz])
                keep = ((idx >= 0) & (idx < dims)).all(dim=-1)
                flat = ((sid * box[0] + idx[..., 0]) * box[1]
                        + idx[..., 1]) * box[2] + idx[..., 2]
                grids.index_add_(0, flat[keep], w[keep])
    grids = grids.to(device)
    grids = grids.reshape((M,) + box).to(dtype)
    sigma = resolution / (math.pi * math.sqrt(2.0)) / voxsp
    radius = int(math.ceil(3.0 * sigma))
    taps = blur_taps(sigma, radius)
    grids = grids / torch.clamp(grids.amax(dim=(1, 2, 3), keepdim=True),
                                min=1e-30)
    for axis in range(3):
        grids = conv_full(grids, taps, axis)
    dens = grids / torch.clamp(grids.amax(dim=(1, 2, 3), keepdim=True),
                               min=1e-30)
    if isovalue:
        dens = torch.where(dens < isovalue, torch.zeros_like(dens), dens)
    return dens, mins - (radius + margin) * voxsp


def reduce_void(vol: torch.Tensor, origin: np.ndarray, voxsp: float,
                pad: int = 10):
    """Crop to the nonzero bounding box, then ``pad`` zeros a side."""
    occ = vol != 0
    flags = [occ.any(dim=2).any(dim=1), occ.any(dim=2).any(dim=0),
             occ.any(dim=1).any(dim=0)]
    lo, hi = [], []
    for f in flags:
        nz = torch.nonzero(f).reshape(-1).cpu().numpy()
        lo.append(int(nz[0]))
        hi.append(int(nz[-1]) + 1)
    crop = vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    out = torch.nn.functional.pad(crop, (pad,) * 6)
    return out.contiguous(), np.asarray(origin) + (np.asarray(lo) - pad) * voxsp


def ccc(map_vol: torch.Tensor, map_origin, voxsp: float,
        models: torch.Tensor, origins: np.ndarray) -> np.ndarray:
    """(M,) correlation of each model volume with the map over the
    model's box (float64 sums of the volumes' own type)."""
    starts = np.rint((np.asarray(origins) - np.asarray(map_origin))
                     / voxsp).astype(np.int64)
    shape = np.asarray(map_vol.shape)
    box = np.asarray(models.shape[1:])
    out = np.zeros(len(models))
    for m, s in enumerate(starts):
        lo = np.maximum(s, 0)
        hi = np.minimum(s + box, shape)
        if np.any(hi <= lo):
            continue
        a = map_vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        b = models[m, lo[0] - s[0]:hi[0] - s[0], lo[1] - s[1]:hi[1] - s[1],
                   lo[2] - s[2]:hi[2] - s[2]]
        if a.dtype == torch.float32:
            a, b = a.double(), b.double()
        olap = float((a * b).sum())
        n1 = float((a * a).sum())
        n2 = float((b * b).sum())
        out[m] = olap / max(math.sqrt(n1 * n2), 1e-30)
    return out


def occupancy_counts(coords: np.ndarray, masses: np.ndarray, device,
                     resolution: float = 5.0, voxsp: float = 2.0,
                     isovalue: float = 0.2, dtype=torch.float32
                     ) -> np.ndarray:
    """(n, n) voxel counts of the structures' occupancies (density > 0 at
    ``isovalue``) and of each pair's intersection, in a common frame."""
    dens, origins = simulate(coords, masses, resolution, voxsp, device,
                             isovalue=isovalue, dtype=dtype)
    n = dens.shape[0]
    off = np.rint((origins - origins.min(axis=0)) / voxsp).astype(np.int64)
    box = np.asarray(dens.shape[1:])
    frame = tuple(int(v) for v in (off.max(axis=0) + box))
    occ = torch.zeros((n,) + frame, dtype=torch.float32, device=device)
    for i, (ox, oy, oz) in enumerate(off.tolist()):
        occ[i, ox:ox + box[0], oy:oy + box[1], oz:oz + box[2]] = (
            dens[i] > 0).to(torch.float32)
    flat = occ.reshape(n, -1)
    # integer counts below 2^24: exact in float32 sums (TF32 off)
    return (flat @ flat.T).double().cpu().numpy()
