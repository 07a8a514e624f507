"""K5: Newton subvoxel localization of LoG peaks, with saddle rejection.

Replaces mad_tpu/ops/detect.py:125-163 (``localize``, with
``_hessian_grad`` :54-70, ``_inv3`` :73-88 and ``_neg_semidefinite``
:91-103; parity: mad/Detector.py:66-107), and with :func:`localize_peaks`
the rest of ``detect_counts`` after its top-k (:205-212: the seeds from
the flat indices, their clip into the border, ``valid_seed & good``).
Each peak runs up to ``n_iter`` Newton steps on the finite-difference
Hessian and gradient of the 3x3x3 patch at its position (placed on a face
as mad_tpu places it, :func:`patch_index`): an offset component beyond
``max_offset`` walks one voxel that way (clamped to the interior of the
real extent), all components within it accept the peak, a singular
Hessian (|det| <= 1e-20) marks it bad; an accepted or bad peak is frozen.
Accepted peaks whose last Hessian has a positive eigenvalue (a saddle)
are rejected.

The CUDA kernel ``csrc/localize.cu`` gives each peak a warp, which loads
the 5x5x5 window about the seed's patch in one round trip and walks on it
(reloading only when the walk leaves it), stops once the peak is frozen
(nothing it holds changes after that), and rounds every product, sum and
quotient as :func:`localize_plain` (the batched torch-op walk) does, so
the two agree bit for bit. It takes its seeds in one of two forms, one
launch each:

* :func:`localize_peaks` (the single-device path): K4's flat indices and
  values; the kernel makes the seeds (:func:`flat_seeds`) and writes
  ``valid`` (value above the threshold, localized, not a saddle), so no
  PyTorch op runs between K4 and the anchor table;
* :func:`localize`: the seeds (K, 3) themselves, for capacity mode
  (mad_tpu/ops/detect.py:236-275, ``detect_shard``), which splits them
  among shards by x before K5 runs. ``vol`` is then a shard's x-slab
  extended by its neighbours' rows, its row 0 global row ``goff`` of a
  field of ``nx`` rows. Seeds, the walk and its bounds stay global; the
  patch is placed on the whole field's extent and then moved into the
  block (:func:`patch_index`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0            # kernel launches since the last reset


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Cofactor determinant of (..., 3, 3), jnp.linalg.det's 3x3 formula."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _hessian_grad(p: torch.Tensor):
    """Finite-difference Hessian + gradient from (K, 3, 3, 3) patches
    (parity: mad/Detector.py:66-79)."""
    c = p[:, 1, 1, 1]
    xx = p[:, 0, 1, 1] + p[:, 2, 1, 1] - 2 * c
    yy = p[:, 1, 0, 1] + p[:, 1, 2, 1] - 2 * c
    zz = p[:, 1, 1, 0] + p[:, 1, 1, 2] - 2 * c
    xy = 0.25 * ((p[:, 2, 2, 1] - p[:, 2, 0, 1]) - (p[:, 0, 2, 1] - p[:, 0, 0, 1]))
    xz = 0.25 * ((p[:, 2, 1, 2] - p[:, 2, 1, 0]) - (p[:, 0, 1, 2] - p[:, 0, 1, 0]))
    yz = 0.25 * ((p[:, 1, 2, 2] - p[:, 1, 2, 0]) - (p[:, 1, 0, 2] - p[:, 1, 0, 0]))
    H = torch.stack([torch.stack([xx, xy, xz], -1),
                     torch.stack([xy, yy, yz], -1),
                     torch.stack([xz, yz, zz], -1)], -2)
    G = 0.5 * torch.stack([p[:, 2, 1, 1] - p[:, 0, 1, 1],
                           p[:, 1, 2, 1] - p[:, 1, 0, 1],
                           p[:, 1, 1, 2] - p[:, 1, 1, 0]], -1)
    return H, G


def _inv3(H: torch.Tensor):
    """Adjugate-based 3x3 inverse; returns (inv, ok)."""
    det = _det3(H)
    ok = torch.abs(det) > 1e-20
    h = lambda i, j: H[:, i, j]
    adj = torch.stack([
        torch.stack([h(1, 1) * h(2, 2) - h(1, 2) * h(2, 1),
                     h(0, 2) * h(2, 1) - h(0, 1) * h(2, 2),
                     h(0, 1) * h(1, 2) - h(0, 2) * h(1, 1)], -1),
        torch.stack([h(1, 2) * h(2, 0) - h(1, 0) * h(2, 2),
                     h(0, 0) * h(2, 2) - h(0, 2) * h(2, 0),
                     h(0, 2) * h(1, 0) - h(0, 0) * h(1, 2)], -1),
        torch.stack([h(1, 0) * h(2, 1) - h(1, 1) * h(2, 0),
                     h(0, 1) * h(2, 0) - h(0, 0) * h(2, 1),
                     h(0, 0) * h(1, 1) - h(0, 1) * h(1, 0)], -1),
    ], -2)
    return adj / torch.where(ok, det, torch.ones_like(det))[:, None, None], ok


def _neg_semidefinite(H: torch.Tensor) -> torch.Tensor:
    """No positive eigenvalue of symmetric H: trace <= 0, sum of principal
    2x2 minors >= 0, det <= 0 (saddle rejection, mad/Detector.py:103-107)."""
    i1 = H[:, 0, 0] + H[:, 1, 1] + H[:, 2, 2]
    i2 = (H[:, 0, 0] * H[:, 1, 1] - H[:, 0, 1] * H[:, 1, 0]
          + H[:, 0, 0] * H[:, 2, 2] - H[:, 0, 2] * H[:, 2, 0]
          + H[:, 1, 1] * H[:, 2, 2] - H[:, 1, 2] * H[:, 2, 1])
    i3 = _det3(H)
    return (i1 <= 0) & (i2 >= 0) & (i3 <= 0)


_PATCH = torch.stack(torch.meshgrid(
    *([torch.arange(3)] * 3), indexing="ij"), -1).reshape(27, 3)


def patch_index(pos: torch.Tensor, shape, goff: int = 0, nx=None
                ) -> torch.Tensor:
    """(K, 27, 3) voxel indices of the 3x3x3 patch about each position
    (K, 3), as mad_tpu's ``lax.dynamic_slice`` places it: per axis the
    start s = pos - 1 becomes s + n when negative (n the volume's own
    extent), then is clamped to [0, n - 3]. So at the upper face the
    patch ends on the last voxel, and at pos 0 it is the far face's last
    three voxels. The position itself is not clamped.

    Offset form: ``shape`` is a block whose row 0 is row ``goff`` of a
    field of ``nx`` rows; the x start is placed on the field's extent, then
    moved into the block (minus goff, clamped to [0, X - 3])."""
    n = torch.as_tensor([int(e) for e in shape], device=pos.device)
    full = n.clone()
    if nx is not None:
        full[0] = int(nx)
    start = pos - 1
    start = torch.where(start < 0, start + full, start)
    start = torch.minimum(torch.clamp(start, min=0), full - 3)
    start[:, 0] -= int(goff)
    start = torch.minimum(torch.clamp(start, min=0), n - 3)
    return start[:, None, :] + _PATCH.to(pos.device)[None]


def localize_plain(vol: torch.Tensor, seeds: torch.Tensor, real_shape,
                   max_offset: float, n_iter: int, goff: int = 0, nx=None):
    """Newton walk from each seed (K, 3) int64; returns (coords, subvox,
    accepted & not a saddle)."""
    K = seeds.shape[0]
    dev = vol.device
    rs = torch.as_tensor(real_shape, device=dev)
    pos = seeds.clone()
    offset = torch.zeros((K, 3), dtype=vol.dtype, device=dev)
    H = torch.zeros((K, 3, 3), dtype=vol.dtype, device=dev)
    accepted = torch.zeros(K, dtype=torch.bool, device=dev)
    bad = torch.zeros(K, dtype=torch.bool, device=dev)
    for _ in range(n_iter):
        p = patch_index(pos, vol.shape, goff, nx)
        patch = vol[p[..., 0], p[..., 1], p[..., 2]].reshape(K, 3, 3, 3)
        Hn, G = _hessian_grad(patch)
        Hinv, ok = _inv3(Hn)
        off = -(Hinv[..., 0] * G[:, 0:1] + Hinv[..., 1] * G[:, 1:2]
                + Hinv[..., 2] * G[:, 2:3])
        acc_now = (torch.abs(off) < max_offset).all(dim=1) & ok
        # Voxel walk toward the offset, clamped to the interior
        # (mad/Detector.py:92-97; bounds use the real extent).
        lo_ok = pos - 1 > 0
        hi_ok = pos + 1 < rs - 1
        step = (((off < -max_offset) & lo_ok).to(pos.dtype) * -1
                + ((off > max_offset) & hi_ok).to(pos.dtype))
        frozen = accepted | bad
        pos = torch.where((frozen | acc_now)[:, None], pos, pos + step)
        offset = torch.where(frozen[:, None], offset, off)
        H = torch.where(frozen[:, None, None], H, Hn)
        accepted, bad = accepted | (acc_now & ~bad), bad | (~ok & ~accepted)
    good = accepted & _neg_semidefinite(H)
    return pos, pos.to(vol.dtype) + offset, good


def flat_seeds(flat: torch.Tensor, shape, real_shape, border: int
               ) -> torch.Tensor:
    """Voxel coords (K, 3) of flat indices into a volume of ``shape``,
    clamped to [border, real - border - 1] per axis."""
    seeds = torch.stack([flat // (shape[1] * shape[2]),
                         (flat // shape[2]) % shape[1], flat % shape[2]], -1)
    hi = torch.as_tensor(np.asarray(real_shape) - border - 1,
                         device=seeds.device)
    return torch.minimum(torch.clamp(seeds, min=border), hi)


def localize_peaks_plain(vol: torch.Tensor, flat: torch.Tensor,
                         vals: torch.Tensor, real_shape, threshold: float,
                         border: int, max_offset: float, n_iter: int):
    """The seeds of K4's peaks, their Newton walk and their validity:
    (coords, subvox, valid)."""
    seeds = flat_seeds(flat, vol.shape, real_shape, border)
    pos, subvox, good = localize_plain(vol, seeds, real_shape, max_offset,
                                       n_iter)
    return pos, subvox, (vals > threshold) & good


def localize_peaks(vol: torch.Tensor, flat: torch.Tensor,
                   vals: torch.Tensor, real_shape, threshold: float,
                   border: int, max_offset: float, n_iter: int):
    """Newton walk of K4's peaks (``flat`` (K,) int64 indices into the
    float32 volume ``vol``, ``vals`` (K,) float32 their values) from their
    seeds clamped ``border`` voxels inside ``real_shape``. Returns (coords
    (K, 3) int64, subvox (K, 3) float32, valid (K,) bool: value above
    ``threshold``, accepted and not a saddle)."""
    _check_volume(vol)
    if vol.device.type == "cpu":
        return localize_peaks_plain(vol, flat, vals, real_shape, threshold,
                                    border, max_offset, n_iter)
    if flat.dtype != torch.int64 or vals.dtype != torch.float32 \
            or flat.dim() != 1 or vals.shape != flat.shape:
        raise ValueError(f"localize_peaks: flat (K,) int64 and vals (K,) "
                         f"float32, got {tuple(flat.shape)} {flat.dtype} "
                         f"and {tuple(vals.shape)} {vals.dtype}")
    return _launch(vol, None, flat, vals, real_shape, threshold, border,
                   max_offset, n_iter, 0, None)


def localize(vol: torch.Tensor, seeds: torch.Tensor, real_shape,
             max_offset: float, n_iter: int, goff: int = 0, nx=None):
    """Newton walk from each seed of ``seeds`` (K, 3) int64 on the float32
    volume ``vol`` (a block from global row ``goff`` of a field of ``nx``
    rows; by default the whole field); ``real_shape`` bounds the walk.
    Returns (coords (K, 3) int64, subvox (K, 3) float32, good (K,) bool:
    accepted and not a saddle)."""
    _check_volume(vol)
    if vol.device.type == "cpu":
        return localize_plain(vol, seeds, real_shape, max_offset, n_iter,
                              goff, nx)
    if seeds.dim() != 2 or seeds.shape[1] != 3 or seeds.dtype != torch.int64:
        raise ValueError(f"localize: seeds must be (K, 3) int64, got "
                         f"{tuple(seeds.shape)} {seeds.dtype}")
    return _launch(vol, seeds, None, None, real_shape, 0.0, 0, max_offset,
                   n_iter, goff, nx)


def _check_volume(vol: torch.Tensor) -> None:
    if vol.dim() != 3 or min(vol.shape) < 3:
        raise ValueError(f"localize: need a 3D volume of extent >= 3, got "
                         f"{tuple(vol.shape)}")


def _launch(vol, seeds, flat, vals, real_shape, threshold, border,
            max_offset, n_iter, goff, nx):
    """One launch of K5 with either seed source (``seeds``, or ``flat``
    and ``vals``). Its host work is checks that launch nothing and the
    three outputs' allocations (three ``torch.empty`` take less of the
    host than one buffer cut into typed views: 16.5 against 23.1 us a call
    on the H100 machine's host, scripts/torch_localize_flags_probe.py
    --host)."""
    global launches
    if vol.dtype != torch.float32:
        raise ValueError(f"localize: need a 3D float32 volume, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    vol = vol.contiguous()
    if seeds is not None:
        seeds = seeds.contiguous()
        ins, ptrs = (seeds,), (seeds.data_ptr(), 0, 0)
    else:
        ins, ptrs = (flat, vals), (0, flat.data_ptr(), vals.data_ptr())
    build.require_cuda("localize", vol, *ins)
    K, dev = ins[0].shape[0], vol.device
    pos = torch.empty((K, 3), dtype=torch.int64, device=dev)
    subvox = torch.empty((K, 3), dtype=torch.float32, device=dev)
    good = torch.empty(K, dtype=torch.bool, device=dev)
    if K == 0:
        return pos, subvox, good
    # threshold and max_offset go over as C floats: the plain version
    # compares float32 tensors with the Python floats in float32.
    build.launch(
        build.library().mad_localize, dev, vol.data_ptr(), *vol.shape, *ptrs,
        K, *(int(s) for s in real_shape), int(border), float(threshold),
        float(max_offset), int(n_iter), int(goff),
        vol.shape[0] if nx is None else int(nx), pos.data_ptr(),
        subvox.data_ptr(), good.data_ptr())
    launches += 1
    return pos, subvox, good
