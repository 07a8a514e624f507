"""K12: approximate pose repeatability of descriptor pairs.

Replaces mad_tpu/engine/match.py:126-155 (``_approx_repeat_body``). The
CUDA kernel ``csrc/approx.cu`` takes one warp per pair, its lanes over
the subunit anchors, and counts the anchors whose rounded voxel after the
pose is in the grid and set in the field (K11), all pairs in one launch;
:func:`approx_repeat_plain` is the plain PyTorch version: the JAX body's
chunk loop in torch ops, with the pose summed as ``rows_times`` does.
"""

from __future__ import annotations

import torch

from ..core.geometry import rows_times
from . import build

launches = 0            # kernel launches since the last reset


def approx_repeat_plain(field: torch.Tensor, hi_cloud: torch.Tensor,
                        origin: torch.Tensor, inv_voxsp: float,
                        rot: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                        chunk: int = 256) -> torch.Tensor:
    shape = torch.as_tensor(field.shape, device=field.device)
    denom = max(hi_cloud.shape[0], 1)
    inv = torch.tensor(inv_voxsp, dtype=torch.float32, device=field.device)
    out = torch.empty(rot.shape[0], dtype=torch.float32, device=field.device)
    for s in range(0, rot.shape[0], chunk):
        R, h, l = rot[s:s + chunk], hi[s:s + chunk], lo[s:s + chunk]
        # (x - h) @ R^T + l, the pose convention of the start coordinates
        pts = rows_times(hi_cloud[None] - h[:, None],
                         R.transpose(1, 2)) + l[:, None]
        vox = torch.round((pts - origin) * inv).to(torch.int64)
        inb = ((vox >= 0) & (vox < shape)).all(dim=-1)
        vox = torch.minimum(torch.clamp(vox, min=0), shape - 1)
        hit = field[vox[..., 0], vox[..., 1], vox[..., 2]] > 0
        cnt = (hit & inb).sum(dim=-1).to(torch.float32)
        out[s:s + chunk] = 100.0 * cnt / torch.full_like(cnt, denom)
    return out


def approx_repeat(field: torch.Tensor, hi_cloud: torch.Tensor,
                  origin: torch.Tensor, inv_voxsp: float, rot: torch.Tensor,
                  hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Per pair k: 100 * (# subunit anchors x whose voxel
    round(((x - hi_k) @ R_k^T + lo_k - origin) * inv_voxsp) lies in the
    grid and is set in ``field``) / len(hi_cloud).

    field (X, Y, Z) int8; hi_cloud (A_hi, 3), origin (3,), rot (P, 3, 3),
    hi/lo (P, 3) float32, all on one device. Returns (P,) float32."""
    if field.device.type == "cpu":
        return approx_repeat_plain(field, hi_cloud, origin, inv_voxsp, rot,
                                   hi, lo)
    global launches
    hi_cloud, origin, rot, hi, lo = [
        t.to(torch.float32).contiguous()
        for t in (hi_cloud, origin, rot, hi, lo)]
    field = field.contiguous()
    build.require_cuda("approx_repeat", field, hi_cloud, origin, rot, hi, lo)
    if (field.dtype != torch.int8 or field.dim() != 3
            or rot.shape[1:] != (3, 3) or hi_cloud.shape[-1] != 3
            or origin.shape != (3,)):
        raise ValueError("approx_repeat: bad shapes or field type")
    P = rot.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=rot.device)
    if P == 0:
        return out
    X, Y, Z = field.shape
    lib = build.library()
    build.launch(
        lib.mad_approx_repeat, rot.device, field.data_ptr(), X, Y, Z,
        hi_cloud.data_ptr(), hi_cloud.shape[0], origin.data_ptr(),
        float(inv_voxsp), rot.data_ptr(), hi.data_ptr(), lo.data_ptr(), P,
        out.data_ptr())
    launches += 1
    return out
