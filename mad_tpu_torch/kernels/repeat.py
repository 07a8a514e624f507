"""K13: exact pose repeatability of descriptor pairs.

Replaces mad_tpu/engine/match.py:176-200 (``_exact_repeat_body``). The
CUDA kernel ``csrc/repeat.cu`` takes a warp for each (pair, group of 32
subunit anchors), one anchor a lane, and streams the map cloud through
shared memory (its note says what bounds it);
:func:`exact_repeat_plain` is the plain PyTorch version: the JAX body's
|y|^2 + |b|^2 - 2 y.b expansion, chunked over pairs.
"""

from __future__ import annotations

import torch

from . import build

launches = 0            # kernel launches since the last reset


def exact_repeat_plain(hi_cloud: torch.Tensor, lo_cloud: torch.Tensor,
                       rot: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                       thresh: float, chunk: int = 16) -> torch.Tensor:
    denom = max(hi_cloud.shape[0], 1)
    lo_sq = (lo_cloud * lo_cloud).sum(dim=-1)
    out = torch.empty(rot.shape[0], dtype=torch.float32,
                      device=hi_cloud.device)
    for s in range(0, rot.shape[0], chunk):
        R, h, l = rot[s:s + chunk], hi[s:s + chunk], lo[s:s + chunk]
        pts = torch.einsum("cad,ced->cae", hi_cloud[None] - h[:, None], R) \
            + l[:, None]
        d2 = ((pts * pts).sum(dim=-1)[..., None] + lo_sq[None, None]
              - 2.0 * torch.einsum("cad,ld->cal", pts, lo_cloud))
        dmin = d2.amin(dim=-1)
        cnt = (dmin < thresh * thresh).sum(dim=-1).to(torch.float32)
        # a full tensor, not a scalar: true division, as the kernel does
        out[s:s + chunk] = 100.0 * cnt / torch.full_like(cnt, denom)
    return out


def exact_repeat(hi_cloud: torch.Tensor, lo_cloud: torch.Tensor,
                 rot: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                 thresh: float) -> torch.Tensor:
    """Per pair k: 100 * (# subunit anchors x with min_b |(x - hi_k) @ R_k^T
    + lo_k - b| < thresh) / len(hi_cloud), b over the map cloud.

    hi_cloud (A_hi, 3), lo_cloud (A_lo, 3), rot (P, 3, 3), hi/lo (P, 3),
    all float32 on one device. Returns (P,) float32."""
    if hi_cloud.device.type == "cpu":
        return exact_repeat_plain(hi_cloud, lo_cloud, rot, hi, lo, thresh)
    global launches
    args = [t.to(torch.float32).contiguous()
            for t in (hi_cloud, lo_cloud, rot, hi, lo)]
    build.require_cuda("exact_repeat", *args)
    hi_cloud, lo_cloud, rot, hi, lo = args
    if rot.shape[1:] != (3, 3) or hi_cloud.shape[-1] != 3:
        raise ValueError("exact_repeat: bad shapes")
    P = rot.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=rot.device)
    if P == 0:
        return out
    # each pair's hits and its warps' ticket, only where a pair has several
    # groups of 32 anchors (the kernel never reads it otherwise)
    counts = (torch.empty(2 * P, dtype=torch.int32, device=rot.device)
              if hi_cloud.shape[0] > 32 else None)
    build.launch(
        build.library().mad_exact_repeat, rot.device, hi_cloud.data_ptr(),
        hi_cloud.shape[0], lo_cloud.data_ptr(), lo_cloud.shape[0],
        rot.data_ptr(), hi.data_ptr(), lo.data_ptr(), P,
        float(thresh) * float(thresh),
        0 if counts is None else counts.data_ptr(), out.data_ptr())
    launches += 1
    return out
