"""K20b: the symmetrized, trimmed overlap that the enumeration heads read.

Replaces mad_tpu/engine/assemble.py:316-333 (``_compiled_embed_sym``)
without the TPU's static frame: from K18's (n, n) float32 upper-triangular
overlap on the card it builds the (t, t) float32 matrix
``ov[:t, :t] + ov[:t, :t].T`` for K19 / K20, so the overlap stays on the
card between them. One of each off-diagonal pair is 0, so the float32 sum
equals the float64 sum rounded to float32 (the port's host path before).

The CUDA kernel ``csrc/symmetrize.cu`` writes one element a thread;
:func:`sym_trim_plain` is the plain PyTorch version.
"""

from __future__ import annotations

import torch

from . import build

launches = 0            # kernel launches since the last reset


def sym_trim_plain(ov: torch.Tensor, t: int) -> torch.Tensor:
    block = ov[:t, :t].to(torch.float32)
    return block + block.T


def sym_trim(ov: torch.Tensor, t: int) -> torch.Tensor:
    """(t, t) float32 ov[:t, :t] + ov[:t, :t]^T of an (n, n) overlap,
    0 <= t <= n."""
    n = ov.shape[0]
    if ov.dim() != 2 or ov.shape[1] != n or not 0 <= t <= n:
        raise ValueError(f"sym_trim: need a square matrix and 0 <= t <= n, "
                         f"got {tuple(ov.shape)}, t={t}")
    if ov.device.type == "cpu":
        return sym_trim_plain(ov, t)
    global launches
    ov = ov.to(torch.float32).contiguous()
    build.require_cuda("sym_trim", ov)
    out = torch.empty((t, t), dtype=torch.float32, device=ov.device)
    if t == 0:
        return out
    build.launch(
        build.library().mad_sym_trim, ov.device, ov.data_ptr(), n, t,
        out.data_ptr())
    launches += 1
    return out
