"""K3: gradient field of a 3D float32 volume, (X, Y, Z) -> (X, Y, Z, 3).

Replaces mad_tpu/ops/scalespace.py:238-262 (``_grad_body``, both its
float32 and its bfloat16 branch). Per axis the interior is
``(v[i+1] - v[i-1]) * 0.5`` and the edges are one-sided, ``v[1] - v[0]`` and
``v[n-1] - v[n-2]``: ``jnp.gradient`` with unit spacing, term for term. A
bfloat16 field holds the float32 differences rounded to nearest even, as
the JAX body's ``astype`` and as ``copy_`` into a bfloat16 tensor do.

The CUDA kernel ``csrc/gradient.cu`` is a plane-marching stencil: a block
owns a ``FOOTPRINT`` of (y, z) columns, two rows a thread, and marches
along x over ``CHUNK`` planes, keeping planes x - 1, x and x + 1 with
their one-voxel y / z halo in shared memory, and its warps store the
rows' interleaved 3-component records as contiguous runs. It rounds as :func:`gradient_plain` (the
torch-op version) does, so the two are equal bit for bit in both types.
"""

from __future__ import annotations

import torch

from . import build

launches = 0            # kernel launches since the last reset
bf16_launches = 0       # of those, launches writing a bfloat16 field

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# A block's (y, z) columns, the planes it marches along x, the planes it
# has in flight past x + 1 and its ring of planes, as csrc/gradient.cu
# declares them (kTY, kTZ, kChunk, kAhead, kRing).
_C = build.constants("gradient.cu")
FOOTPRINT, CHUNK, AHEAD, RING = ((_C["kTY"], _C["kTZ"]), _C["kChunk"],
                                 _C["kAhead"], _C["kRing"])
# The kernel takes 64-bit offsets once 3 * X * Y * Z reaches this (it
# clamps it to 2^32); a test lowers it to run that path on a small field.
WIDE_FROM = 1 << 32


def gradient_plain(vol: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(X, Y, Z) -> (X, Y, Z, 3) central differences, one-sided at the
    edges (``jnp.gradient`` with unit spacing, term for term)."""
    out = torch.empty(vol.shape + (3,), dtype=dtype, device=vol.device)
    for a in range(3):
        n = vol.shape[a]
        o = out[..., a]
        o.narrow(a, 1, n - 2).copy_(
            (vol.narrow(a, 2, n - 2) - vol.narrow(a, 0, n - 2)) * 0.5)
        o.narrow(a, 0, 1).copy_(vol.narrow(a, 1, 1) - vol.narrow(a, 0, 1))
        o.narrow(a, n - 1, 1).copy_(vol.narrow(a, n - 1, 1)
                                    - vol.narrow(a, n - 2, 1))
    return out


def gradient(vol: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The gradient field of ``vol`` in ``dtype`` (float32 or bfloat16);
    every axis needs at least two samples."""
    if vol.device.type == "cpu":
        return gradient_plain(vol, dtype)
    global launches, bf16_launches
    if vol.dim() != 3 or vol.dtype != torch.float32 or dtype not in _DTYPES:
        raise ValueError(f"gradient: need a 3D float32 volume and a float32 "
                         f"or bfloat16 output, got {tuple(vol.shape)} "
                         f"{vol.dtype} -> {dtype}")
    if min(vol.shape) < 2:
        raise ValueError(f"gradient: every axis needs 2 samples, got "
                         f"{tuple(vol.shape)}")
    vol = vol.contiguous()
    build.require_cuda("gradient", vol)
    X, Y, Z = vol.shape
    out = torch.empty((X, Y, Z, 3), dtype=dtype, device=vol.device)
    lib = build.library()
    build.launch(
        lib.mad_gradient, vol.device, vol.data_ptr(), X, Y, Z, _DTYPES[dtype],
        out.data_ptr(), WIDE_FROM)
    launches += 1
    bf16_launches += dtype == torch.bfloat16
    return out
