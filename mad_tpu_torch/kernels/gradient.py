"""K3: gradient field of a 3D float32 volume, (X, Y, Z) -> (X, Y, Z, 3).

Replaces mad_tpu/ops/scalespace.py:238-262 (``_grad_body``, both its
float32 and its bfloat16 branch). Per axis the interior is
``(v[i+1] - v[i-1]) * 0.5`` and the edges are one-sided, ``v[1] - v[0]`` and
``v[n-1] - v[n-2]``: ``jnp.gradient`` with unit spacing, term for term. A
bfloat16 field holds the float32 differences rounded to nearest even, as
the JAX body's ``astype`` and as ``copy_`` into a bfloat16 tensor do.

The CUDA kernel ``csrc/gradient.cu`` gives one thread to each voxel, which
writes its interleaved 3-component record; it rounds as
:func:`gradient_plain` (the torch-op version) does, so the two are equal
bit for bit in both types.
"""

from __future__ import annotations

import torch

from . import build

launches = 0            # kernel launches since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    global launches
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
        out.data_ptr())
    launches += 1
    return out
