"""K1: 1D convolution of a 3D float32 volume along one axis.

Replaces mad_tpu/ops/convolve.py:79-124 (``conv1d_along``). The CUDA
kernel is ``csrc/conv1d.cu`` (its note says what bounds it and how it is
laid out); :func:`conv1d_along_plain` is the plain PyTorch shift-add of the
JAX original, the reference on the CPU and on the card.

``conv1d_along`` takes the plain path for a CPU tensor and launches the
kernel for a CUDA tensor (raising if it cannot); there is no fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0            # kernel launches since the last reset

_taps_cache: dict = {}


def _geometry(shape, axis: int, ksz: int, mode: str):
    n = shape[axis]
    r = ksz // 2
    if mode == "same":
        lo, hi, out_n = r, ksz - 1 - r, n
    elif mode == "full":
        lo = hi = ksz - 1
        out_n = n + ksz - 1
    else:
        raise ValueError(mode)
    return n, lo, hi, out_n


def conv1d_along_plain(vol: torch.Tensor, kernel: np.ndarray, axis: int,
                       mode: str = "same") -> torch.Tensor:
    """Shift-and-add convolution: out = sum_m k[ksz-1-m] * padded[m:m+out_n]
    along ``axis``, zero taps skipped, summed in m order (the order of
    mad_tpu/ops/convolve.py:116-123)."""
    k = np.asarray(kernel, dtype=np.float32)
    ksz = k.shape[0]
    n, lo, hi, out_n = _geometry(vol.shape, axis, ksz, mode)
    pad_shape = list(vol.shape)
    pad_shape[axis] = n + lo + hi
    padded = vol.new_zeros(pad_shape)
    padded.narrow(axis, lo, n).copy_(vol)
    out = None
    for m in range(ksz):
        w = float(k[ksz - 1 - m])
        if w == 0.0:
            continue
        term = padded.narrow(axis, m, out_n) * w
        out = term if out is None else out + term
    if out is None:
        out = vol.new_zeros(pad_shape).narrow(axis, 0, out_n)
    return out


def _device_taps(k: np.ndarray, device) -> torch.Tensor:
    # Cached per (taps, device): a host-to-device copy of a pageable numpy
    # array waits for the stream, which would stall every launch.
    key = (k.tobytes(), str(device))
    t = _taps_cache.get(key)
    if t is None:
        t = torch.as_tensor(k, device=device)
        _taps_cache[key] = t
    return t


def conv1d_along(vol: torch.Tensor, kernel: np.ndarray, axis: int,
                 mode: str = "same") -> torch.Tensor:
    """Convolve a 3D volume with a 1D kernel along one axis ('same': zero
    padded, size kept; 'full': grows by len(kernel) - 1)."""
    if vol.device.type == "cpu":
        return conv1d_along_plain(vol, kernel, axis, mode)
    global launches
    k = np.ascontiguousarray(np.asarray(kernel, dtype=np.float32))
    ksz = k.shape[0]
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError(f"conv1d_along: need a 3D float32 volume, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    if not 1 <= ksz <= 257:
        raise ValueError(f"conv1d_along: {ksz} taps (kernel takes 1-257)")
    if vol.numel() >= 2 ** 31:
        raise ValueError("conv1d_along: volume too large for int32 indexing")
    vol = vol.contiguous()
    build.require_cuda("conv1d_along", vol)
    n, lo, _hi, out_n = _geometry(vol.shape, axis, ksz, mode)
    shape = list(vol.shape)
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    if inner > 1 and outer > 65535:
        raise ValueError("conv1d_along: outer extent exceeds the grid")
    shape[axis] = out_n
    out = torch.empty(shape, dtype=torch.float32, device=vol.device)
    taps = _device_taps(k, vol.device)
    lib = build.library()
    build.launch(
        lib.mad_conv1d, vol.device, vol.data_ptr(), out.data_ptr(),
        taps.data_ptr(), ksz, outer, n, inner, out_n, lo)
    launches += 1
    return out
