"""K1: 1D convolution of float32 volumes along one axis, and the fused LoG.

Replaces mad_tpu/ops/convolve.py:79-124 (``conv1d_along``) and :144-162
(``log_filter3d``'s passes and epilogue). The CUDA kernels are
``csrc/conv1d.cu`` (its note says what bounds them and how they are laid
out):

* :func:`conv1d_along` convolves a volume, or a batch of volumes with a
  leading batch axis, along one spatial axis; :func:`conv1d_along_plain`
  is the plain PyTorch shift-add of the JAX original. For the
  simulation's 'full' blur of a batch (mad_tpu/ops/simulate.py:103-105)
  it takes two optional epilogues, per structure (each leading slice):
  ``divide_by`` divides the input by max(its max, 1e-30) as it is loaded,
  ``max_into`` merges the output's max into order keys (:mod:`.maxkey`);
* :func:`log_gauss` is the scale-normalized LoG and the Gaussian of one
  volume in three launches (x, y, z); :func:`log_gauss_plain` is the
  sequence of nine shift-adds and five torch ops that ``log_filter3d``
  ran before, which the kernels round as.

Each entry takes the plain path for a CPU tensor and launches the kernel
for a CUDA tensor (raising if it cannot); there is no fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build, maxkey

launches = 0            # single-axis kernel launches since the last reset
log_launches = 0        # fused LoG pass launches (three a volume)
divide_launches = 0     # single-axis launches with the divide epilogue
max_launches = 0        # single-axis launches with the max epilogue

MAX_TAPS = 129          # taps the kernels take (their parameter block)


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
    along spatial ``axis`` (of the last three dims), zero taps skipped,
    summed in m order (the order of mad_tpu/ops/convolve.py:116-123)."""
    k = np.asarray(kernel, dtype=np.float32)
    ksz = k.shape[0]
    axis = vol.dim() - 3 + axis
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


def _host_taps(kernel) -> np.ndarray:
    k = np.ascontiguousarray(np.asarray(kernel, dtype=np.float32))
    if k.ndim != 1 or not 1 <= k.shape[0] <= MAX_TAPS:
        raise ValueError(f"conv1d: {k.shape} taps (the kernels take "
                         f"1-{MAX_TAPS})")
    return k


def _check_volume(name: str, vol: torch.Tensor, dims) -> None:
    if vol.dim() not in dims or vol.dtype != torch.float32:
        raise ValueError(f"{name}: need a {' or '.join(map(str, dims))}D "
                         f"float32 volume, got {tuple(vol.shape)} "
                         f"{vol.dtype}")
    if vol.numel() >= 2 ** 31:
        raise ValueError(f"{name}: volume too large for int32 indexing")


def conv1d_along(vol: torch.Tensor, kernel: np.ndarray, axis: int,
                 mode: str = "same", divide_by: torch.Tensor = None,
                 max_into: torch.Tensor = None) -> torch.Tensor:
    """Convolve a 3D volume, or a (B, X, Y, Z) batch, with a 1D kernel
    along spatial axis ``axis`` ('same': zero padded, size kept; 'full':
    grows by len(kernel) - 1). ``divide_by``, ``max_into``: (B,) int32
    max keys (one for a 3D volume): the input divided by max(max, 1e-30)
    per structure first; the output's max per structure merged in."""
    B = vol.shape[0] if vol.dim() == 4 else 1
    for keys in (divide_by, max_into):
        if keys is not None and (keys.shape != (B,)
                                 or keys.dtype != torch.int32):
            raise ValueError(f"conv1d_along: max keys {tuple(keys.shape)} "
                             f"{keys.dtype} for {B} structures")
    if vol.device.type == "cpu":
        if divide_by is not None:
            vol = vol / maxkey.divisors(divide_by).view(
                (-1,) + (1,) * (vol.dim() - 1))
        out = conv1d_along_plain(vol, kernel, axis, mode)
        if max_into is not None:
            maxkey.merge_(max_into, out.reshape((B,) + out.shape[-3:]))
        return out
    global launches, divide_launches, max_launches
    k = _host_taps(kernel)
    _check_volume("conv1d_along", vol, (3, 4))
    vol = vol.contiguous()
    build.require_cuda("conv1d_along", vol, *[t for t in (divide_by, max_into)
                                              if t is not None])
    dim = vol.dim() - 3 + axis
    n, lo, _hi, out_n = _geometry(vol.shape, dim, k.shape[0], mode)
    shape = list(vol.shape)
    outer = int(np.prod(shape[:dim], dtype=np.int64))
    inner = int(np.prod(shape[dim + 1:], dtype=np.int64))
    shape[dim] = out_n
    out = torch.empty(shape, dtype=torch.float32, device=vol.device)
    if out.numel() == 0:
        return out
    build.launch(
        build.library().mad_conv1d, vol.device, vol.data_ptr(),
        out.data_ptr(), k.ctypes.data, k.shape[0], outer, n, inner, out_n,
        lo, 0 if divide_by is None else divide_by.data_ptr(),
        0 if max_into is None else max_into.data_ptr(), outer // B)
    launches += 1
    divide_launches += divide_by is not None
    max_launches += max_into is not None
    return out


def _take(vol):
    """The volume, and the caller's one-element list emptied: the entry
    then holds the only reference it was handed."""
    if isinstance(vol, list):
        return vol.pop()
    return vol


def log_gauss_plain(vol, g0: np.ndarray, g2: np.ndarray, sigma: float):
    """(LoG response, Gaussian) of a 3D volume: the nine shift-adds of
    mad_tpu/ops/convolve.py:152-162 and its epilogue, as torch ops.
    ``vol`` may be a one-element list, which is emptied."""
    vol = _take(vol)
    c = conv1d_along_plain
    ax = c(vol, g0, 0)
    axy = c(ax, g0, 1)
    gauss = c(axy, g0, 2)
    lap = c(axy, g2, 2)                                      # term_z
    del axy
    term = c(c(ax, g2, 1), g0, 2)                            # term_y
    del ax
    x = c(c(c(vol, g2, 0), g0, 1), g0, 2)                    # term_x
    del vol
    # lap = term_x + term_y + term_z, summed in that order
    lap = torch.add(x, term).add_(lap)
    del x, term
    log_resp = torch.clamp_(lap.neg_().mul_(sigma ** 2), min=0.0)
    return log_resp, gauss


def log_gauss(vol, g0: np.ndarray, g2: np.ndarray, sigma: float):
    """(LoG response, Gaussian) of a 3D volume with the order 0 and 2
    Gaussian taps g0 and g2, in three kernel launches; bit for bit with
    :func:`log_gauss_plain`. Pass the volume in a one-element list to hand
    it over: the list is emptied and the volume freed as soon as the x
    pass has read it (then the peak holds 5 volumes)."""
    vol = _take(vol)
    if vol.device.type == "cpu":
        return log_gauss_plain(vol, g0, g2, sigma)
    k0, k2 = _host_taps(g0), _host_taps(g2)
    if k0.shape != k2.shape:
        raise ValueError(f"log_gauss: {k0.shape} and {k2.shape} taps")
    _check_volume("log_gauss", vol, (3,))
    vol = vol.contiguous()
    build.require_cuda("log_gauss", vol)
    dev = vol.device
    X, Y, Z = vol.shape
    lib = build.library()
    # float32 of sigma^2, as mul_ takes the Python float
    s2 = float(np.float32(sigma ** 2))

    def run(p, ins, outs):
        global log_launches
        ins = ins + [None] * (3 - len(ins))
        outs = outs + [None] * (3 - len(outs))
        build.launch(lib.mad_log_pass, dev, p,
                     *[0 if t is None else t.data_ptr() for t in ins + outs],
                     k0.ctypes.data, k2.ctypes.data, k0.shape[0], X, Y, Z,
                     s2)
        log_launches += 1

    new = lambda: torch.empty((X, Y, Z), dtype=torch.float32, device=dev)
    ax, bx = new(), new()
    run(0, [vol], [ax, bx])
    del vol
    axy, a2y, bxy = new(), new(), new()
    run(1, [ax, bx], [axy, a2y, bxy])
    del ax, bx
    gauss, log_resp = new(), new()
    run(2, [axy, a2y, bxy], [gauss, log_resp])
    return log_resp, gauss
