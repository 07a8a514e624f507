"""Copied from mad_tpu/core/mrc_io.py (numpy only, unchanged).

Minimal native MRC2014 reader/writer (no mrcfile dependency).

Covers what the pipeline needs: mode-2 (float32) volumes, nx/ny/nz, mode,
nxstart trio, mx/my/mz, cell dimensions, axis-order words mapc/mapr/maps and
the origin record. Data is returned as (ns, nr, nc) with the column axis
fastest, mirroring the mrcfile .data layout the reference consumes
(mad/Dmap.py:26-43).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_MODE_DTYPES = {
    0: np.int8, 1: np.int16, 2: np.float32, 6: np.uint16, 12: np.float16,
}


@dataclass
class MrcHeader:
    nx: int; ny: int; nz: int
    mode: int
    nxstart: int; nystart: int; nzstart: int
    mx: int; my: int; mz: int
    cella: tuple
    mapc: int; mapr: int; maps: int
    origin: tuple

    @property
    def voxel_size_x(self) -> float:
        return self.cella[0] / self.mx if self.mx else 0.0


def _byte_order(raw: bytes) -> str:
    """Endianness from the MRC2014 machine stamp (word 54), with a
    sane-dimensions heuristic for files that left the stamp blank
    (common in older EMDB depositions)."""
    stamp = raw[212:214]
    if stamp in (b"\x44\x44", b"\x44\x41", b"\x41\x44"):
        return "<"
    if stamp == b"\x11\x11":
        return ">"
    # Heuristic: dimensions must be positive and believable.
    def plausible(e):
        nx, ny, nz, mode = struct.unpack(e + "4i", raw[0:16])
        return all(0 < v < (1 << 20) for v in (nx, ny, nz)) and \
            0 <= mode < 128
    if plausible("<"):
        return "<"
    if plausible(">"):
        return ">"
    return "<"


def read_mrc(path: str):
    """Returns (header, data) with data shaped (nz, ny, nx) as stored.
    Handles both byte orders (machine stamp / header heuristic)."""
    with open(path, "rb") as fh:
        raw = fh.read(1024)
        e = _byte_order(raw)
        ints = struct.unpack(e + "10i", raw[0:40])
        nx, ny, nz, mode, nxstart, nystart, nzstart, mx, my, mz = ints
        cella = struct.unpack(e + "3f", raw[40:52])
        mapc, mapr, maps = struct.unpack(e + "3i", raw[64:76])
        nsymbt = struct.unpack(e + "i", raw[92:96])[0]
        origin = struct.unpack(e + "3f", raw[196:208])
        if mode not in _MODE_DTYPES:
            raise ValueError(f"Unsupported MRC mode {mode} in {path}")
        fh.seek(1024 + nsymbt)
        dtype = np.dtype(_MODE_DTYPES[mode]).newbyteorder(e)
        data = np.fromfile(fh, dtype=dtype,
                           count=nx * ny * nz).reshape(nz, ny, nx)
        if e == ">":
            # native byte order for device transfer and downstream numpy
            data = data.astype(dtype.newbyteorder("="))
    hdr = MrcHeader(nx=nx, ny=ny, nz=nz, mode=mode, nxstart=nxstart,
                    nystart=nystart, nzstart=nzstart, mx=mx, my=my, mz=mz,
                    cella=cella, mapc=mapc, mapr=mapr, maps=maps,
                    origin=origin)
    return hdr, data


def write_mrc(path: str, data_zyx: np.ndarray, voxsp: float, origin) -> None:
    """Write a mode-2 map with mapc/r/s = 1/2/3 (parity mad/Dmap.py:392-416).

    data_zyx: (nz, ny, nx) float32 (x fastest).
    """
    nz, ny, nx = data_zyx.shape
    hdr = bytearray(1024)
    struct.pack_into("<10i", hdr, 0, nx, ny, nz, 2, 0, 0, 0, nx, ny, nz)
    struct.pack_into("<3f", hdr, 40, nx * voxsp, ny * voxsp, nz * voxsp)
    struct.pack_into("<3f", hdr, 52, 90.0, 90.0, 90.0)
    struct.pack_into("<3i", hdr, 64, 1, 2, 3)
    d = np.asarray(data_zyx, dtype=np.float32)
    struct.pack_into("<3f", hdr, 76, float(d.min()), float(d.max()),
                     float(d.mean()))
    struct.pack_into("<i", hdr, 88, 1)        # ispg
    struct.pack_into("<3f", hdr, 196, float(origin[0]), float(origin[1]),
                     float(origin[2]))
    hdr[208:212] = b"MAP "
    hdr[212:216] = bytes([0x44, 0x44, 0, 0])  # little-endian machine stamp
    struct.pack_into("<f", hdr, 216, float(d.std()))
    with open(path, "wb") as fh:
        fh.write(bytes(hdr))
        d.tofile(fh)
