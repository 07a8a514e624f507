"""The native host parsers (port of mad_tpu/native/__init__.py).

``fastio.c`` is plain C: ``gcc -O2 -shared -fPIC`` builds it at first use
into ``mad_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the flags as ``kernels/build.py`` names the kernel library,
and ``ctypes`` loads it, so no Python headers are needed. Nothing runs at
import. Every caller keeps a pure-Python path (``core/structure.py``'s
``_parse_pdb_python``, ``core/grid.py``'s ``np.fromiter``) that gives the
same result, so a machine without a C compiler only loses speed:
:func:`get_fastio` is then None, mad_tpu's contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastio.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ["-O2", "-shared", "-fPIC"]
PDB_TEXT = 16           # bytes of an atom's text record (fastio.c)
PDB_LINE = 55           # least bytes of an accepted line and its newline

_P = ctypes.c_void_p
_L = ctypes.c_int64


class FastIO:
    """The loaded library. Its methods take the bytes of a file and
    return what mad_tpu's extension returns, as numpy arrays and lists."""

    def __init__(self, lib: ctypes.CDLL):
        lib.mad_fastio_parse_pdb.argtypes = [ctypes.c_char_p, _L, _L, _P, _P,
                                             _P, _P]
        lib.mad_fastio_parse_pdb.restype = _L
        lib.mad_fastio_parse_floats.argtypes = [ctypes.c_char_p, _L,
                                                ctypes.POINTER(_L)]
        lib.mad_fastio_parse_floats.restype = ctypes.POINTER(ctypes.c_double)
        lib.mad_fastio_free.argtypes = [_P]
        lib.mad_fastio_free.restype = None
        self.lib = lib

    def parse_pdb_bytes(self, data: bytes):
        """(coords (N, 3) float64, serials (N,) int64, residue numbers (N,)
        int64, names, residue names, chains, elements, records) of the
        ATOM / HETATM records in ``data``."""
        data = bytes(data)
        cap = (len(data) + 1) // PDB_LINE + 1
        coords = np.empty((cap, 3), np.float64)
        serials = np.empty(cap, np.int64)
        resnums = np.empty(cap, np.int64)
        text = np.empty((cap, PDB_TEXT), np.uint8)
        n = self.lib.mad_fastio_parse_pdb(
            data, len(data), cap, coords.ctypes.data, serials.ctypes.data,
            resnums.ctypes.data, text.ctypes.data)
        if n < 0:
            raise RuntimeError("fastio: more atoms than lines of 54 bytes")
        raw = text[:n].tobytes()
        starts = range(0, n * PDB_TEXT, PDB_TEXT)
        name_len = text[:n, 10].tolist()
        elem_len = text[:n, 11].tolist()
        names = [raw[o:o + k].decode() for o, k in zip(starts, name_len)]
        res_names = [raw[o + 4:o + 7].decode() for o in starts]
        chains = [raw[o + 7:o + 8].decode() for o in starts]
        elements = [raw[o + 8:o + 8 + k].decode()
                    for o, k in zip(starts, elem_len)]
        records = ["HETATM" if h else "ATOM" for h in text[:n, 12].tolist()]
        return (coords[:n].copy(), serials[:n].copy(), resnums[:n].copy(),
                names, res_names, chains, elements, records)

    def parse_floats(self, data: bytes) -> np.ndarray:
        """The whitespace-separated numbers of ``data``, float64, by
        ``strtod``'s walk (a byte that does not parse is skipped)."""
        data = bytes(data)
        n = _L(0)
        ptr = self.lib.mad_fastio_parse_floats(data, len(data),
                                               ctypes.byref(n))
        if not ptr:
            raise MemoryError("fastio: parse_floats")
        try:
            out = np.ctypeslib.as_array(ptr, shape=(n.value,)).copy() \
                if n.value else np.empty(0, np.float64)
        finally:
            self.lib.mad_fastio_free(ptr)
        return out


_lock = threading.Lock()
_fastio = None          # FastIO once loaded, False when the build failed


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libmad_fastio_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        subprocess.run(["gcc"] + CFLAGS + [str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    return so


def get_fastio():
    """The loaded parsers (:class:`FastIO`), built on first use, or None
    where no C compiler runs."""
    global _fastio
    with _lock:
        if _fastio is None:
            try:
                _fastio = FastIO(ctypes.CDLL(str(_build())))
            except (OSError, subprocess.SubprocessError):
                _fastio = False
        return _fastio or None
