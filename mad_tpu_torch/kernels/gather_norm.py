"""K8: keep-gather of descriptor rows, octave concatenation and L2 row
normalization.

Replaces mad_tpu/engine/pipeline.py:229-257 (``_compiled_gather_norm``).
Each octave's descriptor table (L_o, D) int16 gives the rows its keep
indices name, the octaves in order one after the other: the (N, D) int16
table and its float32 unit rows ``c / sqrt(sum c^2)`` (zero rows stay
zero).

The CUDA kernels ``csrc/gather_norm.cu`` give one warp to each output row:
it gathers the row, sums the squares in integers (exact) and writes both
tables. Where every table is 16-byte aligned and D is a multiple of 8 up to
:data:`MAX_VECTOR_D` (:func:`vector_path`; the describe path's and the
cache loader's tables are) the row is held in registers, read and written
16 bytes at a time; other tables take a scalar path, 2 bytes a load, with
the same bits. Counts of a ``patch_size``-16 lattice sum to at most 4096 a row,
so sum c^2 <= 2^24 and the plain version's float32 sum is exact too: the
two are equal bit for bit. Above that (``patch_size`` 24: up to 13,824
samples a row) the plain float32 sum may round where the kernel's does
not; the unit rows then differ by at most an ulp or so, and the tests hold
them within 1 ulp on realistic rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0            # kernel launches since the last reset

MAX_OCTAVES = 4         # tables one launch takes (csrc/gather_norm.cu)
MAX_VECTOR_D = 2048     # bins a row of the 16-byte path (256 kMaxVec)


def _unit_rows(desc: torch.Tensor) -> torch.Tensor:
    """Unit rows in float32, zero rows kept (the normalization of
    mad_tpu/engine/pipeline.py:251-254)."""
    norm = desc.to(torch.float32)
    lens = torch.sqrt((norm * norm).sum(dim=1, keepdim=True))
    return torch.where(lens > 0, norm / torch.where(lens > 0, lens,
                                                    torch.ones_like(lens)),
                       norm)


def gather_norm_plain(tables, keeps):
    """``cat(table[keep] for each octave)`` as int16, and its unit rows."""
    desc = torch.cat([t[k] for t, k in zip(tables, keeps)]).to(torch.int16)
    return desc, _unit_rows(desc)


def vector_path(tables) -> bool:
    """Whether the kernel reads and writes these (L, D) int16 tables'
    rows 16 bytes at a time: D a multiple of 8 up to MAX_VECTOR_D, every
    table 16-byte aligned (the outputs, fresh, always are)."""
    D = tables[0].shape[-1]
    return (D % 8 == 0 and D <= MAX_VECTOR_D
            and all(t.data_ptr() % 16 == 0 for t in tables))


def gather_norm(tables, keeps):
    """The kept rows of the octaves' (L_o, D) int16 descriptor tables, in
    octave order, as an (N, D) int16 table and its (N, D) float32 unit
    rows. ``keeps`` holds one int64 index vector per table, each index
    within its table."""
    if tables[0].device.type == "cpu":
        return gather_norm_plain(tables, keeps)
    global launches
    if not 1 <= len(tables) <= MAX_OCTAVES:
        raise ValueError(f"gather_norm: 1-{MAX_OCTAVES} tables, got "
                         f"{len(tables)}")
    D = tables[0].shape[-1]
    for t in tables:
        if t.dim() != 2 or t.dtype != torch.int16 or t.shape[1] != D:
            raise ValueError(f"gather_norm: tables must be (L, {D}) int16, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if len(keeps) != len(tables) or any(
            k.dim() != 1 or k.dtype != torch.int64 for k in keeps):
        raise ValueError("gather_norm: one (n,) int64 keep vector a table")
    tables = [t.contiguous() for t in tables]
    counts = [k.shape[0] for k in keeps]
    idx = torch.cat(keeps)
    build.require_cuda("gather_norm", *tables, idx)
    N = sum(counts)
    dev = tables[0].device
    desc = torch.empty((N, D), dtype=torch.int16, device=dev)
    unit = torch.empty((N, D), dtype=torch.float32, device=dev)
    if N == 0 or D == 0:
        return desc, unit.zero_()
    ptrs = (ctypes.c_void_p * len(tables))(*[t.data_ptr() for t in tables])
    row0 = [0]
    for c in counts:
        row0.append(row0[-1] + c)
    starts = (ctypes.c_longlong * len(row0))(*row0)
    lib = build.library()
    build.launch(
        lib.mad_gather_norm, dev, ptrs, starts, len(tables), idx.data_ptr(), N,
        D, desc.data_ptr(), unit.data_ptr(), int(vector_path(tables)))
    launches += 1
    return desc, unit
