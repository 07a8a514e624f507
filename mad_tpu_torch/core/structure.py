"""Copied from mad_tpu/core/structure.py: the ``Structure`` container,
the PDB reader (the native C parser of ``mad_tpu_torch/native`` where it
builds, the pure-Python one otherwise, as in mad_tpu) and the PDB
writers.

Atomic structure container + PDB reader / writers (host side, numpy).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..native import get_fastio

# Atomic masses (reference: mad/PDB.py:220-221).
ATOMIC_MASS = {
    "H": 1.00797, "BE": 9.01218, "C": 12.011, "N": 14.0067, "O": 15.9994,
    "F": 18.998403, "S": 32.06, "P": 30.97376, "MG": 24.305, "CL": 35.453,
    "K": 39.0983, "CA": 40.078, "MN": 54.9380, "FE": 55.847, "NI": 58.70,
    "CU": 63.546, "ZN": 65.38, "SE": 78.96,
}
DEFAULT_MASS = ATOMIC_MASS["C"]


@dataclass
class Structure:
    """Parsed structure. ``coords`` is (N, 3) float64 in Angstroms."""

    coords: np.ndarray
    masses: np.ndarray                    # (N,) float32
    ca_idx: np.ndarray                    # indices of CA atoms
    bb_idx: np.ndarray                    # indices of backbone atoms
    info: List[list] = field(default_factory=list)  # per-atom PDB fields
    source: str = ""

    @property
    def n_atoms(self) -> int:
        return self.coords.shape[0]

    @property
    def n_ca(self) -> int:
        return len(self.ca_idx)

    def copy(self) -> "Structure":
        return Structure(
            coords=self.coords.copy(),
            masses=self.masses,
            ca_idx=self.ca_idx,
            bb_idx=self.bb_idx,
            info=self.info,
            source=self.source,
        )

    def with_coords(self, coords: np.ndarray) -> "Structure":
        s = self.copy()
        s.coords = np.asarray(coords, dtype=np.float64)
        return s

    def transformed(self, R: np.ndarray, T: np.ndarray) -> "Structure":
        """Rigidly transformed copy: coords @ R + T."""
        return self.with_coords(self.coords @ np.asarray(R) + np.asarray(T))

    def center(self) -> np.ndarray:
        return self.coords.mean(axis=0)

    def rmsd_with(self, other: "Structure") -> float:
        d = np.square(self.coords - other.coords)
        return float(np.sqrt(d.sum() / d.shape[0]))

    def rmsd_ca_with(self, other: "Structure") -> float:
        """CA RMSD; falls back to all-atom when no CAs (mad/PDB.py:119-124)."""
        if not len(self.ca_idx):
            return self.rmsd_with(other)
        d = np.square(self.coords[self.ca_idx] - other.coords[other.ca_idx])
        return float(np.sqrt(d.sum() / d.shape[0]))


def parse_pdb(path: str) -> Structure:
    """Fixed-column PDB parser (columns per PDB v3.30, mad/PDB.py:41-69).

    Uses the native C parser (mad_tpu_torch/native/fastio.c) when it
    builds; otherwise falls back to the pure-Python path below.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"PDB file not found: {path}")
    native = get_fastio()
    if native is not None:
        return _parse_pdb_native(path, native)
    return _parse_pdb_python(path)


def _parse_pdb_native(path: str, native) -> Structure:
    with open(path, "rb") as fh:
        raw = fh.read()
    (coords, serials, resnums, names, res_names, chains, elements,
     records) = native.parse_pdb_bytes(raw)
    n = coords.shape[0]
    if n == 0:
        raise ValueError(f"No atoms parsed from {path}")
    masses = np.asarray(
        [ATOMIC_MASS.get(e.upper(), DEFAULT_MASS) for e in elements],
        dtype=np.float32)
    names_arr = np.asarray(names)
    ca_idx = np.nonzero(names_arr == "CA")[0]
    bb_idx = np.nonzero(np.isin(names_arr, ("C", "CA", "N", "O")))[0]
    info = [[int(serials[i]), names[i], res_names[i], chains[i],
             int(resnums[i]), elements[i], records[i]] for i in range(n)]
    return Structure(coords=coords, masses=masses, ca_idx=ca_idx,
                     bb_idx=bb_idx, info=info, source=path)


def _parse_pdb_python(path: str) -> Structure:
    coords, info, masses, ca_idx, bb_idx = [], [], [], [], []
    c = 0
    with open(path, "r") as fh:
        for line in fh:
            rec = line[0:6].strip()
            if rec not in ("ATOM", "HETATM"):
                continue
            try:
                at_num = int(line[6:11])
                at_name = line[12:16].strip()
                res_name = line[17:20]
                chain_id = line[21]
                res_num = int(line[22:26])
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
                elem = line[76:78].strip()
            except (ValueError, IndexError):
                continue
            info.append([at_num, at_name, res_name, chain_id, res_num, elem, rec])
            coords.append((x, y, z))
            masses.append(ATOMIC_MASS.get(elem.upper(), DEFAULT_MASS))
            if at_name == "CA":
                ca_idx.append(c)
            if at_name in ("C", "CA", "N", "O"):
                bb_idx.append(c)
            c += 1
    if not coords:
        raise ValueError(f"No atoms parsed from {path}")
    return Structure(
        coords=np.asarray(coords, dtype=np.float64),
        masses=np.asarray(masses, dtype=np.float32),
        ca_idx=np.asarray(ca_idx, dtype=np.int64),
        bb_idx=np.asarray(bb_idx, dtype=np.int64),
        info=info,
        source=path,
    )


def _atom_line(rec, serial, name, res_name, chain, res_num, xyz, elem,
               occ=1.0, bfac=0.0) -> str:
    # 4-char atom names start one column earlier (mad/PDB.py:85-90).
    if len(name) == 4:
        fmt = "%-6s%5i %-4s %3s%2s%4s    %8.3f%8.3f%8.3f%6.2f%6.2f          %-2s"
    else:
        fmt = "%-6s%5i  %-3s %3s%2s%4s    %8.3f%8.3f%8.3f%6.2f%6.2f          %-2s"
    return fmt % (rec, serial, name, res_name, chain, res_num,
                  xyz[0], xyz[1], xyz[2], occ, bfac, elem)


def write_pdb(struct: Structure, path: str) -> None:
    """Write structure in the same fixed-column layout as mad/PDB.py:80-94."""
    with open(path, "w") as fh:
        for i in range(struct.n_atoms):
            at_num, at_name, res_name, chain_id, res_num, elem, rec = struct.info[i]
            fh.write(
                _atom_line(rec, at_num, at_name, res_name, chain_id, res_num,
                           struct.coords[i], elem) + "\n"
            )


def write_complex(components: List[Structure], path: str) -> None:
    """Write a multi-chain complex, relabelling chains A, B, ...
    (parity with MaD._write_complex_from_components, mad/MaD.py:961-982)."""
    chain_ord = ord("@")
    with open(path, "w") as fh:
        for comp in components:
            for i in range(comp.n_atoms):
                at_num, at_name, res_name, _, res_num, elem, rec = comp.info[i]
                if at_num == 1:
                    chain_ord += 1
                    if chr(chain_ord) != "A":
                        fh.write("TER\n")
                fh.write(
                    _atom_line(rec, at_num, at_name, res_name, chr(chain_ord),
                               res_num, comp.coords[i], elem) + "\n"
                )


def write_pseudo_pdb(coords: np.ndarray, path: str, res_name: str = "ANC",
                     chain: str = "A", bfactors: Optional[np.ndarray] = None,
                     elem: str = "O") -> None:
    """Dump bare coordinates as dummy atoms for visualization
    (anchor/correspondence dumps, mad/MaD.py:985-1014, Detector.py:145-189)."""
    with open(path, "w") as fh:
        for i, xyz in enumerate(np.asarray(coords)):
            b = 0.0 if bfactors is None else float(bfactors[i])
            fh.write(
                _atom_line("ATOM", i + 1, elem, res_name, chain, i + 1, xyz,
                           elem, occ=1.0, bfac=b) + "\n"
            )
