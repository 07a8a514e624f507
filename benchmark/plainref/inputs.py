"""The benchmark's input generators, numpy only.

Frozen copies of ``make_protein``, ``make_assembly``, ``decoy_transform``,
``deform_structure`` and ``DECOY_SCALES`` of the port's testing module
(itself a copy of mad_tpu's), so that the inputs stay what they are
whatever the program under test changes. A structure is a :class:`Mol`:
coordinates, masses, the CA indices and the atom names; the harness hands
it to the program through the program's own constructor.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List

import numpy as np

# The masses of the atoms a pseudo-protein holds (mad/PDB.py's table).
ATOMIC_MASS = {"C": 12.011, "N": 14.0067, "O": 15.9994}

# Ideal helix parameters: rise 1.5 A / residue, 100 deg twist, radius 2.3 A.
_HELIX_RISE = 1.5
_HELIX_TWIST = np.deg2rad(100.0)
_HELIX_RADIUS = 2.3

# The deformation scales (A) of the conformer screen: mad_tpu's ensemble
# ladder (the reference's GroEL conformer ladder, mad_utils.py:297).
DECOY_SCALES = (3.0, 5.0, 7.0, 9.0, 12.0, 15.0)


@dataclass
class Mol:
    coords: np.ndarray          # (N, 3) float64, Angstroms
    masses: np.ndarray          # (N,) float32
    ca_idx: np.ndarray          # (n_res,) int64
    names: List[str] = field(default_factory=list)
    source: str = ""

    def with_coords(self, coords: np.ndarray) -> "Mol":
        return replace(self, coords=np.asarray(coords, dtype=np.float64))

    def transformed(self, R, T) -> "Mol":
        """coords @ R + T."""
        return self.with_coords(self.coords @ np.asarray(R) + np.asarray(T))

    def center(self) -> np.ndarray:
        return self.coords.mean(axis=0)


def make_protein(n_res: int = 120, seed: int = 0, n_segments: int = 4
                 ) -> Mol:
    """Pseudo-protein: n_segments helical segments with random
    orientations; backbone atoms (N, CA, C, O) per residue."""
    rng = np.random.default_rng(seed)
    res_per_seg = max(4, n_res // n_segments)
    coords = []
    origin = np.zeros(3)
    for _s in range(n_segments):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        t = np.arange(res_per_seg) * _HELIX_TWIST
        z = np.arange(res_per_seg) * _HELIX_RISE
        ca = np.stack([_HELIX_RADIUS * np.cos(t),
                       _HELIX_RADIUS * np.sin(t), z], axis=-1)
        axis = np.cross([0.0, 0.0, 1.0], d)
        na = np.linalg.norm(axis)
        if na > 1e-8:
            axis = axis / na
            ang = np.arccos(np.clip(d[2], -1, 1))
            K = np.array([[0, -axis[2], axis[1]],
                          [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
        else:
            R = np.eye(3)
        ca = ca @ R.T + origin
        origin = ca[-1] + d * 3.0
        for c in ca:
            jitter = rng.normal(scale=0.3, size=(3, 3))
            coords.append(("N", c + np.array([-1.3, 0.2, -0.6]) + jitter[0]))
            coords.append(("CA", c))
            coords.append(("C", c + np.array([1.2, 0.4, 0.5]) + jitter[1]))
            coords.append(("O", c + np.array([1.6, 1.4, 0.3]) + jitter[2]))
    names = [n for n, _ in coords]
    xyz = np.array([p for _, p in coords], dtype=np.float64)
    masses = np.array([ATOMIC_MASS[n[0]] for n in names], dtype=np.float32)
    ca_idx = np.array([i for i, n in enumerate(names) if n == "CA"])
    return Mol(coords=xyz, masses=masses, ca_idx=ca_idx, names=names,
               source=f"synthetic_seed{seed}")


def make_assembly(n_copies: int = 3, n_res: int = 100, seed: int = 0,
                  spread: float = 28.0, shell: bool = False):
    """One subunit replicated at n_copies random poses -> (subunit,
    copies, poses): copies on a ring or a Fibonacci shell (shell=True);
    poses[i] = (R, t) with copy i = subunit @ R + t."""
    rng = np.random.default_rng(seed)
    sub = make_protein(n_res=n_res, seed=seed)
    sub = sub.with_coords(sub.coords - sub.center())
    copies, poses = [], []
    golden = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(n_copies):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        if shell:
            zc = 1.0 - 2.0 * (i + 0.5) / n_copies
            r = np.sqrt(max(0.0, 1.0 - zc * zc))
            ang = golden * i
            t = spread * np.array([r * np.cos(ang), r * np.sin(ang), zc])
        else:
            ang = 2 * np.pi * i / n_copies
            t = spread * np.array([np.cos(ang), np.sin(ang),
                                   0.1 * rng.normal()])
        copies.append(sub.transformed(R, t))
        poses.append((R, t))
    return sub, copies, poses


def _axis_angle_mat(axis, angle):
    """Euler-Rodrigues matrix with the reference's sign convention."""
    axis = np.asarray(axis, dtype=np.float64)
    a = np.cos(angle / 2.0)
    b, c, d = -axis * np.sin(angle / 2.0)
    return np.array([
        [a*a + b*b - c*c - d*d, 2*(b*c + a*d), 2*(b*d - a*c)],
        [2*(b*c - a*d), a*a + c*c - b*b - d*d, 2*(c*d + a*b)],
        [2*(b*d + a*c), 2*(c*d - a*b), a*a + d*d - b*b - c*c]])


def decoy_transform(mol: Mol, t=(150.0, 0.0, 0.0), a=0.375, b=1.735,
                    c=2.452) -> Mol:
    """Move a pre-fitted subunit away from its deposited pose (the
    reference's self-fit protocol, mad/structure_utils.py:30-56): turns
    about x, y and z by a, b, c, then its centre to t."""
    coords = mol.coords @ _axis_angle_mat([1.0, 0, 0], a)
    coords = coords @ _axis_angle_mat([0.0, 1, 0], b)
    coords = coords @ _axis_angle_mat([0.0, 0, 1], c)
    coords = coords - coords.mean(axis=0) + np.asarray(t)
    return mol.with_coords(coords)


def deform_structure(mol: Mol, scale: float, seed: int) -> Mol:
    """Smooth low-frequency deformation (bend-like), magnitude ~scale A:
    the decoy-conformer model of the ensemble screen."""
    rng = np.random.default_rng(seed)
    c = mol.coords - mol.center()
    ext = np.abs(c).max()
    phase = rng.uniform(0, 2 * np.pi, 3)
    disp = np.stack([
        np.sin(c[:, 1] / ext * np.pi + phase[0]),
        np.sin(c[:, 2] / ext * np.pi + phase[1]),
        np.sin(c[:, 0] / ext * np.pi + phase[2]),
    ], axis=1) * scale
    return mol.with_coords(mol.coords + disp)
