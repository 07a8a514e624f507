"""Copied from mad_tpu/core/eqsp_viz.py (numpy only).

Visualization emitters for the EQSP sphere partition.

Parity with the reference's shipped viz assets (mad/eqsp/show_eqsp_112.tcl,
a VMD script rendering the 112-zone sphere, and mad/eqsp/def.pdb, a dummy
one-atom anchor file). Instead of shipping a hand-made script for one zone
count, these emit the equivalent artifacts for any partition size.
"""

from __future__ import annotations

import numpy as np

from .eqsp import EQSPSphere, get_eqsp


def write_def_pdb(path: str) -> None:
    """One dummy atom at the origin (viewing anchor for VMD scenes)."""
    with open(path, "w") as fh:
        fh.write("ATOM      1  O   DEF A   1       0.000   0.000   0.000"
                 "  1.00  0.00           O\n")


def write_eqsp_tcl(path: str, size: int = 112, radius: float = 10.0,
                   n_arc: int = 12) -> None:
    """VMD TCL script drawing the zone boundaries of an EQSP sphere.

    Each zone contributes its bounding arcs (constant-phi circles between
    theta bounds and constant-theta meridian segments between phi bounds),
    drawn as chains of cylinders around the origin.
    """
    eqsp = get_eqsp(size)

    def cart(theta, phi):
        return (radius * np.sin(phi) * np.cos(theta),
                radius * np.sin(phi) * np.sin(theta),
                radius * np.cos(phi))

    lines = ["# EQSP %d-zone sphere (generated by mad_tpu)" % size,
             "draw color blue"]

    def arc(points):
        for a, b in zip(points[:-1], points[1:]):
            lines.append(
                "draw cylinder {%.3f %.3f %.3f} {%.3f %.3f %.3f} "
                "radius 0.05" % (a[0], a[1], a[2], b[0], b[1], b[2]))

    for z in range(size):
        tmin, pmin, tmax, pmax = eqsp.bounds[z]
        ts = np.linspace(tmin, tmax, n_arc)
        if pmin > 0:
            arc([cart(t, pmin) for t in ts])
        if pmax < np.pi:
            arc([cart(t, pmax) for t in ts])
        if tmax - tmin < 2 * np.pi - 1e-9:
            ps = np.linspace(pmin, pmax, n_arc)
            arc([cart(tmin, p) for p in ps])
            arc([cart(tmax, p) for p in ps])

    lines.append("draw color red")
    for c in eqsp.c_centers:
        x, y, z_ = c * radius
        lines.append("draw sphere {%.3f %.3f %.3f} radius 0.12"
                     % (x, y, z_))

    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def occupancy_ascii(counts: np.ndarray, eqsp: EQSPSphere) -> str:
    """ASCII rendering of per-zone counts belt by belt (parity:
    DensityFeature.show_occupancy, mad/DensityFeature.py:99-111)."""
    out = []
    maxb = max(len(b) for b in eqsp.belts)
    for belt in eqsp.belts:
        pad = " " * (3 * (maxb - len(belt)) // 2)
        out.append(pad + " ".join("%2d" % counts[z] for z in belt))
    return "\n".join(out)
