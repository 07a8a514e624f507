"""Copied from mad_tpu/core/eqsp.py (numpy only, unchanged).

Recursive zonal equal-area sphere partition (EQSP).

The reference ships Leopardi-generated lookup tables as CWD-relative text
files (``mad/eqsp/eqsp.py:16,26`` loads ``mad/eqsp/sphere_%i.txt``). Here the
partition is computed analytically at import time from Leopardi's published
algorithm ("A partition of the unit sphere into regions of equal area and
small diameter", ETNA 2006), so any zone count works and nothing depends on
the working directory.

Zone layout (matching the reference's convention):
  * zone 0                      : north polar cap, phi in [0, colat[0]]
  * zones in collar j           : equal theta sectors, offset per collar
  * zone N-1                    : south polar cap

All angles follow the reference convention: theta = azimuth in [0, 2pi)
(zone theta_max may exceed 2pi for the wrap-around zone), phi = polar angle
from +z in [0, pi].

The per-collar azimuthal offsets use Leopardi's ``circle_offset`` rule, which
reproduces the reference tables (e.g. the 0.4488 offset of the second belt of
the 16-zone sphere).
"""

from __future__ import annotations

import functools
import math

import numpy as np

TWO_PI = 2.0 * math.pi


def _polar_colat(n: int) -> float:
    """Colatitude of a polar cap with area 4*pi/n."""
    return math.acos(1.0 - 2.0 / n)


def _circle_offset(n_top: int, n_bot: int) -> float:
    """Leopardi's offset (in revolutions) between consecutive collars."""
    g = math.gcd(n_top, n_bot)
    return (1.0 / n_bot - 1.0 / n_top) / 2.0 + g / (2.0 * n_top * n_bot)


def _zone_counts(n: int) -> list[int]:
    """Number of zones per collar (caps excluded), by rounded ideal areas."""
    phi_c = _polar_colat(n)
    delta_i = math.sqrt(4.0 * math.pi / n)  # ideal collar angle
    n_collars = max(1, round((math.pi - 2.0 * phi_c) / delta_i))
    delta_f = (math.pi - 2.0 * phi_c) / n_collars
    zone_area = 4.0 * math.pi / n

    counts = []
    err = 0.0
    for j in range(n_collars):
        top = phi_c + j * delta_f
        bot = phi_c + (j + 1) * delta_f
        ideal = TWO_PI * (math.cos(top) - math.cos(bot)) / zone_area
        m = round(ideal + err)
        err += ideal - m
        counts.append(int(m))
    return counts


class EQSPSphere:
    """Equal-area sphere partition with vectorized zone lookup.

    Attributes
    ----------
    size : int                      total number of zones
    bounds : (N, 4) float64         [theta_min, phi_min, theta_max, phi_max]
    p_centers : (N, 2) float64      [theta, phi] midpoints of each zone
    c_centers : (N, 3) float64      cartesian unit vectors of the centers
    belts : list[list[int]]         zone indices grouped per belt (caps = own belt)
    belt_of_zone : (N,) int32       belt index of each zone
    belt_first_theta : (N,) float64 theta center of the first zone in the
                                    zone's belt (used by the secondary-
                                    orientation alignment step)
    """

    def __init__(self, size: int = 112):
        if size < 2:
            raise ValueError("EQSP needs at least 2 zones")
        self.size = size

        if size == 2:
            counts = []
        else:
            counts = _zone_counts(size)
        assert sum(counts) + 2 == size, (
            f"EQSP zone counts {counts} inconsistent with size {size}"
        )

        # Cap colatitudes from cumulative zone counts (areas stay exact).
        cum = [1]
        for m in counts:
            cum.append(cum[-1] + m)
        colats = [_polar_colat(size)]  # after the north cap
        for c in cum[1:]:
            colats.append(math.acos(max(-1.0, 1.0 - 2.0 * c / size)))
        # colats has n_collars+1 entries; the last equals pi - polar cap colat.

        bounds = [[0.0, 0.0, TWO_PI, colats[0]]]
        p_centers = [[0.0, 0.0]]
        belts: list[list[int]] = [[0]]
        offsets_rev = 0.0
        zidx = 1
        for j, m in enumerate(counts):
            width = TWO_PI / m
            if j > 0:
                offsets_rev += _circle_offset(counts[j - 1], m)
                offsets_rev -= math.floor(offsets_rev)
            theta0 = offsets_rev * TWO_PI
            phi_top, phi_bot = colats[j], colats[j + 1]
            belt = []
            for k in range(m):
                tmin = theta0 + k * width
                tmin -= TWO_PI * math.floor(tmin / TWO_PI)
                bounds.append([tmin, phi_top, tmin + width, phi_bot])
                tc = tmin + width / 2.0
                if tc >= TWO_PI:
                    tc -= TWO_PI
                p_centers.append([tc, (phi_top + phi_bot) / 2.0])
                belt.append(zidx)
                zidx += 1
            belts.append(belt)
        bounds.append([0.0, colats[-1], TWO_PI, math.pi])
        p_centers.append([0.0, math.pi])
        belts.append([size - 1])

        self.bounds = np.asarray(bounds, dtype=np.float64)
        self.p_centers = np.asarray(p_centers, dtype=np.float64)
        th, ph = self.p_centers[:, 0], self.p_centers[:, 1]
        self.c_centers = np.stack(
            [np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th), np.cos(ph)],
            axis=-1,
        )
        self.belts = belts
        self.belt_of_zone = np.zeros(size, dtype=np.int32)
        for b, zs in enumerate(belts):
            for z in zs:
                self.belt_of_zone[z] = b
        self.belt_first_theta = np.asarray(
            [self.p_centers[belts[self.belt_of_zone[z]][0], 0] for z in range(size)],
            dtype=np.float64,
        )

        # Lookup tables for vectorized zone assignment.
        # colat_edges[b] = phi at the bottom of belt b (belt = searchsorted).
        self._colat_edges = np.asarray(colats + [math.pi], dtype=np.float64)
        # Per belt: first zone index, zone count, theta offset of first zone.
        nbelts = len(belts)
        self._belt_start = np.zeros(nbelts, dtype=np.int32)
        self._belt_count = np.zeros(nbelts, dtype=np.int32)
        self._belt_theta0 = np.zeros(nbelts, dtype=np.float64)
        for b, zs in enumerate(belts):
            self._belt_start[b] = zs[0]
            self._belt_count[b] = len(zs)
            self._belt_theta0[b] = self.bounds[zs[0], 0]

        # Mean nearest-neighbor distance between centers * 0.1 (parity with
        # the reference's feature_dist_thresh, mad/eqsp/eqsp.py:62-64).
        d = np.linalg.norm(
            self.c_centers[:, None, :] - self.c_centers[None, :, :], axis=-1
        )
        np.fill_diagonal(d, np.inf)
        self.feature_dist_thresh = float(np.mean(np.min(d, axis=1)) * 0.1)

    # -- lookup -----------------------------------------------------------

    def zone_lookup_tables(self):
        """Arrays consumed by the jitted zone-assignment kernel.

        Returns (colat_edges, belt_start, belt_count, belt_theta0).
        """
        return (
            self._colat_edges.astype(np.float32),
            self._belt_start,
            self._belt_count,
            self._belt_theta0.astype(np.float32),
        )

    def zone_of(self, theta: np.ndarray, phi: np.ndarray) -> np.ndarray:
        """Numpy zone assignment (host-side mirror of the jitted kernel)."""
        belt = np.searchsorted(self._colat_edges[:-1], phi, side="right")
        belt = np.clip(belt, 0, len(self.belts) - 1)
        width = TWO_PI / self._belt_count[belt]
        rel = (theta - self._belt_theta0[belt]) / width
        k = np.floor(rel - np.floor(rel / self._belt_count[belt]) * self._belt_count[belt])
        k = np.clip(k.astype(np.int64), 0, self._belt_count[belt] - 1)
        return (self._belt_start[belt] + k).astype(np.int32)

    def zone_of_vectors(self, vecs: np.ndarray) -> np.ndarray:
        """Zone of each unit vector in (..., 3)."""
        theta = np.arctan2(vecs[..., 1], vecs[..., 0])
        theta = np.where(theta < 0, theta + TWO_PI, theta)
        phi = np.arccos(np.clip(vecs[..., 2], -1.0, 1.0))
        return self.zone_of(theta, phi)

    def zone_area(self) -> float:
        return 4.0 * math.pi / self.size


@functools.lru_cache(maxsize=16)
def get_eqsp(size: int) -> EQSPSphere:
    return EQSPSphere(size)
