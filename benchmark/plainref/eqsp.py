"""Leopardi's recursive zonal equal-area sphere partition (EQSP), numpy only.

The zone tables of the orientation histogram (112 zones) and of the
descriptor's subregion histograms (16 zones), computed from the published
algorithm ("A partition of the unit sphere into regions of equal area and
small diameter", ETNA 2006) with the reference's zone layout: zone 0 the
north cap, equal theta sectors a collar offset by Leopardi's
``circle_offset``, zone N-1 the south cap. theta is the azimuth in
[0, 2 pi) (a zone's theta_max may pass 2 pi), phi the polar angle.
"""

from __future__ import annotations

import functools
import math

import numpy as np

TWO_PI = 2.0 * math.pi


def _polar_colat(n: int) -> float:
    return math.acos(1.0 - 2.0 / n)


def _circle_offset(n_top: int, n_bot: int) -> float:
    g = math.gcd(n_top, n_bot)
    return (1.0 / n_bot - 1.0 / n_top) / 2.0 + g / (2.0 * n_top * n_bot)


def _zone_counts(n: int) -> list:
    phi_c = _polar_colat(n)
    delta_i = math.sqrt(4.0 * math.pi / n)
    n_collars = max(1, round((math.pi - 2.0 * phi_c) / delta_i))
    delta_f = (math.pi - 2.0 * phi_c) / n_collars
    zone_area = 4.0 * math.pi / n
    counts, err = [], 0.0
    for j in range(n_collars):
        top = phi_c + j * delta_f
        bot = phi_c + (j + 1) * delta_f
        ideal = TWO_PI * (math.cos(top) - math.cos(bot)) / zone_area
        m = round(ideal + err)
        err += ideal - m
        counts.append(int(m))
    return counts


@functools.lru_cache(maxsize=None)
def sphere(size: int):
    """(bounds (N, 4) [theta_min, phi_min, theta_max, phi_max], centres
    (N, 2) [theta, phi], the theta centre of the first zone of each zone's
    belt (N,)), float64."""
    counts = [] if size == 2 else _zone_counts(size)
    assert sum(counts) + 2 == size
    cum = [1]
    for m in counts:
        cum.append(cum[-1] + m)
    colats = [_polar_colat(size)]
    for c in cum[1:]:
        colats.append(math.acos(max(-1.0, 1.0 - 2.0 * c / size)))
    bounds = [[0.0, 0.0, TWO_PI, colats[0]]]
    centres = [[0.0, 0.0]]
    belts = [[0]]
    offsets_rev = 0.0
    z = 1
    for j, m in enumerate(counts):
        width = TWO_PI / m
        if j > 0:
            offsets_rev += _circle_offset(counts[j - 1], m)
            offsets_rev -= math.floor(offsets_rev)
        theta0 = offsets_rev * TWO_PI
        top, bot = colats[j], colats[j + 1]
        belt = []
        for k in range(m):
            tmin = theta0 + k * width
            tmin -= TWO_PI * math.floor(tmin / TWO_PI)
            bounds.append([tmin, top, tmin + width, bot])
            tc = tmin + width / 2.0
            if tc >= TWO_PI:
                tc -= TWO_PI
            centres.append([tc, (top + bot) / 2.0])
            belt.append(z)
            z += 1
        belts.append(belt)
    bounds.append([0.0, colats[-1], TWO_PI, math.pi])
    centres.append([0.0, math.pi])
    belts.append([size - 1])
    centres = np.asarray(centres, dtype=np.float64)
    first = np.zeros(size)
    for belt in belts:
        first[belt] = centres[belt[0], 0]
    return np.asarray(bounds, dtype=np.float64), centres, first
