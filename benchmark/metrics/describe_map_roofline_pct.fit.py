"""The least time that the map's scale space needs, as a share of the
device-busy time inside the benchmark's ``describe_map`` spans.

The numerator comes from the map's shape alone, whatever kernels
implement the work (the formulas of the port's chip_smoke.py for K1, K2
and K3): the map padded by ``map_padding``; its x2 upsample (7 flops a
half sample of each axis); the upsampled octave's presmooth (three
passes, 2 flops a tap and voxel); each octave's fused LoG (2 flops a
nonzero tap of its six order-0 and three order-2 passes, a voxel) and
its gradient field (2 flops a component). Bytes: the chain's input read
once and its outputs written once (the padded map in; each octave's LoG
volume and gradient field out, the field in bfloat16 above 250 M octave
voxels). The least time is the larger of the summed operations over the
float32 peak and the bytes over the memory bandwidth; intermediate
volumes are not counted, so fusing passes cannot lift the share past
100 %.

Peaks: one NVIDIA H100 SXM, 67 TFLOP/s float32 outside the tensor cores
and 3.35 TB/s of HBM (the data sheet, at its 700 W power limit; the result
line's ``power_limit_w`` gives the card's own).
"""

import math

import numpy as np

PEAK_F32_S = 67e12
PEAK_BYTES_S = 3.35e12
BF16_VOXELS = 250_000_000


def taps(sigma: float, truncate: float, order: int) -> int:
    """Nonzero taps of the order-0 or order-2 Gaussian (the order-2
    kernel's zero crossings fall between samples)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / sigma ** 2 * x ** 2)
    if order == 2:
        phi = phi * (x * x / sigma ** 4 - 1.0 / sigma ** 2)
    return int(np.count_nonzero(phi.astype(np.float32)))


def least_seconds(map_shape, ss: dict):
    """(seconds, "operations" or "bytes") of the map's scale space."""
    pad = int(ss["map_padding"])
    base = tuple(int(n) + 2 * pad for n in map_shape)
    V0 = int(np.prod(base))
    octaves = []
    if ss["oct_mode"] in ("up", "both"):
        octaves.append((True, tuple(2 * n - 1 for n in base)))
    if ss["oct_mode"] in ("base", "both"):
        octaves.append((False, base))
    g0 = taps(ss["detect_sigma"], ss["truncate"], 0)
    g2 = taps(ss["detect_sigma"], ss["truncate"], 2)
    ops, nbytes = 0.0, 4.0 * V0
    for up, shape in octaves:
        V = int(np.prod(shape))
        if up:
            X, Y, Z = base
            sizes = [X * Y * Z, (2 * X - 1) * Y * Z,
                     (2 * X - 1) * (2 * Y - 1) * Z, V]
            ops += sum(7 * (sizes[i + 1] - sizes[i]) for i in range(3))
            if ss["presmooth_sigma"]:
                k = taps(ss["presmooth_sigma"], ss["truncate"], 0)
                ops += 3 * 2 * k * V
        ops += 2 * (6 * g0 + 3 * g2) * V          # LoG and Gaussian
        ops += 6 * V                              # gradient field
        field = 2 if V > BF16_VOXELS else 4
        nbytes += 4 * V + 3 * field * V           # LoG and field written
    by_ops, by_bytes = ops / PEAK_F32_S, nbytes / PEAK_BYTES_S
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def read(run):
    if run.trace is None:
        return None
    busy = run.trace.busy_in("bench.describe_map")
    if busy <= 0:
        return None
    ss = run.cell.config["method"]["scalespace"]
    least = sum(least_seconds(o.map_shape, ss)[0] for o in run.jobs)
    if not math.isfinite(least) or least <= 0:
        return None
    return 100.0 * least / busy
