"""K2 (x2 upsample) and K3 (gradient field) on the CPU: the gradient
field's real edge against mad_tpu, and renderings of the two kernels'
tilings.

* The field, edge included: without mad_tpu's compile bucket
  (``iter_lazy_octaves(..., shape_bucket=1)``, no padding added) the
  port's octave fields equal mad_tpu's everywhere, the last real voxel
  included, within test_torch_simulate_scalespace.py's tolerance (1e-5 of
  the field's max), on a random smooth map with ``map_padding`` 0 whose
  density reaches every face.
* The edge at mad_tpu's default bucket of 32: there ``jnp.gradient`` at
  the last real voxel reads the bucket's padding (and the upsample's
  outer tap a zero), where the port takes a one-sided difference (and
  replicates the edge). At the default ``map_padding`` 9, mad_tpu's
  ``describe_grid`` at bucket 32 equals its own run at bucket 1 bit for
  bit, so the edge moves nothing; at ``map_padding`` 0 it does not (an
  orientation and descriptor rows move), and the port equals the
  bucket-1 run: the same anchors and orientation frames (within 1e-6).
  A few descriptor rows differ from mad_tpu's all the same, as many at
  bucket 1 as at 32; their counts and largest L1 are recorded, and each
  is explained: its L1 is within K7's standing tolerance plus 2 for each
  of its samples on a nearest-neighbour .5 tie, as it is and with the
  port given mad_tpu's own field and frame; a row further off has
  samples that the two frames, a float32 bit or two apart (XLA's and
  PyTorch's float32 cos / sin differ in the last bit on some secondary
  bins, and the frame's product may round otherwise), send to different
  voxels, each on a tie; and no row differs without a sample on a tie.
  A second map (seed 4) is the witness.
  The case at ``patch_size`` 24 is in the slow tier: mad_tpu's describe
  takes ~100 s of it on the CPU.
* ``upsample2`` (its plain version, on the CPU) against mad_tpu's
  ``upsample2`` on axes of 1, 2 and 3 samples, within 1e-5 of the max
  (mad_tpu may take a banded matrix product, which rounds otherwise).
* Renderings of ``csrc/upsample.cu`` (input tiles of ``upsample.TILE``
  cells with the taps' halo, clamped at the faces; the x, y and z passes
  on the tile; the ragged last tile cut) and of ``csrc/gradient.cu`` (a
  ``gradient.FOOTPRINT`` of (y, z) columns marching ``gradient.CHUNK``
  planes along x with a ring of ``gradient.RING`` planes with their
  y / z halo, cells
  outside the volume never loaded, records staged a row at a time) equal
  the plain versions bit for bit on ragged shapes, so the kernels' index
  arithmetic is checked here, where no kernel runs. Cells the renderings
  never write or never load are NaN, so a missed output or a read of an
  unloaded cell shows. Both tilings are read from the sources'
  ``constexpr`` values (``build.constants``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.core.grid import DensityGrid as JGrid
from mad_tpu.engine import pipeline as jpipe
from mad_tpu.ops import convolve as jcv
from mad_tpu.ops import scalespace as jss
from mad_tpu_torch.convert import grid_from_numpy
from mad_tpu_torch.core.geometry import rows_times
from mad_tpu_torch.core.config import MadConfig as TConfig
from mad_tpu_torch.engine import pipeline as tpipe
from mad_tpu_torch.kernels import gradient as k3
from mad_tpu_torch.kernels import upsample as k2
from mad_tpu_torch.ops import describe as tdsc
from mad_tpu_torch.ops import scalespace as tss

torch.set_num_threads(1)

REL = 1e-5
FRAME_TOL = 1e-6
ROW_L1 = 8          # K7's standing tolerance (test_torch_orient_describe)
VOXSP = 1.4


def smooth_map(shape, seed):
    """Random density smoothed with wrap-around, in [0, 1]: it reaches
    every face."""
    rng = np.random.default_rng(seed)
    v = gaussian_filter(rng.random(shape), 1.5, mode="wrap")
    return ((v - v.min()) / (v.max() - v.min())).astype(np.float32)


def configs(pad, patch):
    out = []
    for C in (JConfig, TConfig):
        c = C()
        out.append(c.replace(
            scalespace=dataclasses.replace(c.scalespace, map_padding=pad),
            orient=dataclasses.replace(c.orient, patch_size=patch),
            describe=dataclasses.replace(c.describe, patch_size=patch),
            detect=dataclasses.replace(c.detect, max_anchors=1024)))
    return out


def test_field_matches_mad_tpu_without_the_bucket():
    vol = smooth_map((21, 18, 23), 0)
    jcfg, tcfg = configs(0, 16)
    jo = list(jss.iter_lazy_octaves(JGrid(vol, np.zeros(3), VOXSP),
                                    jcfg.scalespace, 1))
    to = list(tss.iter_octaves(grid_from_numpy(vol, np.zeros(3), VOXSP,
                                               device="cpu"),
                               tcfg.scalespace))
    assert len(jo) == len(to) == 2
    for (_jorg, j), (_torg, t) in zip(jo, to):
        ref = np.asarray(j.grad())
        _log, gauss = t.log_gauss()
        got = tss.gradient(gauss, t.grad_dtype()).numpy()
        assert got.shape == ref.shape == t.real_shape + (3,)
        scale = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        assert err <= REL * scale
        # the last real voxel of every axis, where a bucket would pad
        edge = max(float(np.abs(np.take(got, -1, axis=a)
                                - np.take(ref, -1, axis=a)).max())
                   for a in range(3))
        assert edge <= REL * scale
        print(f"octave {t.real_shape}: the field within {err:.3g} of "
              f"mad_tpu's, on the last real voxels {edge:.3g}; its max "
              f"{scale:.3g}")


def _rows(ds):
    """(octave, anchor voxel, main bin, secondary bin) of each row -> its
    frame and descriptor."""
    n = ds.n
    keys = zip(np.asarray(ds.octave)[:n], np.asarray(ds.coords)[:n],
               np.asarray(ds.main_bin)[:n], np.asarray(ds.sec_bin)[:n])
    desc = np.asarray(ds.desc)[:n].astype(np.int64)
    rfinal = np.asarray(ds.rfinal)[:n]
    return {(int(o), tuple(c.tolist()), int(m), int(s)): (rfinal[i], desc[i])
            for i, (o, c, m, s) in enumerate(keys)}


def _same_set(a, b):
    fields = ("coords", "rfinal", "desc", "octave", "main_bin", "sec_bin")
    return a.n == b.n and all(
        np.array_equal(np.asarray(getattr(a, f))[:a.n],
                       np.asarray(getattr(b, f))[:b.n]) for f in fields)


def _ties(lat, coord, frames):
    """Which samples of the lattice ``lat`` at ``coord`` may land on
    either side of a nearest-neighbour .5 tie under ``frames`` (one, or
    two that differ in their last bits): in float64, the tie lies within
    the frames' positions of each other plus the rounding that any order
    of float32 products and sums can add, twice over (two libraries).
    Returns (P,) bool."""
    lat = lat.astype(np.float64)
    p = [lat @ f.astype(np.float64) + coord for f in frames]
    terms = np.abs(lat) @ np.abs(frames[0]).astype(np.float64) + abs(coord)
    reach = np.abs(p[0] - p[-1]) + 2 * 6 * 2.0 ** -24 * terms
    return (np.abs(p[0] - (np.floor(p[0]) + 0.5)) <= reach).any(axis=1)


def _explain(vol, jcfg, tcfg, port, ref):
    """Why the rows of ``port`` and ``ref`` (mad_tpu at bucket 1) differ.

    A sample sent to another voxel moves one count from a bin to another,
    2 of L1. So each unequal row must be within K7's standing tolerance
    (test_torch_orient_describe.py: L1 <= 8) plus 2 for each of its
    samples on a .5 tie, both as it is and with the port's
    ``describe_anchors`` given mad_tpu's own field and frame (ties of the
    sum's rounding alone, the frames being equal); whatever the last bits
    of the field do stays within the tolerance. A row beyond the
    tolerance must have samples the port's arithmetic sends to different
    voxels under the two frames, each on a tie. Every unequal row must
    have a sample on a tie. Returns the number of samples so sent and
    each unequal row's samples on a tie."""
    octaves = [(torch.tensor(np.array(o.grad())),
                tuple(o.real_shape), o.voxsp < VOXSP)
               for _org, o in jss.iter_lazy_octaves(
                   JGrid(vol, np.zeros(3), VOXSP), jcfg.scalespace, 1)]
    radius = tcfg.describe.patch_size // 2
    moved, ties = 0, []
    for key, (frame, desc) in port.items():
        rframe, rdesc = ref[key]
        if np.array_equal(desc, rdesc):
            continue
        grad, real, up = octaves[key[0]]
        coord = np.asarray(key[1], np.float32)
        lat = tdsc.descriptor_lattice(radius, up)
        got, ok = tdsc.describe_anchors(
            grad, torch.from_numpy(coord[None]), torch.tensor(rframe[None]),
            torch.ones(1, dtype=torch.bool), real, up, tcfg.describe)
        assert bool(ok[0])
        same = np.abs(got[0].numpy().astype(np.int64) - rdesc).sum()
        assert same <= ROW_L1 + 2 * _ties(lat, coord, [rframe]).sum(), key
        l1 = np.abs(desc - rdesc).sum()
        ties.append(int(_ties(lat, coord, [rframe, frame]).sum()))
        assert 0 < ties[-1] and l1 <= ROW_L1 + 2 * ties[-1], key
        if l1 <= ROW_L1:
            continue
        ids = [torch.ceil(rows_times(torch.from_numpy(lat)[None],
                                     torch.from_numpy(r)[None])[0]
                          + torch.from_numpy(coord) - 0.5).numpy()
               for r in (frame, rframe)]
        where = (ids[0] != ids[1]).any(axis=1)
        assert where.any() and _ties(lat, coord, [rframe, frame])[where] \
            .all(), key
        moved += int(where.sum())
    return moved, ties


# (map_padding, patch_size, map seed, map shape) -> per bucket, the rows
# unequal to the port's and their largest L1 (recorded on the CPU);
# seed 4 is a second map, the first one's witness.
EDGE = {(9, 16, 1, (33, 30, 37)): {32: (5, 30), 1: (5, 30)},
        (9, 24, 1, (33, 30, 37)): {32: (7, 16), 1: (7, 16)},
        (0, 16, 1, (33, 30, 37)): {32: (17, 146), 1: (1, 2)},
        (9, 16, 4, (29, 35, 31)): {32: (9, 14), 1: (9, 14)}}


@pytest.mark.parametrize("case", [
    pytest.param(c, marks=pytest.mark.slow) if c[1] == 24 else c
    for c in EDGE], ids=lambda c: "pad%d-patch%d-seed%d" % c[:3])
def test_edge_at_the_default_bucket(case):
    pad, patch, seed, shape = case
    vol = smooth_map(shape, seed)
    jcfg, tcfg = configs(pad, patch)
    port = _rows(tpipe.describe_grid(
        grid_from_numpy(vol, np.zeros(3), VOXSP, name="m", device="cpu"),
        tcfg, name="m"))
    runs = {b: jpipe.describe_grid(JGrid(vol, np.zeros(3), VOXSP, name="m"),
                                   jcfg.replace(shape_bucket=b), name="m")
            for b in (32, 1)}
    assert _same_set(runs[32], runs[1]) == (pad == 9)
    bucket1, bucket32 = _rows(runs[1]), _rows(runs[32])
    assert len(port) > 30 and set(port) == set(bucket1)
    frames = max(float(np.abs(frame - bucket1[key][0]).max())
                 for key, (frame, _desc) in port.items())
    assert frames <= FRAME_TOL
    if pad == 0:    # the bucket's padding moves rows the port keeps
        assert set(bucket32) != set(port)
    unequal = {}
    for b, rows in ((32, bucket32), (1, bucket1)):
        l1 = [int(np.abs(rows[k][1] - port[k][1]).sum())
              for k in set(rows) & set(port)]
        unequal[b] = (sum(d > 0 for d in l1), max(l1))
    moved, ties = _explain(vol, jcfg, tcfg, port, bucket1)
    print(f"map_padding {pad}, patch {patch}, seed {seed}: the port "
          f"{len(port)} rows; mad_tpu at bucket 32 {len(bucket32)} rows, "
          f"{len(set(bucket32) ^ set(port))} frames on one side only; "
          f"(rows unequal, largest L1) at bucket 32 {unequal[32]}, at "
          f"bucket 1 {unequal[1]}; frames within {frames:.3g}; samples on "
          f"a .5 tie in each unequal row {sorted(ties)}, moved by the "
          f"frames' last bits {moved}")
    assert unequal == EDGE[case]


def test_upsample2_matches_mad_tpu_on_short_axes():
    rng = np.random.default_rng(5)
    for shape in ((1, 2, 3), (3, 1, 2), (2, 3, 1), (1, 1, 1), (3, 2, 5)):
        vol = rng.normal(size=shape).astype(np.float32)
        got = k2.upsample2(torch.as_tensor(vol)).numpy()
        ref = np.asarray(jcv.upsample2(vol))
        assert got.shape == ref.shape == tuple(2 * n - 1 for n in shape)
        assert np.abs(got - ref).max() <= REL * np.abs(ref).max()
        np.testing.assert_array_equal(got[::2, ::2, ::2], vol)


def upsample_tiles(vol):
    """csrc/upsample.cu's blocks in numpy: each block's input tile (one
    cell before, two after, clamped to the volume), the x, y and z passes
    over it in the per-axis rounding order, and its outputs cut to the
    volume's; unwritten outputs stay NaN."""
    TX, TY, TZ = k2.TILE
    X, Y, Z = vol.shape
    edge, inner = k2.CR_HALF[0], k2.CR_HALF[1]
    out = np.full((2 * X - 1, 2 * Y - 1, 2 * Z - 1), np.nan, np.float32)

    def up(s, n_out, axis):
        o = np.arange(n_out)
        tap = lambda m: np.take(s, (o >> 1) + m, axis=axis)
        acc = tap(0) * edge
        acc = acc + tap(1) * inner
        acc = acc + tap(2) * inner
        acc = acc + tap(3) * edge
        even = [slice(None)] * 3
        even[axis] = slice(0, None, 2)
        acc[tuple(even)] = tap(1)[tuple(even)]
        return acc

    for i0 in range(0, X, TX):
        for j0 in range(0, Y, TY):
            for k0 in range(0, Z, TZ):
                cells = [np.clip(np.arange(s - 1, s + t + 2), 0, n - 1)
                         for s, t, n in ((i0, TX, X), (j0, TY, Y),
                                         (k0, TZ, Z))]
                tile = vol[np.ix_(*cells)]
                tile = up(up(up(tile, 2 * TX, 0), 2 * TY, 1), 2 * TZ, 2)
                nx = min(2 * TX, 2 * X - 1 - 2 * i0)
                ny = min(2 * TY, 2 * Y - 1 - 2 * j0)
                nz = min(2 * TZ, 2 * Z - 1 - 2 * k0)
                out[2 * i0:2 * i0 + nx, 2 * j0:2 * j0 + ny,
                    2 * k0:2 * k0 + nz] = tile[:nx, :ny, :nz]
    return out


def gradient_march(vol):
    """csrc/gradient.cu's blocks in numpy, float32: each block's footprint
    marching along its chunk of planes, a ring of ``RING`` planes (slot
    (x - x0 + 1) mod RING) with their y / z halo, loaded only inside the
    volume (NaN elsewhere, as memory never written), ``AHEAD`` planes past
    x + 1 loaded before plane x is used and none past the chunk's end,
    each component one-sided on the volume's faces; unwritten outputs stay
    NaN."""
    TY, TZ = k3.FOOTPRINT
    X, Y, Z = vol.shape
    out = np.full((X, Y, Z, 3), np.nan, np.float32)

    def diff(lo, mid, hi, i, n):
        return np.where(i == 0, hi - mid, np.where(
            i == n - 1, mid - lo, (hi - lo) * np.float32(0.5)))

    for z0 in range(0, Z, TZ):
        for y0 in range(0, Y, TY):
            for x0 in range(0, X, k3.CHUNK):
                x1 = min(x0 + k3.CHUNK, X)
                ring = [np.full((TY + 2, TZ + 2), np.nan, np.float32)
                        for _ in range(k3.RING)]
                slot = lambda x: (x - x0 + 1) % k3.RING

                def load(x):
                    if 0 <= x < X:
                        ys = slice(max(y0 - 1, 0), min(y0 + TY + 1, Y))
                        zs = slice(max(z0 - 1, 0), min(z0 + TZ + 1, Z))
                        r0, c0 = ys.start - (y0 - 1), zs.start - (z0 - 1)
                        plane = vol[x, ys, zs]
                        ring[slot(x)][r0:r0 + plane.shape[0],
                                      c0:c0 + plane.shape[1]] = plane

                for x in range(x0 - 1, min(x0 + 2 + k3.AHEAD, x1 + 1)):
                    load(x)
                y = np.arange(y0, y0 + TY)[:, None]
                z = np.arange(z0, z0 + TZ)[None, :]
                ny, nz = min(TY, Y - y0), min(TZ, Z - z0)
                for x in range(x0, x1):
                    if x > x0 and x + 1 + k3.AHEAD <= x1:
                        load(x + 1 + k3.AHEAD)
                    c = ring[slot(x)]
                    mid = c[1:-1, 1:-1]
                    rec = np.stack([
                        diff(ring[slot(x - 1)][1:-1, 1:-1], mid,
                             ring[slot(x + 1)][1:-1, 1:-1], x, X),
                        diff(c[:-2, 1:-1], mid, c[2:, 1:-1], y, Y),
                        diff(c[1:-1, :-2], mid, c[1:-1, 2:], z, Z)], -1)
                    out[x, y0:y0 + ny, z0:z0 + nz] = rec[:ny, :nz]
    return out


def test_upsample_tiles_are_the_plain_version():
    rng = np.random.default_rng(9)
    for shape in ((9, 17, 35), (5, 9, 67), (1, 2, 3), (3, 1, 2), (2, 3, 1),
                  (8, 16, 64)):
        vol = rng.normal(size=shape).astype(np.float32)
        got = torch.from_numpy(upsample_tiles(vol))
        ref = k2.upsample2_plain(torch.from_numpy(vol))
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_gradient_march_is_the_plain_version():
    rng = np.random.default_rng(11)
    for shape in ((2, 2, 2), (35, 10, 37), (33, 9, 65), (3, 17, 33),
                  (64, 8, 32), (65, 2, 3)):
        vol = rng.normal(size=shape).astype(np.float32)
        got = torch.from_numpy(gradient_march(vol))
        t = torch.from_numpy(vol)
        ref = k3.gradient_plain(t)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        ref16 = k3.gradient_plain(t, torch.bfloat16)
        assert torch.equal(got.to(torch.bfloat16).view(torch.int16),
                           ref16.view(torch.int16))
