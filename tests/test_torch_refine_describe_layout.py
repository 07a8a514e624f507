"""The host-side pieces of K7's and K15's card designs, held on the CPU.

K7 (mad_tpu_torch/csrc/describe.cu) walks the lattice region by region
(kernels/describe.region_layout), builds each lattice coordinate from its
index (kernels/describe.lattice_from_index) and tests a lane's bounds on
the lattice's 8 corners only (kernels/describe.corners_in_bounds). K15
(mad_tpu_torch/csrc/refine.cu) makes one pass over the atoms a step: pass
s gathers for step s at the coordinates step s - 1 moved to, and with
them settles step s - 1 (finiteness, the checkpoint's displacement and
halving, the freeze). Required:
  * the rows that kernels/describe.descriptor_hist_plain computes from
    the region-major, index-built lattice equal, bit for bit, its rows
    from ops/describe's lattice, and mad_tpu's _describe_body rows within
    K7's standing tolerance (>= 99 % of rows equal, L1 <= 8), at 64
    subregions on the base octave and 27 on the upsampled one;
  * the layout lists each lattice point once, in its region's segment;
  * the corner test equals the test over every point, bit for bit, on
    random frames, on lanes whose corners land exactly on 0 and on
    real_shape - 1, and on frames holding NaN or inf;
  * the index-built lattice equals descriptor_lattice (the port's and
    mad_tpu's) bit for bit, both octaves, patch_size 16 and 24;
  * K15's one-pass order of decisions, written with the plain version's
    operations, gives refine_loop_plain's six outputs bit for bit, at
    n_steps not a multiple of batch_size, with a failing (NaN) and a
    never-freezing candidate.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.ops import describe as jdsc
from mad_tpu_torch.core.config import MadConfig as TConfig, RefineConfig
from mad_tpu_torch.core.eqsp import get_eqsp
from mad_tpu_torch.core.geometry import axis_angle_mat, norm3, rows_times, unit
from mad_tpu_torch.kernels import describe as k7
from mad_tpu_torch.kernels import refine as k15
from mad_tpu_torch.ops.describe import descriptor_lattice, region_ids
from mad_tpu_torch.ops.interp import trilinear
from mad_tpu_torch.ops.orient import ref_zone_bounds

torch.set_num_threads(1)

ROWS_EQUAL = 0.99
ROW_L1 = 8


def smooth_field(shape, seed):
    """A smooth (X, Y, Z, 3) float32 gradient-like field: a few random
    plane waves a component."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64)
                                  for s in shape], indexing="ij"), -1)
    out = np.zeros(tuple(shape) + (3,))
    for c in range(3):
        for _ in range(4):
            k = rng.normal(scale=0.25, size=3)
            out[..., c] += rng.normal() * np.sin(grid @ k + rng.uniform(0, 6))
    return out.astype(np.float32)


def rotations(n, rng):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    return q.astype(np.float32)


@pytest.mark.parametrize("subregions,upsampled", [(64, False), (27, True)])
def test_region_major_rows(subregions, upsampled):
    shape = (58, 56, 60) if upsampled else (34, 32, 35)
    grad = smooth_field(shape, seed=subregions)
    rng = np.random.default_rng(7)
    D = 32
    reach = 27 if upsampled else 14       # the rotated lattice's radius
    coords = np.stack([rng.integers(reach, s - reach, D) for s in shape],
                      -1).astype(np.int32)
    coords[:3] = [[2, 15, 15], [shape[0] - 3, 14, 14], [20, 1, 20]]
    rfin = rotations(D, rng)
    rfin[5] = np.eye(3, dtype=np.float32)         # samples on .5 ties
    valid = np.ones(D, bool)
    valid[6] = False
    dcfg = dataclasses.replace(TConfig().describe, subregions=subregions)
    jcfg = dataclasses.replace(JConfig().describe, subregions=subregions)
    radius = dcfg.patch_size // 2
    n = 2 * radius
    regions = region_ids(radius, subregions)
    packed, start = k7.region_layout(regions, n, subregions)
    lattice = k7.lattice_from_index(packed, n, upsampled)
    regions_of = np.repeat(np.arange(subregions), np.diff(start))
    bounds = ref_zone_bounds(get_eqsp(dcfg.subeqsp_size))
    args = (torch.tensor(grad), torch.tensor(coords), torch.tensor(rfin),
            torch.tensor(valid), shape)
    tail = (bounds, subregions, dcfg.cutoff_magn, dcfg.zero_magn)
    d_perm, ok_perm = k7.descriptor_hist_plain(*args, lattice, regions_of,
                                               *tail)
    d_idx, ok_idx = k7.descriptor_hist_plain(
        *args, descriptor_lattice(radius, upsampled), regions, *tail)
    assert torch.equal(d_perm, d_idx) and torch.equal(ok_perm, ok_idx)
    dj, okj = jdsc.describe_anchors(jnp.asarray(grad), jnp.asarray(coords),
                                    jnp.asarray(rfin), jnp.asarray(valid),
                                    shape, upsampled, jcfg, chunk=D)
    dj, okj = np.asarray(dj), np.asarray(okj)
    np.testing.assert_array_equal(ok_perm.numpy(), okj)
    assert 20 <= okj.sum() < D                    # the edge lanes fail
    l1 = np.abs(d_perm.numpy().astype(np.int64) - dj).sum(axis=1)
    assert (l1 == 0).mean() >= ROWS_EQUAL and l1.max() <= ROW_L1


def test_layout_lists_each_point_once():
    for patch in (16, 24):
        radius = patch // 2
        n = 2 * radius
        for subregions in (64, 27, 8, 1):
            regions = region_ids(radius, subregions)
            packed, start = k7.region_layout(regions, n, subregions)
            assert packed.dtype == np.int32 and start.dtype == np.int32
            assert start[0] == 0 and start[-1] == n ** 3
            assert np.all(np.diff(start) > 0)
            ix, iy, iz = packed & 0xFF, (packed >> 8) & 0xFF, packed >> 16
            index = (ix * n + iy) * n + iz
            np.testing.assert_array_equal(np.sort(index), np.arange(n ** 3))
            np.testing.assert_array_equal(
                regions[index],
                np.repeat(np.arange(subregions), np.diff(start)))
            # within a region, the lattice's index order (a stable sort)
            for r in range(subregions):
                assert np.all(np.diff(index[start[r]:start[r + 1]]) > 0)


def test_corner_bounds_equal_every_point():
    rng = np.random.default_rng(11)
    for upsampled in (False, True):
        radius = 8
        real = (96, 90, 100) if upsampled else (40, 37, 45)
        n = 2 * radius
        lat = torch.tensor(descriptor_lattice(radius, upsampled))
        lo, hi = float(lat.min()), float(lat.max())
        L = 400
        coords = (rng.uniform(0.1, 0.9, (L, 3)) * real).astype(np.float32)
        rfin = rotations(L, rng)
        rfin[:40] = rng.normal(size=(40, 3, 3))       # not rotations
        eye = np.eye(3, dtype=np.float32)
        # corners exactly on 0 and on real - 1, and the nearest coords
        # that put them past (float32 sums)
        f32 = np.float32

        def past(c, corner, step):
            while f32(c) + f32(corner) == f32(c0 + corner):
                c = np.nextafter(f32(c), f32(step))
            return c

        for j in range(3):
            for m, c0 in enumerate((-lo, real[j] - 1 - hi)):
                i = 40 + 4 * j + 2 * m
                coords[i:i + 2] = 20.0
                coords[i, j] = c0
                coords[i + 1, j] = past(c0, (lo, hi)[m], (-99, 99)[m])
                rfin[i:i + 2] = eye
        # non-finite frames and coords
        rfin[60, 0, 0] = np.nan
        rfin[61, 1, 2] = np.inf
        rfin[62, 2, 1] = -np.inf
        rfin[63, 0] = [np.inf, -np.inf, 0.0]
        coords[64, 1] = np.nan
        rfin[65] = eye * np.float32(3e38)              # overflows
        coords_t, rfin_t = torch.tensor(coords), torch.tensor(rfin)
        pts = (rows_times(lat[None].expand(L, -1, -1), rfin_t)
               + coords_t[:, None, :])
        top = torch.tensor(real, dtype=torch.float32) - 1
        every = ((pts >= 0) & (pts <= top)).all(dim=-1).all(dim=-1)
        got = k7.corners_in_bounds(coords_t, rfin_t, real, n, upsampled)
        assert torch.equal(got, every)
        assert 40 < int(every.sum()) < L - 40
        assert got[40:52].tolist() == [True, False, True, False] * 3
        assert not got[60:66].any()


def test_index_lattice_is_descriptor_lattice():
    for patch in (16, 24):
        radius = patch // 2
        n = 2 * radius
        index = k7.pack(np.arange(n ** 3), n)
        for upsampled in (False, True):
            got = k7.lattice_from_index(index, n, upsampled)
            for ref in (descriptor_lattice(radius, upsampled),
                        np.asarray(jdsc.descriptor_lattice(radius,
                                                           upsampled))):
                assert got.dtype == ref.dtype == np.float32
                np.testing.assert_array_equal(got.view(np.int32),
                                              ref.view(np.int32))


def one_pass_order(field, y0, center, angle_den, bounds, cfg):
    """refine_loop_plain's steps in K15's order: pass s takes the
    coordinates step s - 1 moved to, settles step s - 1 with them, then
    (s < n_steps) makes step s; a frozen candidate stops."""
    C = y0.shape[0]
    origin, hi_bound, voxsp = bounds[0:3], bounds[3:6], bounds[6]
    arm = y0 - center
    trans = torch.zeros((C, 3), dtype=torch.float32)
    rot = torch.eye(3, dtype=torch.float32).repeat(C, 1, 1)
    step_size = torch.full((C,), float(cfg.max_step), dtype=torch.float32)
    prev = y0.clone()
    frozen = torch.zeros(C, dtype=torch.bool)
    failed = torch.zeros(C, dtype=torch.bool)
    counts = torch.zeros(C, dtype=torch.int32)
    for s in range(cfg.n_steps + 1):
        coords = arm @ rot + center + trans[:, None]
        upd = ~frozen
        if s > 0:
            if s % cfg.batch_size == 0:
                disp = norm3(prev - coords).amax(dim=1)
                step_size = torch.where((disp < step_size) & upd,
                                        step_size * 0.5, step_size)
                prev = torch.where(upd[:, None, None], coords, prev)
            failed = failed | ~(torch.isfinite(coords).all(dim=2).all(dim=1)
                                & torch.isfinite(trans).all(dim=1))
            counts += upd.to(torch.int32)
            frozen = frozen | (step_size < cfg.min_step) | failed
            upd = ~frozen
        if s == cfg.n_steps:
            break
        inb = ((coords > origin) & (coords < hi_bound)).all(dim=-1)
        g = trilinear(field, (coords - origin) / voxsp) * inb.to(
            coords.dtype)[..., None]
        if s % 2 == 0:
            trans = torch.where(upd[:, None],
                                trans + unit(g.sum(dim=1))
                                * step_size[:, None], trans)
        else:
            torque = unit(torch.linalg.cross(g, coords - center,
                                             dim=-1).sum(dim=1))
            rot = torch.where(upd[:, None, None],
                              rot @ axis_angle_mat(torque,
                                                   step_size / angle_den),
                              rot)
    coords = arm @ rot + center + trans[:, None]
    return rot, trans, coords, frozen, counts, failed


@pytest.mark.parametrize("n_steps,min_step", [(37, 0.1), (22, 0.0)])
def test_one_pass_order_is_the_plain_loop(n_steps, min_step):
    shape, voxsp = (26, 24, 28), 1.5
    field = torch.tensor(smooth_field(shape, seed=5))
    rng = np.random.default_rng(9)
    C, N = 6, 300                      # N not a multiple of 256
    base = rng.normal(scale=5.0, size=(N, 3))
    mid = (np.array(shape) - 1) * voxsp / 2
    y0 = np.stack([base @ rotations(1, rng)[0] + mid + rng.normal(size=3)
                   for _ in range(C)]).astype(np.float32)
    y0[3] += 40.0                      # outside the map: no force
    y0[4, 17] = np.nan                 # fails at once
    y0 = torch.tensor(y0)
    center = torch.nanmean(y0, dim=1, keepdim=True)
    center[4] = center[0]
    angle_den = torch.clamp(norm3(y0 - center).nan_to_num(0).amax(dim=1),
                            min=1e-6)
    bounds = torch.tensor([0.0, 0.0, 0.0, *((np.array(shape) - 1) * voxsp),
                           voxsp], dtype=torch.float32)
    cfg = RefineConfig(n_steps=n_steps, min_step=min_step, batch_size=4)
    got = one_pass_order(field, y0, center, angle_den, bounds, cfg)
    ref = k15.refine_loop_plain(field, y0, center, angle_den, bounds, cfg)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    failed, frozen, steps = ref[5], ref[3], ref[4]
    assert failed.tolist() == [False] * 4 + [True, False]
    if min_step == 0.0:                # nothing freezes but the failure
        assert steps.tolist() == [n_steps] * 4 + [1, n_steps]
    else:
        assert bool(frozen[3]) and int(steps[3]) < n_steps
