"""K5's flat form (Newton localization from K4's flat indices to the
anchors' validity) and K22 (per-axis occupancy flags) on the CPU: their
plain PyTorch versions against mad_tpu, and renderings of the CUDA
kernels' own decomposition (csrc/localize.cu's window about each peak's
patch, csrc/crop_pad.cu's stream of 16-byte chunks) against the plain
versions, since the kernels run only on the card.

* K5: ``localize_peaks`` on CPU tensors (its plain version) equals the
  seeds of ``flat_seeds`` walked by ``localize_plain`` with ``(vals >
  threshold) & good``, and the kernel's rendering (seeds from the flat
  indices, the kEdge^3 window loaded about the patch, clamped to the
  volume, and reloaded when the walk leaves it) bit for bit: at the border ``eb``, at pos
  0 (the far-face patch of ``patch_index``), at the upper face, with
  ``n_iter`` 0, on a singular Hessian, a NaN volume and values equal to
  the threshold; on walks of several voxels, in both forms. The seeds
  equal numpy's unravel and clip, as mad_tpu's ``detect_counts`` makes
  them. On a smoothed noise volume the whole ``detect_anchors`` equals
  mad_tpu's: the same anchors, values and validity bit for bit, subvoxel
  coordinates within 1e-4 voxel (mad_tpu's determinant is an LU, the
  port's the cofactor formula, so their last bits may differ).
* K22: the plain version equals mad_tpu's ``_compiled_axis_any`` bit for
  bit at Z of 4, 5, 7 and 250 (one nonzero voxel at each corner, a NaN
  that counts, -0.0 that does not), and so does the kernel's rendering
  (the scalar head and tail, chunks over two rows, the carried positions,
  the blocks' spans) at each 4-byte offset from a 16-byte boundary, with
  the source's constants and with small ones that make many blocks and
  steps.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.core.grid import _compiled_axis_any
from mad_tpu.ops import detect as jdet
from mad_tpu_torch.core.config import DetectConfig
from mad_tpu_torch.kernels import build
from mad_tpu_torch.kernels import crop_pad as k22
from mad_tpu_torch.kernels import localize as k5
from mad_tpu_torch.kernels.peaks import peak_topk
from mad_tpu_torch.ops import detect as tdet

torch.set_num_threads(1)

SUBVOX_TOL = 1e-4
EDGE = build.constants("localize.cu")["kEdge"]
FLAGS = build.constants("crop_pad.cu")
H100_SMS = 132


def _same(a, b):
    """Equal bit for bit (NaN payloads and signed zeros included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


# -- K5 ---------------------------------------------------------------------

def _patch_start(pos, n_full, off, n_blk):
    s = pos - 1
    if s < 0:
        s += n_full
    s = min(max(s, 0), n_full - 3) - off
    return min(max(s, 0), n_blk - 3)


def _window_start(s, n):
    reach = (EDGE - 3) // 2
    return max(min(s - reach, n - EDGE), 0) if s - reach > 0 else 0


def k5_kernel(vol, real, max_offset, n_iter, seeds=None, flat=None,
              vals=None, eb=0, thr=0.0, goff=0, nx=None):
    """csrc/localize.cu peak by peak: the seed (given, or from the flat
    index and clamped), the walk on the kEdge^3 window about the patch
    (samples past the volume's last repeat it; reloaded when the patch
    leaves it), each step's arithmetic as localize_plain's; returns (pos,
    subvox, good, window loads)."""
    X, Y, Z = vol.shape
    nx = X if nx is None else nx
    out, loads = [], 0
    for k in range(len(seeds if seeds is not None else flat)):
        if seeds is not None:
            pos = [int(v) for v in seeds[k]]
        else:
            f = int(flat[k])
            pos = [min(max(p, eb), r - eb - 1) for p, r in
                   zip((f // (Y * Z), (f // Z) % Y, f % Z), real)]
        w0, win = None, None
        off = torch.zeros((1, 3))
        H = torch.zeros((1, 3, 3))
        accepted = False
        for _ in range(n_iter):
            s = (_patch_start(pos[0], nx, goff, X), _patch_start(pos[1], Y, 0, Y),
                 _patch_start(pos[2], Z, 0, Z))
            if w0 is None or not all(w <= si <= w + EDGE - 3
                                     for w, si in zip(w0, s)):
                w0 = [_window_start(si, n) for si, n in zip(s, (X, Y, Z))]
                ix = [torch.clamp(w + torch.arange(EDGE), max=n - 1)
                      for w, n in zip(w0, (X, Y, Z))]
                win = vol[ix[0][:, None, None], ix[1][None, :, None],
                          ix[2][None, None, :]]
                loads += 1
            a, b, c = (si - w for si, w in zip(s, w0))
            Hn, G = k5._hessian_grad(win[a:a + 3, b:b + 3, c:c + 3][None])
            Hinv, ok = k5._inv3(Hn)
            o = -(Hinv[..., 0] * G[:, 0:1] + Hinv[..., 1] * G[:, 1:2]
                  + Hinv[..., 2] * G[:, 2:3])
            acc = bool(((torch.abs(o) < max_offset).all(dim=1) & ok)[0])
            if not acc:
                for ax in range(3):
                    if bool(o[0, ax] < -max_offset) and pos[ax] - 1 > 0:
                        pos[ax] -= 1
                    if bool(o[0, ax] > max_offset) and pos[ax] + 1 < real[ax] - 1:
                        pos[ax] += 1
            off, H, accepted = o, Hn, acc
            if acc or not bool(ok[0]):
                break
        good = accepted and bool(k5._neg_semidefinite(H)[0])
        if vals is not None:
            good = good and bool(vals[k] > thr)
        p = torch.tensor(pos)
        out.append((p, p.to(torch.float32) + off[0], good))
    if not out:
        return (torch.zeros((0, 3), dtype=torch.int64), torch.zeros((0, 3)),
                torch.zeros(0, dtype=torch.bool), 0)
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            torch.tensor([o[2] for o in out]), loads)


def _check_flat_form(vol, flat, vals, real, thr, eb, mo=0.6, n_iter=5):
    """localize_peaks on the CPU against the composition of its parts, the
    kernel's rendering and numpy's seeds; returns the anchors and the
    rendering's window loads."""
    vol, flat, vals = (torch.as_tensor(x) for x in (vol, flat, vals))
    got = k5.localize_peaks(vol, flat, vals, real, thr, eb, mo, n_iter)
    seeds = k5.flat_seeds(flat, vol.shape, real, eb)
    want = np.clip(np.stack(np.unravel_index(flat.numpy(), vol.shape), -1),
                   eb, np.asarray(real) - eb - 1)
    np.testing.assert_array_equal(seeds.numpy(), want)
    pos, sub, good = k5.localize_plain(vol, seeds, real, mo, n_iter)
    for a, b in zip(got, (pos, sub, (vals > thr) & good)):
        assert _same(a, b)
    *model, loads = k5_kernel(vol, real, mo, n_iter, flat=flat, vals=vals,
                              eb=eb, thr=thr)
    for a, b in zip(got, model):
        assert _same(a, b)
    return got, loads


def _smooth_noise(seed, shape, passes=2):
    v = np.random.default_rng(seed).normal(size=shape)
    for ax in range(3):
        for _ in range(passes):
            v = (np.roll(v, 1, ax) + 2 * v + np.roll(v, -1, ax)) / 4
    return v.astype(np.float32)


def test_k5_flat_form_at_the_faces():
    """Seeds at the border eb and clamped into it, at pos 0 (eb 0: the
    patch is the far face's), at the upper real face, inside; n_iter 0."""
    vol = _smooth_noise(1, (11, 9, 12))
    real = (10, 8, 12)                     # the last x and y rows padding
    pts = [(0, 0, 0), (0, 4, 6), (9, 7, 11), (10, 8, 11), (5, 1, 10),
           (2, 3, 4), (6, 5, 0), (1, 7, 5)]
    flat = np.ravel_multi_index(np.array(pts).T, vol.shape).astype(np.int64)
    vals = np.linspace(0.01, 0.2, len(pts)).astype(np.float32)
    for eb in (0, 1, 2):
        (pos, _sub, valid), _ = _check_flat_form(vol, flat, vals, real, 0.05,
                                                 eb)
        assert int(pos.min()) >= min(eb, 1)
        assert not bool(valid[vals <= np.float32(0.05)].any())
    (pos, _sub, valid), loads = _check_flat_form(vol, flat, vals, real, 0.05,
                                                 0, n_iter=0)
    assert loads == 0 and not bool(valid.any())
    np.testing.assert_array_equal(pos.numpy(), np.minimum(pts, np.asarray(
        real) - 1))


def test_k5_flat_form_degenerate():
    """A singular Hessian (a flat volume), a NaN volume (every offset NaN:
    bad at once), values equal to the threshold (not valid), and no peak."""
    flat = np.array([40, 333, 123, 7], np.int64)
    vals = np.array([0.05, 0.05, 0.5, 0.049], np.float32)
    const = np.full((8, 9, 10), 0.25, np.float32)
    (_pos, sub, valid), loads = _check_flat_form(const, flat, vals,
                                                 const.shape, 0.05, 1)
    assert loads == len(flat) and not bool(valid.any())
    nan = np.full((8, 9, 10), np.nan, np.float32)
    (_pos, sub, valid), _ = _check_flat_form(nan, flat, vals, nan.shape,
                                             0.05, 1)
    assert bool(torch.isnan(sub).all()) and not bool(valid.any())
    blob = _smooth_noise(4, (8, 9, 10))
    _check_flat_form(blob, flat, vals, blob.shape, 0.05, 1)
    got, _ = _check_flat_form(blob, flat[:0], vals[:0], blob.shape, 0.05, 1)
    assert [tuple(t.shape) for t in got] == [(0, 3), (0, 3), (0,)]


def test_k5_kernel_window_on_long_walks():
    """Seeds 2-3 voxels from a Gaussian peak walk out of their first window
    (reloads), in the flat form and in the offset form on a block of a
    larger field (goff > 0), bit for bit with the plain walk."""
    n = 20
    g = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1)
    vol = np.exp(-((g - [9.7, 10.2, 9.4]) ** 2 / [60.0, 70.0, 65.0]).sum(-1))
    vol = torch.as_tensor(vol.astype(np.float32))
    pts = [(7, 10, 9), (12, 12, 9), (9, 7, 12), (13, 13, 13), (6, 6, 6),
           (10, 10, 9), (1, 10, 9), (18, 2, 10)]
    flat = torch.as_tensor(np.ravel_multi_index(np.array(pts).T, (n,) * 3))
    vals = torch.full((len(pts),), 1.0)
    (pos, _sub, valid), loads = _check_flat_form(vol, flat, vals, (n,) * 3,
                                                 0.05, 1, n_iter=8)
    assert loads > len(pts) and int(valid.sum()) >= 4
    assert int((pos - torch.as_tensor(pts)).abs().amax()) >= 4
    # the offset form: rows 4.. of the field as a block, its seeds global
    seeds = torch.as_tensor([p for p in pts if 6 <= p[0] <= 14])
    blk = vol[4:17].contiguous()
    got = k5.localize(blk, seeds, (n,) * 3, 0.6, 8, 4, n)
    ref = k5.localize_plain(blk, seeds, (n,) * 3, 0.6, 8, 4, n)
    *model, loads = k5_kernel(blk, (n,) * 3, 0.6, 8, seeds=seeds, goff=4,
                              nx=n)
    for a, b, c in zip(got, ref, model):
        assert _same(a, b) and _same(a, c)
    assert loads > len(seeds)


def test_k5_flat_form_matches_mad_tpu():
    vol = _smooth_noise(7, (22, 20, 24), passes=1)
    jcfg = dataclasses.replace(JConfig().detect, exclude_border=2,
                               threshold_abs=0.02, max_anchors=256)
    a = jdet.detect_anchors(jnp.asarray(vol), vol.shape, jcfg)
    n = int(np.sum(np.asarray(a.values) > jcfg.threshold_abs))
    t = tdet.detect_anchors(torch.as_tensor(vol), vol.shape,
                            DetectConfig(**dataclasses.asdict(jcfg)))
    assert t.n == n > 20
    np.testing.assert_array_equal(t.coords.numpy(), np.asarray(a.coords)[:n])
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(a.values)[:n])
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(a.valid)[:n])
    assert 0 < int(t.valid.sum()) < n
    assert np.abs(t.subvox.numpy() - np.asarray(a.subvox)[:n]).max() \
        <= SUBVOX_TOL
    # the kernel's rendering on the anchors' own peaks
    vals, flat = peak_topk(torch.as_tensor(vol), vol.shape, 0.02, 2, 256)
    *model, _loads = k5_kernel(torch.as_tensor(vol), vol.shape, 0.6, 5,
                               flat=flat, vals=vals, eb=2, thr=0.02)
    for x, y in zip((t.coords, t.subvox, t.valid), model):
        assert _same(x, y)


# -- K22 --------------------------------------------------------------------

def _advance(v, d, Y, Z):
    x, y, z = v[0] + d[0], v[1] + d[1], v[2] + d[2]
    if z >= Z:
        z, y = z - Z, y + 1
    if y >= Y:
        y, x = y - Y, x + 1
    return x, y, z


def _advance_of(n, Y, Z):
    rows = n // Z
    return rows // Y, rows % Y, n % Z


def _voxel_of(e, Y, Z):
    r = e // Z
    return r // Y, r % Y, e - r * Z


def k22_kernel(vol, misalign, threads, slots, most):
    """csrc/crop_pad.cu's axis_flags as the card runs it, the data
    ``4 * misalign`` bytes past a 16-byte boundary: the blocks' spans of
    16-byte chunks, each thread's slots with their carried positions, the
    values outside whole chunks one at a time; uint8 (X + Y + Z,)."""
    X, Y, Z = vol.shape
    N, v = vol.size, vol.reshape(-1)
    head = min(N, (4 - misalign) % 4)
    chunks = (N - head) // 4 if Z >= 4 else 0
    singles = N - 4 * chunks
    per = slots * threads
    want = max(-(-chunks // per), -(-singles // threads))
    blocks = max(1, min(want, most))
    span = -(-chunks // blocks)
    slot, step = _advance_of(4 * threads, Y, Z), _advance_of(4 * per, Y, Z)
    flags = np.zeros(X + Y + Z, np.uint8)
    tail = head + 4 * chunks
    for b in range(blocks):
        seen = np.zeros(X + Y + Z, np.uint8)
        for i in range(b * threads, singles, blocks * threads):
            for t in range(min(threads, singles - i)):
                e = i + t if i + t < head else tail + (i + t - head)
                if v[e] != 0:
                    x, y, z = _voxel_of(e, Y, Z)
                    seen[[x, X + y, X + Y + z]] = 1
        c0, c1 = b * span, min(b * span + span, chunks)
        for t in range(threads):
            at = [_voxel_of(head + 4 * (c0 + t), Y, Z)]
            for _ in range(slots - 1):
                at.append(_advance(at[-1], slot, Y, Z))
            for c in range(c0 + t, c1, per):
                for j in range(slots):
                    cj = c + j * threads
                    vals = (v[head + 4 * cj:head + 4 * cj + 4] if cj < c1
                            else np.zeros(4, np.float32))
                    x, y, z = at[j]
                    m = [bool(q != 0) for q in vals]
                    n1 = min(4, Z - z)
                    if any(m[:n1]):
                        seen[[x, X + y]] = 1
                    if any(m[n1:]):
                        wrap = y + 1 == Y
                        seen[[x + wrap, X + (0 if wrap else y + 1)]] = 1
                    for i, hit in enumerate(m):
                        if hit:
                            seen[X + Y + (z + i if z + i < Z else z + i - Z)] = 1
                    at[j] = _advance(at[j], step, Y, Z)
        flags |= seen
    return flags


def _flag_volumes(Z):
    """One nonzero voxel at each corner, a NaN, -0.0 beside a sparse fill,
    and an empty volume, (X, Y) = (3, 4) (Z = 250) or (5, 6)."""
    shape = (3, 4, Z) if Z > 64 else (5, 6, Z)
    vols = []
    for corner in np.ndindex(2, 2, 2):
        v = np.zeros(shape, np.float32)
        v[tuple(c * (n - 1) for c, n in zip(corner, shape))] = 1.0
        vols.append(v)
    v = np.zeros(shape, np.float32)
    v[1, 2, Z // 2] = np.nan
    vols.append(v)
    rng = np.random.default_rng(Z)
    v = (rng.random(shape) * (rng.random(shape) < 0.05)).astype(np.float32)
    v[0, 0, :] = 0.0
    v[0, :, 0] = -0.0
    v[-1, 1, 3] = -0.0
    vols.append(v)
    vols.append(np.zeros(shape, np.float32))
    return vols


@pytest.mark.parametrize("Z", [4, 5, 7, 250])
def test_k22_plain_and_kernel_match_mad_tpu(Z):
    consts = [(FLAGS["kFlagThreads"], FLAGS["kFlagSlots"],
               H100_SMS * FLAGS["kFlagBlocksPerSm"]), (4, 2, 3), (3, 1, 5)]
    for vol in _flag_volumes(Z):
        want = np.concatenate([np.asarray(f) for f in
                               _compiled_axis_any(vol.shape)(vol)])
        got = k22.axis_flags(torch.as_tensor(vol))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
        for threads, slots, most in consts:
            for misalign in range(4):
                np.testing.assert_array_equal(
                    k22_kernel(vol, misalign, threads, slots, most),
                    got.numpy(), f"{threads}, {slots}, {most}, {misalign}")
