"""The plain forms of K4's keys and K18 (mad_tpu_torch/kernels/peaks.py and
overlap.py) against mad_tpu, on the CPU, fed the same numpy inputs.

K4: the wrapper orders the kernel's survivors by one sort of 64-bit keys
(``peak_keys_plain``: the value's order, then the own-row flat index) and
reads their values back (``topk_from_keys``). Required, exactly:
  * ascending keys give ``lax.top_k``'s order of the values (ties by flat
    index, +0.0 above -0.0) and ``_order``'s, also at a capacity cut;
  * the keys of the plain version's peaks, shuffled as the kernel's
    atomics leave them, decode to the plain version's top-k, in the offset
    form too;
  * the plain version's anchors equal mad_tpu's ``detect_anchors`` (its
    ``detect_counts``) on a volume of plateaus under a negative threshold,
    signed zeros among the peaks.
K18: ``pack_overlap_plain`` equals mad_tpu's ``_compiled_pack_overlap``
bit for bit (integer counts, one IEEE division) on boxes at every face of
the frame, an all-empty solution, m = 2 and boxes that do not meet; the
host check (``check_frame``) refuses a box outside the frame.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.engine import assemble as jasm
from mad_tpu.ops import detect as jdet
from mad_tpu_torch.core.config import DetectConfig
from mad_tpu_torch.kernels import overlap as k18
from mad_tpu_torch.kernels import peaks as k4
from mad_tpu_torch.ops import detect as tdet

torch.set_num_threads(1)


def _values(rng, n):
    """float32 values with many ties, signed zeros, +inf, subnormals and
    both signs (a peak is above a threshold, so never -inf)."""
    pool = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, np.inf, 1e-45,
                     -1e-45, 3.4e38, -3.4e38], np.float32)
    v = np.where(rng.random(n) < 0.5, rng.choice(pool, n),
                 rng.normal(size=n).astype(np.float32))
    return v.astype(np.float32)


def test_keys_give_lax_top_k_order():
    rng = np.random.default_rng(31)
    v = _values(rng, 400)
    idx = rng.permutation(1000)[:400]
    keys = k4.peak_keys_plain(torch.tensor(v), torch.tensor(idx))
    assert torch.equal(k4.key_index(keys),
                       torch.tensor(idx, dtype=torch.int64))
    # lax.top_k over the values laid out by index (-inf elsewhere)
    dense = np.full(1000, -np.inf, np.float32)
    dense[idx] = v
    for k in (len(v), 37):                       # and a capacity cut
        got = k4.key_index(torch.sort(keys).values[:k]).numpy()
        _jv, ji = lax.top_k(jnp.asarray(dense), k)
        assert np.array_equal(got, np.asarray(ji))
        ov, oi = k4._order(torch.tensor(v), torch.tensor(idx), k)
        assert np.array_equal(oi.numpy(), got)
        assert np.array_equal(ov.numpy().view(np.int32),
                              dense[got].view(np.int32))


@pytest.mark.parametrize("row0,rows,x0,capacity",
                         [(0, None, 0, 5000), (5, 7, 40, 11)])
def test_shuffled_keys_decode_to_the_plain_top_k(row0, rows, x0, capacity):
    """The wrapper's decode on keys in any order (as the kernel's atomics
    leave them): the plain version's values and global indices, offset
    form and capacity cut included."""
    rng = np.random.default_rng(32)
    vol = np.round(rng.normal(size=(17, 15, 13)) * 2) / 2
    vol = torch.tensor(vol.astype(np.float32))
    real, thr, border = (60, 14, 12), -0.6, 1
    want = k4.peak_topk_plain(vol, real, thr, border, capacity, row0, rows,
                              x0)
    # the plain version's peaks, uncut, as the kernel appends them
    every = k4.peak_topk_plain(vol, real, thr, border, 10 ** 6, row0, rows,
                               x0)
    Y, Z = vol.shape[1:]
    local = every[1] - x0 * Y * Z
    keys = k4.peak_keys_plain(every[0], local)[torch.randperm(
        len(local), generator=torch.Generator().manual_seed(3))]
    own = vol.shape[0] - row0 if rows is None else rows
    got = k4.topk_from_keys(vol, keys, capacity, row0, own, x0)
    assert len(every[1]) > 20
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def test_plain_k4_matches_mad_tpu_on_plateaus_below_zero():
    """Plateaus of equal values (every voxel of a maximal plateau is a
    peak), a negative threshold and peaks at +0.0 and -0.0: the same
    anchors, values and order as mad_tpu's detect_counts."""
    rng = np.random.default_rng(33)
    vol = -np.abs(np.round(rng.normal(size=(22, 20, 18)) * 2) / 2)
    vol = vol.astype(np.float32)            # every 0 is a peak, and so
    vol[vol == 0] = np.where(rng.random(int(np.sum(vol == 0))) < 0.5,
                             np.float32(0.0), np.float32(-0.0))
    cfg = dataclasses.replace(JConfig().detect, threshold_abs=-0.6,
                              exclude_border=2, max_anchors=2000)
    a = jdet.detect_anchors(jnp.asarray(vol), vol.shape, cfg)
    jv = np.asarray(a.values)
    n = int(np.sum(jv > cfg.threshold_abs))
    t = tdet.detect_anchors(torch.tensor(vol), vol.shape,
                            DetectConfig(**dataclasses.asdict(cfg)))
    tv = t.values.numpy()
    signed_zero = np.signbit(tv) & (tv == 0)
    assert n == t.n > 100
    assert signed_zero.any() and ((tv == 0) & ~np.signbit(tv)).any()
    np.testing.assert_array_equal(t.coords.numpy(), np.asarray(a.coords)[:n])
    assert np.array_equal(tv.view(np.int32), jv[:n].view(np.int32))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(a.valid)[:n])


def _boxes(case):
    """(dens (m, X, Y, Z) float32, offsets (m, 3), frame) of a K18 case."""
    rng = np.random.default_rng(34)
    box = (9, 8, 20)
    if case == "faces":
        frame = (17, 15, 64)
        hi = np.array(frame) - box
        off = np.array([[0, 0, 0], hi, [hi[0], 3, 11], [5, hi[1], 0],
                        [2, 4, hi[2]], [0, hi[1], hi[2]], [6, 5, 30],
                        [hi[0], 0, 23]])
    elif case == "m2":
        frame, off = (11, 10, 32), np.array([[0, 0, 0], [2, 1, 3]])
    else:                                 # boxes that do not meet
        frame = (27, 9, 64)
        off = np.array([[0, 0, 0], [9, 0, 5], [18, 1, 40]])
    m = len(off)
    dens = rng.normal(size=(m,) + box).astype(np.float32)
    if case == "faces":
        dens[3] = -np.abs(dens[3])          # an all-empty solution
        dens[0, 0, 0, 0] = 0.0              # zero is not occupied
    return dens, off.astype(np.int32), frame


@pytest.mark.parametrize("case", ["faces", "m2", "apart"])
def test_plain_k18_matches_mad_tpu(case):
    dens, off, frame = _boxes(case)
    m = len(off)
    fn = jasm._compiled_pack_overlap(m, dens.shape[1:], frame[:2],
                                     frame[2] // 32)
    want = np.asarray(fn(jnp.asarray(dens), jnp.asarray(off)))
    got = k18.pack_overlap(torch.tensor(dens), torch.tensor(off), frame)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    if case == "faces":
        assert not got[3].any() and not got[:, 3].any()
        assert (got > 0).sum() > m
    elif case == "apart":
        assert not got.any()


def test_check_frame_refuses_a_box_outside_the_frame():
    dens, off, frame = _boxes("faces")
    box = dens.shape[1:]
    k18.check_frame(off, box, frame)
    for a in range(3):
        for shift in (-1, 1):
            bad = off.copy()
            bad[1 if shift > 0 else 0, a] += shift   # past a face
            with pytest.raises(ValueError, match="does not fit"):
                k18.check_frame(bad, box, frame)
            with pytest.raises(ValueError, match="does not fit"):
                k18.pack_overlap_plain(torch.tensor(dens), torch.tensor(bad),
                                       frame)
