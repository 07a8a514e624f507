"""Port parity: orientation (mad_tpu_torch/ops/orient.py) and descriptors
(mad_tpu_torch/ops/describe.py with kernel K7,
mad_tpu_torch/kernels/describe.py) against mad_tpu, fed mad_tpu's own
gradient fields, anchors and frames.

Required:
  * identical lane validity and main / secondary bins;
  * rfinal within 1e-5 (float32 frames built from the same float64 tables);
  * int16 descriptor rows equal in >= 99 % of rows, the rest within an L1
    distance of 8 counts (a sample whose direction lands within float32
    rounding of a zone bound may bin differently: atan2 / acos of the two
    libraries can differ in the last ulp);
  * the 4-decimal zone-bound quirks agree exactly; the descriptor rows
    include identity-frame lanes whose samples sit on .5 voxel ties (the
    ``nearest`` rule alone is in tests/test_torch_interp.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mad_tpu.core.config import MadConfig as JConfig
from mad_tpu.core.eqsp import get_eqsp as jget_eqsp
from mad_tpu.ops import detect as jdet
from mad_tpu.ops import describe as jdsc
from mad_tpu.ops import orient as jori
from mad_tpu.ops import scalespace as jss
from mad_tpu.ops import simulate as jsim
from mad_tpu.testing import make_assembly
from mad_tpu_torch.core.config import MadConfig as TConfig
from mad_tpu_torch.core.eqsp import get_eqsp
from mad_tpu_torch.kernels import describe as k7
from mad_tpu_torch.kernels import orient as k6
from mad_tpu_torch.ops import describe as tdsc
from mad_tpu_torch.ops import orient as tori

torch.set_num_threads(1)

RFINAL_TOL = 1e-5
ROWS_EQUAL = 0.99
ROW_L1 = 8


@pytest.fixture(scope="module")
def octaves():
    """Per octave of a small two-copy map: mad_tpu's gradient, anchors,
    orientation lanes, and the compacted valid lanes' frames."""
    sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    cfg = JConfig()
    dmap = jsim.simulate_density(coords, 8.0, 2.0, masses=masses
                                 ).reduce_void()
    out = []
    for _org, o in jss.iter_lazy_octaves(dmap, cfg.scalespace,
                                         cfg.shape_bucket):
        up = o.voxsp < dmap.voxsp
        real = tuple(o.real_shape)
        anch = jdet.detect_anchors(o.log(), real, cfg.detect)
        grad = o.grad()
        ori = jori.orient_anchors(grad, anch, real, up, cfg.orient)
        out.append(dict(up=up, real=real, grad=np.asarray(grad),
                        coords=np.asarray(anch.coords),
                        valid=np.asarray(anch.valid),
                        main=np.asarray(ori.main_bin),
                        sec=np.asarray(ori.sec_bin),
                        rfinal=np.asarray(ori.rfinal),
                        ok=np.asarray(ori.valid)))
    return out


@pytest.mark.parametrize("octave", [0, 1])
def test_orientation_lanes(octaves, octave):
    o = octaves[octave]
    n = int(o["valid"].sum()) + 8       # a few invalid anchors ride along
    main, sec, rfin, ok = tori.orient_anchors(
        torch.tensor(o["grad"]), torch.tensor(o["coords"][:n]).long(),
        torch.tensor(o["valid"][:n]), o["real"], o["up"], TConfig().orient)
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, o["ok"][:n])
    assert ok.sum() > 20
    anchor_ok = ok.any(axis=(1, 2))
    np.testing.assert_array_equal(main.numpy()[anchor_ok],
                                  o["main"][:n][anchor_ok])
    np.testing.assert_array_equal(sec.numpy()[ok], o["sec"][:n][ok])
    assert np.abs(rfin.numpy()[ok] - o["rfinal"][:n][ok]).max() <= RFINAL_TOL


def _lanes(o, n_identity=8):
    """mad_tpu's valid lanes (anchor coords, frames), padded to 128 rows,
    plus identity-frame lanes: on the base octave their lattice points sit
    exactly on .5 voxel offsets, the nearest-neighbour tie case."""
    k, m, s = np.nonzero(o["ok"])
    coords = o["coords"][k]
    rfin = o["rfinal"][k, m, s]
    coords = np.concatenate([coords, coords[:n_identity]])
    rfin = np.concatenate([rfin, np.broadcast_to(np.eye(3, dtype=np.float32),
                                                 (n_identity, 3, 3))])
    d = len(coords)
    pad = -d % 128
    valid = np.r_[np.ones(d, bool), np.zeros(pad, bool)]
    coords = np.concatenate([coords, np.repeat(coords[:1], pad, 0)])
    rfin = np.concatenate([rfin, np.repeat(rfin[:1], pad, 0)])
    return coords.astype(np.int32), rfin.astype(np.float32), valid


@pytest.mark.parametrize("octave", [0, 1])
def test_descriptor_rows(octaves, octave):
    o = octaves[octave]
    coords, rfin, valid = _lanes(o)
    dj, okj = jdsc.describe_anchors(jnp.asarray(o["grad"]),
                                    jnp.asarray(coords), jnp.asarray(rfin),
                                    jnp.asarray(valid), o["real"], o["up"],
                                    JConfig().describe)
    dt, okt = tdsc.describe_anchors(torch.tensor(o["grad"]),
                                    torch.tensor(coords), torch.tensor(rfin),
                                    torch.tensor(valid), o["real"], o["up"],
                                    TConfig().describe)
    dj, okj = np.asarray(dj), np.asarray(okj)
    dt, okt = dt.numpy(), okt.numpy()
    np.testing.assert_array_equal(okt, okj)
    assert okj.sum() > 20
    assert dt.dtype == np.int16 and dt.shape == dj.shape
    same = (dt == dj).all(axis=1)
    assert same.mean() >= ROWS_EQUAL
    l1 = np.abs(dt.astype(np.int64) - dj).sum(axis=1)
    assert l1.max() <= ROW_L1


def test_zone_assignment_on_bounds():
    """Directions on zone bounds: theta == 0 joins a belt's LAST zone via
    the +2pi shift, the north pole and directions exactly on a 4-decimal
    interior bound match no zone and fall to zone 0 (descriptor
    semantics)."""
    eq = get_eqsp(16)
    bounds = tori.ref_zone_bounds(eq)
    dirs = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
                     [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.6, 0.0, 0.8]],
                    dtype=np.float32)
    # unit float32 directions whose float32 theta equals a bound exactly
    on_bound = []
    r = np.float32(np.sqrt(1.0 - 0.09))
    for b in np.unique(bounds[:, [0, 2]]):
        if not 0.0 < b < np.pi:
            continue
        t = np.float32(b)
        for _ in range(64):
            d = torch.tensor([[np.cos(t) * r, np.sin(t) * r, 0.3]],
                             dtype=torch.float32)
            th = np.float32(torch.atan2(d[0, 1], d[0, 0]).item())
            if th == np.float32(b):
                on_bound.append(d[0].numpy())
                break
            t = np.nextafter(t, np.float32(b + (b - th)), dtype=np.float32)
    assert len(on_bound) >= 3
    rng = np.random.default_rng(3)
    rand = rng.normal(size=(4000, 3)).astype(np.float32)
    rand /= np.linalg.norm(rand, axis=1, keepdims=True)
    dirs = np.concatenate([dirs, np.asarray(on_bound), rand])
    ref = np.asarray(jori.zone_assign_fn(jget_eqsp(16))(jnp.asarray(dirs)))
    got = tori.zone_assign_fn(eq, "cpu")(torch.tensor(dirs)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[1] == 0          # the north pole: phi == 0 is no zone's


def test_zone_histogram_is_the_same():
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(3, 500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    w = (rng.random((3, 500)) > 0.2).astype(np.float32)
    ref = np.asarray(jori.zone_hist_fn(jget_eqsp(112))(jnp.asarray(dirs),
                                                       jnp.asarray(w)))
    b = torch.tensor(tori.ref_zone_bounds(get_eqsp(112)))
    got = k6.zone_hist(torch.tensor(dirs), torch.tensor(w), b).numpy()
    np.testing.assert_array_equal(got, ref)


def test_lattice_and_regions_are_the_same():
    for radius, up in [(8, False), (8, True), (4, False)]:
        np.testing.assert_array_equal(tdsc.descriptor_lattice(radius, up),
                                      jdsc.descriptor_lattice(radius, up))
    for n in (64, 27, 8, 1):
        np.testing.assert_array_equal(tdsc.region_ids(8, n),
                                      jdsc.region_ids(8, n))


def test_cpu_tensor_takes_the_plain_version(octaves):
    o = octaves[0]
    coords, rfin, valid = _lanes(o)
    k7.launches = 0
    tdsc.describe_anchors(torch.tensor(o["grad"]), torch.tensor(coords[:4]),
                          torch.tensor(rfin[:4]), torch.tensor(valid[:4]),
                          o["real"], o["up"], TConfig().describe)
    assert k7.launches == 0


def test_orient_tables_built_once_a_setting():
    """``orient_tables`` hands out one table set a (setting, radius,
    stride, device), equal to a fresh build, and another for another
    stride."""
    cfg = TConfig().orient
    cpu = torch.device("cpu")
    tab = tori.orient_tables(cfg, 8, 2, cpu)
    assert tori.orient_tables(cfg, 8, 2, cpu) is tab
    assert tori.orient_tables(cfg, 8, 1, cpu) is not tab
    fresh = tori._OrientTables(cfg, 8, 2, cpu)
    for k, v in vars(fresh).items():
        assert torch.equal(getattr(tab, k), v), k
