"""Port parity: capacity mode (mad_tpu_torch/parallel, the mesh paths of
ops/scalespace, ops/detect, ops/orient, ops/describe and
engine/pipeline.describe_grid) against the port's single-device run and
against mad_tpu's capacity bodies on its virtual 8-device CPU mesh
(tests/conftest.py), fed the same numpy inputs. The port's mesh here is
shards on the CPU (``make_mesh(n, devices=["cpu"] * n)``).

Required:
  * halo blocks equal to slices of the volume, cut at the global ends
    (mad_tpu's ``halo_extend`` zero-fills there: its rows inside the volume
    are the same), also with a halo wider than a slab and a vector field;
  * the sharded LoG and Gaussian equal to ``log_filter3d`` of the whole
    volume bit for bit, and to mad_tpu's ``sharded_log_shardmap`` within
    1e-6;
  * detection on 8 shards equal to the port's single-device detection bit
    for bit; against mad_tpu's ``detect_shard``: coords and validity
    equal, subvox within 1e-5, values within 1e-6 (mad_tpu's own gates
    between its mesh and single-device runs, tests/test_capacity.py:81-87);
  * orientation and descriptors on 4 shards against mad_tpu's
    ``orient_shard`` / ``describe_shard`` put back in slot space: validity,
    main and secondary bins equal, frames within 1e-6, descriptor rows
    equal;
  * ``describe_grid(mesh=)`` on 3 shards (a short last shard) and 8 equal
    to the single-device ``DescriptorSet`` field for field, with no field a
    kernel reads holding more rows than a shard's own plus twice the
    octave's largest halo;
  * ``make_mesh(n)`` raises without n cards;
  * every kernel launch makes its inputs' card current (``build.launch``;
    the card is mocked here), so a shard on another card than the current
    one launches there.
"""

import contextlib
import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mad_tpu_torch.core.config import (DescribeConfig, DetectConfig,
                                       MadConfig, OrientConfig)
from mad_tpu_torch.parallel.mesh import make_mesh
from mad_tpu_torch.parallel.volume import halo_extend, row_bounds, split_x

torch.set_num_threads(1)

RFINAL_TOL = 1e-6
SUBVOX_TOL, VALUE_TOL, LOG_TOL = 1e-5, 1e-6, 1e-6

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs mad_tpu's 8-device CPU mesh")


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _jax_sharded(vol, mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mad_tpu.parallel.mesh import mesh_axis
    spec = P(mesh_axis(mesh), *([None] * (vol.ndim - 1)))
    return jax.device_put(jnp.asarray(vol), NamedSharding(mesh, spec))


@needs_devices
def test_halo_extend_cut_at_the_ends():
    from mad_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mad_tpu.parallel.volume import halo_extend as jhalo
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(0)
    jmesh = jmake_mesh(4)
    mesh = cpu_mesh(4)
    for halo, shape in ((3, (32, 6, 5)), (11, (32, 6, 5)),
                        (4, (32, 6, 5, 3))):
        vol = rng.random(shape).astype(np.float32)
        blocks = halo_extend(split_x(torch.tensor(vol), mesh), halo, mesh)
        assert blocks.bounds == [0, 8, 16, 24, 32] and blocks.halo == halo
        spec = P("x", *([None] * (vol.ndim - 1)))
        fn = shard_map(lambda b: jhalo(b, halo, "x", 4), mesh=jmesh,
                       in_specs=(spec,), out_specs=spec)
        ref = np.asarray(fn(_jax_sharded(vol, jmesh)))
        blk = shape[0] // 4
        for s, (got, lo) in enumerate(zip(blocks.blocks, blocks.lo)):
            x0, x1 = s * blk, (s + 1) * blk
            assert lo == max(0, x0 - halo)
            np.testing.assert_array_equal(
                got.numpy(), vol[lo:min(shape[0], x1 + halo)])
            # mad_tpu's block: the same rows, zeros beyond the ends
            full = ref[s * (blk + 2 * halo):(s + 1) * (blk + 2 * halo)]
            cut = halo - (x0 - lo)
            np.testing.assert_array_equal(got.numpy(),
                                          full[cut:cut + got.shape[0]])
            assert not full[:cut].any() and not full[cut + got.shape[0]:].any()


@needs_devices
def test_sharded_log_equals_whole_volume():
    # the sharded LoG is the base octave's (ShardedOctave.log_gauss, the
    # function capacity mode runs)
    from mad_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mad_tpu.parallel.volume import sharded_log_shardmap
    from mad_tpu_torch.core.config import ScaleSpaceConfig
    from mad_tpu_torch.ops.convolve import log_filter3d
    from mad_tpu_torch.ops.scalespace import ShardedOctave

    rng = np.random.default_rng(2)
    vol = rng.random((40, 12, 10)).astype(np.float32)
    mesh = cpu_mesh(4)
    octv = ShardedOctave(split_x(torch.tensor(vol), mesh), 1.0, False,
                         ScaleSpaceConfig(detect_sigma=2.0), mesh)
    log_s, gauss_s = octv.log_gauss()
    assert [p.shape[0] for p in log_s] == [10] * 4
    log_w, gauss_w = log_filter3d(torch.tensor(vol), 2.0)
    assert torch.equal(torch.cat(log_s), log_w)
    assert torch.equal(torch.cat(gauss_s), gauss_w)
    jl, jg = sharded_log_shardmap(jnp.asarray(vol), 2.0, jmake_mesh(4))
    assert np.abs(torch.cat(log_s).numpy() - np.asarray(jl)).max() <= LOG_TOL
    assert np.abs(torch.cat(gauss_s).numpy() - np.asarray(jg)).max() \
        <= LOG_TOL


@pytest.fixture(scope="module")
def log_vol():
    # tests/test_capacity.py's volume: smooth blobs, distinct peaks
    rng = np.random.default_rng(1)
    from scipy.ndimage import gaussian_filter
    v = gaussian_filter(rng.random((64, 48, 48)), 2.5).astype(np.float32)
    return np.maximum(v - v.mean(), 0.0) * 10.0


@needs_devices
def test_detect_shard(log_vol):
    from mad_tpu.core.config import DetectConfig as JDetect
    from mad_tpu.ops.detect import detect_anchors as jdetect
    from mad_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mad_tpu_torch.ops.detect import detect_anchors

    jcfg = JDetect(max_anchors=256, threshold_abs=1e-3)
    cfg = DetectConfig(**dataclasses.asdict(jcfg))
    real = log_vol.shape
    mesh = cpu_mesh(8)
    one = detect_anchors(torch.tensor(log_vol), real, cfg)
    got = detect_anchors(split_x(torch.tensor(log_vol), mesh), real, cfg,
                         mesh=mesh)
    for k in ("coords", "subvox", "values", "valid"):
        assert torch.equal(getattr(got, k), getattr(one, k)), k
    n = got.n
    assert int(got.valid.sum()) > 5

    jmesh = jmake_mesh(8)
    ref = jdetect(_jax_sharded(log_vol, jmesh), real, jcfg, mesh=jmesh)
    rv = np.asarray(ref.valid)
    assert not rv[n:].any()
    np.testing.assert_array_equal(got.valid.numpy(), rv[:n])
    np.testing.assert_array_equal(got.coords.numpy(),
                                  np.asarray(ref.coords)[:n])
    assert np.abs(got.subvox.numpy()
                  - np.asarray(ref.subvox)[:n]).max() <= SUBVOX_TOL
    assert np.abs(got.values.numpy()
                  - np.asarray(ref.values)[:n]).max() <= VALUE_TOL


@needs_devices
def test_orient_describe_shard(log_vol):
    from mad_tpu.core.config import (DescribeConfig as JDescribe,
                                     DetectConfig as JDetect,
                                     OrientConfig as JOrient)
    from mad_tpu.ops.describe import describe_anchors as jdescribe
    from mad_tpu.ops.detect import detect_anchors as jdetect
    from mad_tpu.ops.orient import orient_anchors as jorient
    from mad_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mad_tpu_torch.ops.describe import describe_anchors
    from mad_tpu_torch.ops.orient import orient_anchors

    real = log_vol.shape
    anch = jdetect(jnp.asarray(log_vol), real,
                   JDetect(max_anchors=256, threshold_abs=1e-3))
    grad = np.stack(np.gradient(log_vol), axis=-1).astype(np.float32)
    jmesh, mesh = jmake_mesh(4), cpu_mesh(4)
    gsh = _jax_sharded(grad, jmesh)
    blocks = halo_extend(split_x(torch.tensor(grad), mesh), 16, mesh)
    coords, valid = np.asarray(anch.coords), np.asarray(anch.valid)

    o4 = jorient(gsh, anch, real, False, JOrient(), mesh=jmesh, shard_k=256)
    K, M, S = coords.shape[0], o4.main_bin.shape[1], o4.sec_bin.shape[2]
    ref_valid = np.zeros((K, M, S), bool)
    ref_main = np.zeros((K, M), np.int32)
    ref_sec = np.zeros((K, M, S), np.int32)
    ref_rfin = np.zeros((K, M, S, 3, 3), np.float32)
    v4 = np.asarray(o4.valid)
    for row, slot in enumerate(np.asarray(o4.anchor_idx)):
        if v4[row].any():
            ref_valid[slot] = v4[row]
            ref_main[slot] = np.asarray(o4.main_bin)[row]
            ref_sec[slot] = np.asarray(o4.sec_bin)[row]
            ref_rfin[slot] = np.asarray(o4.rfinal)[row]
    mains, secs, rfin, ok = orient_anchors(
        blocks, torch.tensor(coords.astype(np.int64)), torch.tensor(valid),
        real, False, OrientConfig(), mesh=mesh)
    ok = ok.numpy()
    assert ok.sum() > 0
    np.testing.assert_array_equal(ok, ref_valid)
    used = ok.any(axis=-1)
    np.testing.assert_array_equal(mains.numpy()[used], ref_main[used])
    np.testing.assert_array_equal(secs.numpy()[ok], ref_sec[ok])
    assert np.abs(rfin.numpy()[ok] - ref_rfin[ok]).max() <= RFINAL_TOL

    # descriptors of the valid lanes; mad_tpu's rows back in lane order
    lanes = np.nonzero(ok.reshape(-1))[0]
    cap = ((len(lanes) + 127) // 128) * 128
    lane_idx = np.concatenate([lanes, np.zeros(cap - len(lanes), np.int64)])
    l_coords = coords[lane_idx // (M * S)]
    l_rfin = rfin.numpy().reshape(-1, 3, 3)[lane_idx]
    l_ok = np.arange(cap) < len(lanes)
    d4, k4, ord4, _cnt = jdescribe(
        gsh, jnp.asarray(l_coords), jnp.asarray(l_rfin), jnp.asarray(l_ok),
        real, False, JDescribe(), mesh=jmesh, shard_l=cap)
    ref_rows = np.zeros((cap, np.asarray(d4).shape[1]), np.int16)
    ref_ok = np.zeros(cap, bool)
    k4h = np.asarray(k4)
    for row, lane in enumerate(np.asarray(ord4)):
        if k4h[row]:
            ref_rows[lane], ref_ok[lane] = np.asarray(d4)[row], True
    descs, dok = describe_anchors(
        blocks, torch.tensor(l_coords.astype(np.int64)), torch.tensor(l_rfin),
        torch.tensor(l_ok), real, False, DescribeConfig(), mesh=mesh)
    np.testing.assert_array_equal(dok.numpy(), ref_ok)
    assert ref_ok.sum() > 0
    np.testing.assert_array_equal(descs.numpy(), ref_rows)


@pytest.fixture(scope="module")
def dimer():
    from mad_tpu_torch.engine.pipeline import describe_grid
    from mad_tpu_torch.ops.simulate import simulate_density
    from mad_tpu_torch.testing import make_assembly
    cfg = MadConfig()
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 max_anchors=1024))
    _sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, device="cpu",
                            masses=masses).reduce_void()
    return cfg, dmap, describe_grid(dmap, cfg, name="m")


FIELDS = ("coords", "map_coords", "subv_coords", "rfinal", "octave",
          "anchor_id", "main_bin", "sec_bin")


@pytest.mark.parametrize("n", [3, 8])
def test_describe_grid_mesh(dimer, n, monkeypatch):
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.kernels import orient as k6
    from mad_tpu_torch.ops import convolve, describe, detect, scalespace
    from mad_tpu_torch.parallel import volume

    cfg, dmap, want = dimer
    rows, bound = [], {}

    def octave_spy(octv, cfg, mesh=None):
        own = max(np.diff(octv.bounds))
        stride = 2 if octv.upsampled else 1
        # K3 reads one row more than orientation and the descriptors
        halo = max(octv.build_halo() * stride,
                   pipeline.grad_halo(cfg, octv.upsampled) + 1,
                   2 + cfg.detect.newton_iters)
        bound.update(rows=own + 2 * halo, full=octv.real_shape[0])
        return real_octave(octv, cfg, mesh)

    real_octave = pipeline._describe_octave
    monkeypatch.setattr(pipeline, "_describe_octave", octave_spy)
    for mod, name in ((convolve, "conv1d_along"), (convolve, "log_gauss"),
                      (scalespace, "upsample2"), (volume, "gradient"),
                      (detect, "peak_topk"), (detect, "localize"),
                      (k6, "orient"), (describe, "descriptor_hist")):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kw):
            # log_gauss is handed its volume in a one-element list
            vol = args[0][0] if isinstance(args[0], list) else args[0]
            rows.append((_name, vol.shape[0], dict(bound)))
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, spy)

    got = pipeline.describe_grid(dmap, cfg, name="m", mesh=cpu_mesh(n))
    assert got.n == want.n > 0
    assert torch.equal(got.desc, want.desc)
    assert torch.equal(got.desc_norm, want.desc_norm)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    assert {r[0] for r in rows} == {"conv1d_along", "log_gauss",
                                    "upsample2", "gradient", "peak_topk",
                                    "localize", "orient", "descriptor_hist"}
    for name, r, b in rows:
        assert r <= b["rows"] and r < b["full"], (name, r, b)


def test_make_mesh_needs_the_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError):
        make_mesh(have + 1)
    mesh = cpu_mesh(3)
    assert len(mesh) == 3 and mesh.home == torch.device("cpu")
    with pytest.raises(ValueError):
        make_mesh(2, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        split_x(torch.zeros((2, 4, 4)), mesh)
    slabs = split_x(torch.arange(7.0).reshape(7, 1, 1), mesh)
    assert row_bounds(slabs) == [0, 3, 5, 7]


def test_launch_makes_the_inputs_card_current(monkeypatch):
    from mad_tpu_torch.kernels import build
    current, seen = ["cuda:0"], []

    @contextlib.contextmanager
    def device(dev):
        prev, current[0] = current[0], str(dev)
        try:
            yield
        finally:
            current[0] = prev

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: (
        types.SimpleNamespace(cuda_stream=1000 + torch.device(dev).index)))
    monkeypatch.setattr(build, "_lib", types.SimpleNamespace(
        mad_error_string=lambda code: b"invalid device ordinal"))

    def mad_fake(*args):
        seen.append((args, current[0]))
        return 0 if args[0] else 101

    mad_fake.argtypes = [None] * 3          # two arguments and the stream
    build.launch(mad_fake, torch.device("cuda", 1), 7, 8)
    assert seen == [((7, 8, 1001), "cuda:1")] and current == ["cuda:0"]
    with pytest.raises(RuntimeError, match="mad_fake: CUDA launch failed: "
                       "invalid device ordinal"):
        build.launch(mad_fake, torch.device("cuda", 2), 0, 8)
    assert seen[-1] == ((0, 8, 1002), "cuda:2") and current == ["cuda:0"]
