"""mad_tpu_torch's public surface against mad_tpu's: the same exports, the
same signatures (the port's own parameters keyword-only, the parameters
the port leaves behind named), a light import, and calls written for
mad_tpu meaning the same thing on the CPU and going to the card by default
(where there is none, they raise: no fallback).
"""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mad_tpu as J
import mad_tpu_torch as T
from mad_tpu.core.grid import write_mrc as jwrite_mrc
from mad_tpu.ops.simulate import simulate_density as jsimulate
from mad_tpu_torch.testing import make_assembly, make_protein

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Parameters of mad_tpu that the port leaves behind (TPU-host workarounds,
# ROADMAP ground rules): the frame group of the describe thread pool, the
# static frame rungs and the exact-peak switch of the approximate-peak
# guard.
LEFT_BEHIND = {"dock_structure": {"frame_group"},
               "describe_grid": {"_caps", "_exact"}}
# The port's own parameters: where to run and the per-stage seconds.
PORT_ONLY = {"device", "timings"}
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _same_signature(name, t, j):
    """Every positional parameter of the port at mad_tpu's position with
    its default; every keyword-only one mad_tpu's (same default) or the
    port's own; mad_tpu's missing ones exactly those left behind."""
    tp = list(inspect.signature(t).parameters.values())
    jp = list(inspect.signature(j).parameters.values())
    jpos = [p for p in jp if p.kind in POSITIONAL]
    jby = {p.name: p for p in jp}
    tpos = [p for p in tp if p.kind in POSITIONAL]
    for i, p in enumerate(tpos):
        assert i < len(jpos) and jpos[i].name == p.name, (name, p.name)
        assert p.default == jpos[i].default, (name, p.name)
    for p in tp:
        if p.kind == inspect.Parameter.KEYWORD_ONLY:
            if p.name in PORT_ONLY:
                assert p.name not in jby, (name, p.name)
                assert p.default is None, (name, p.name)
            else:
                assert p.name in jby and p.default == jby[p.name].default, \
                    (name, p.name)
    missing = set(jby) - {p.name for p in tp}
    assert missing == LEFT_BEHIND.get(name, set()), (name, missing)


def test_exports_are_mad_tpus():
    assert T.__all__ == J.__all__
    assert T.__version__ == J.__version__
    for name in T.__all__:
        assert hasattr(T, name), name


def test_signatures_are_mad_tpus():
    for name in T.__all__:
        t, j = getattr(T, name), getattr(J, name)
        if not inspect.isclass(t):
            _same_signature(name, t, j)
            continue
        if dataclasses.is_dataclass(t):
            assert ([f.name for f in dataclasses.fields(t)]
                    == [f.name for f in dataclasses.fields(j)]), name
        pub = {k for k in dir(j) if not k.startswith("_")
               and callable(getattr(j, k))}
        # mad_tpu's DensityGrid.device() is its cached jnp array; the
        # port's ``device`` is the torch device its tensor lives on.
        pub -= {"device"} if t is T.DensityGrid else set()
        for m in sorted(pub):
            _same_signature(f"{name}.{m}", getattr(t, m), getattr(j, m))
        if t is T.MaD:
            _same_signature("MaD", t.__init__, j.__init__)


def test_import_is_light():
    """Importing the package builds no kernel and touches no CUDA state."""
    code = ("import torch, mad_tpu_torch\n"
            "from mad_tpu_torch.kernels import build\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert build._lib is None\n"
            "assert not any(k.split('.')[0] in ('jax', 'mad_tpu')\n"
            "               for k in __import__('sys').modules)\n"
            "print(len(mad_tpu_torch.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "15"


def test_mad_tpu_calls_mean_the_same(tmp_path):
    """read_map(path, 0.2) and simulate_density(c, r, v, 0.2) as mad_tpu
    reads them (the isovalue, not a device): the simulation within the
    simulation tests' 1e-6 of the map's maximum
    (tests/test_torch_simulate_scalespace.py), every voxel below 0.2
    zeroed; the map read bit for bit."""
    sub, copies = make_assembly(n_copies=2, n_res=30, seed=5, spread=14.0)
    coords = np.concatenate([c.coords for c in copies])
    t = T.simulate_density(coords, 8.0, 2.0, 0.2, device="cpu").host()
    j = jsimulate(coords, 8.0, 2.0, 0.2)
    assert t.shape == j.shape
    assert np.abs(t - np.asarray(j.host())).max() <= 1e-6 * t.max()
    assert np.all((t == 0) | (t >= 0.2)) and (t == 0).any()
    path = str(tmp_path / "m.mrc")
    jwrite_mrc(j, path)
    a, b = T.read_map(path, 0.2, device="cpu"), J.read_map(path, 0.2)
    np.testing.assert_array_equal(a.host(), np.asarray(b.host()))
    assert a.device == torch.device("cpu")


def test_describe_structure_positional_call():
    """describe_structure(s, r, v, cfg) with mad_tpu's positions, on the
    CPU: the port's rows equal its own keyword call's."""
    cfg = T.MadConfig()
    s = make_protein(n_res=24, seed=4, n_segments=2)
    a = T.describe_structure(s, 8.0, 2.0, cfg, 0.0, "p", device="cpu")
    b = T.describe_structure(s, 8.0, 2.0, cfg, isovalue=0.0, name="p",
                             device="cpu")
    assert a.name == b.name == "p" and a.n == b.n > 0
    assert torch.equal(a.desc, b.desc)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_default_to_the_card(tmp_path):
    """Called without a device, the entry points ask for the card and
    raise where there is none (no fallback to the CPU)."""
    p = make_protein(n_res=20, seed=1, n_segments=2)
    cfg = T.MadConfig()
    path = str(tmp_path / "m.mrc")
    T.write_mrc(T.simulate_density(p, 8.0, 2.0, device="cpu"), path)
    calls = [lambda: T.read_map(path, 0.0),
             lambda: T.simulate_density(p.coords, 8.0, 2.0),
             lambda: T.describe_structure(p, 8.0, 2.0, cfg),
             lambda: T.MaD(str(tmp_path))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
