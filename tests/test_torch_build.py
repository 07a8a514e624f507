"""The CUDA library's C interface on the CPU, where nothing is built
(``mad_tpu_torch/kernels/build.py``).

* Every ``MAD_EXPORT int`` launcher of ``csrc/*.cu`` has its entry in
  ``build.SIGNATURES`` with its parameters' ctypes in order, the stream
  last. A missing parameter would leave ctypes to pass the stream as a C
  int: cut to 32 bits, the handle of a side stream is lost.
* ``build.launch`` refuses an argument list that does not fill every
  parameter but the stream.
* ``build.constants`` reads a source's ``constexpr int`` values, so the
  wrappers' copies of K2's and K3's tilings (which the tests' renderings
  of the kernels use) follow the sources.
"""

import ctypes
import re
import types

import pytest
import torch

from mad_tpu_torch.kernels import build
from mad_tpu_torch.kernels import gradient as k3
from mad_tpu_torch.kernels import upsample as k2


def _ctype(param):
    """The ctypes type of one C parameter declaration."""
    if "*" in param or "cudaStream_t" in param:
        return ctypes.c_void_p
    words = param.split()[:-1]                  # drop the name
    kind = " ".join(w for w in words if w not in ("const", "unsigned"))
    return {"int": ctypes.c_int, "float": ctypes.c_float,
            "double": ctypes.c_double, "long long": ctypes.c_longlong,
            "char": ctypes.c_byte}[kind]


def test_every_export_takes_its_stream_last():
    exports = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(
                r"MAD_EXPORT\s+int\s+(\w+)\s*\(([^)]*)\)", text):
            params = [p.strip() for p in params.split(",")]
            assert "cudaStream_t" in params[-1], (src.name, name)
            exports[name] = [_ctype(p) for p in params]
    assert exports.keys() == build.SIGNATURES.keys()
    for name, types_ in exports.items():
        assert build.SIGNATURES[name] == types_, name


def test_launch_fills_every_parameter(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: (
        types.SimpleNamespace(cuda_stream=(1 << 40) + 5)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: (
        __import__("contextlib").nullcontext()))

    def mad_upsample2(*args):
        seen.append(args)
        return 0

    mad_upsample2.argtypes = build.SIGNATURES["mad_upsample2"]
    dev = torch.device("cuda", 0)
    build.launch(mad_upsample2, dev, 1, 2, 3, 4, 5, 6)
    assert seen == [(1, 2, 3, 4, 5, 6, (1 << 40) + 5)]
    with pytest.raises(TypeError, match="5 arguments and the stream for 7"):
        build.launch(mad_upsample2, dev, 1, 2, 3, 4, 5)
    assert len(seen) == 1


def test_constants_follow_the_sources(monkeypatch, tmp_path):
    g = build.constants("gradient.cu")
    assert k3.FOOTPRINT == (g["kTY"], g["kTZ"]) and g["kTY"] == \
        g["kRows"] * g["kPer"]
    assert (k3.CHUNK, k3.AHEAD, k3.RING) == (g["kChunk"], g["kAhead"],
                                             g["kRing"])
    assert g["kPlane"] == (g["kTY"] + 2) * (g["kTZ"] + 2)
    u = build.constants("upsample.cu")
    assert k2.TILE == (u["kTX"], u["kTY"], u["kTZ"])
    (tmp_path / "t.cu").write_text(
        "constexpr int kA = 3, kB = kA * (4 + 1) / 2;  // kC = 1\n"
        "constexpr float kF = 0.5f;\n"
        "  constexpr int kD = kB % 4;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.constants("t.cu") == {"kA": 3, "kB": 7, "kD": 3}
