"""The port's native C parsers (mad_tpu_torch/native) against mad_tpu's
(mad_tpu/native/fastio.c): they build in the same places, give the same
atoms and fields on generated PDB files, on malformed and edge lines and
on printable-ASCII lines from hypothesis, and the same float64 values bit
for bit on Situs text; ``parse_pdb`` and ``read_map`` of a ``.sit`` file
go through them and equal the Python paths.

Where mad_tpu's own two parsers disagree (a 53-byte line, a 77-byte
line's element, ``1_0`` and ``0x1p3`` in a number field, a lone carriage
return: ROADMAP Queue 3), the port's native parser takes mad_tpu's
native side and its Python parser mad_tpu's Python side.
"""

import os
import string

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mad_tpu.core import structure as jstructure
from mad_tpu import native as jnative
from mad_tpu.core.grid import read_map as jread_map
from mad_tpu.native import get_fastio as jget_fastio
from mad_tpu.testing import make_protein
from mad_tpu_torch import native
from mad_tpu_torch.core import grid as tgrid
from mad_tpu_torch.core import structure as tstructure
from mad_tpu_torch.core.grid import DensityGrid, read_map, write_sit
from mad_tpu_torch.testing import recording

torch.set_num_threads(1)

LINE = ("ATOM      1  CA  ALA A   1      11.000  12.000  13.000  1.00  0.00"
        "           C")                                  # 78 bytes
HET = ("HETATM    2  O   HOH B   2      21.000  22.000  23.000  1.00  0.00"
       "           O")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's parsers, mad_tpu's extension); skipped where no C
    compiler runs, as tests/test_native.py is. For this module mad_tpu's
    extension builds into a directory of its own: mad_tpu builds through
    one temporary file of a fixed name in a shared cache, so processes
    that build it at once (test workers under a fresh HOME) race on that
    file, and the loser's ``get_fastio()`` stays None in its process."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_CACHE",
                   str(tmp_path_factory.mktemp("mad_tpu_native")))
        mp.setattr(jnative, "fastio", None)
        port, ref = native.get_fastio(), jget_fastio()
        assert (port is None) == (ref is None)
        if port is None:
            pytest.skip("no C toolchain")
        yield port, ref


def _ref_pdb(ref, data: bytes):
    (c, s, r, *fields) = ref.parse_pdb_bytes(data)
    return (np.frombuffer(c, np.float64).reshape(-1, 3),
            np.frombuffer(s, np.int64), np.frombuffer(r, np.int64), *fields)


def _same_pdb(port, ref, data: bytes):
    a, b = port.parse_pdb_bytes(data), _ref_pdb(ref, data)
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()          # NaN bits included
    assert list(a[3:]) == list(b[3:])
    return a


def _same_structure(a, b):
    assert a.coords.tobytes() == b.coords.tobytes()
    np.testing.assert_array_equal(a.masses, b.masses)
    np.testing.assert_array_equal(a.ca_idx, b.ca_idx)
    np.testing.assert_array_equal(a.bb_idx, b.bb_idx)
    assert a.info == b.info


def test_builds_from_the_repo_without_python_headers(both):
    port, _ref = both
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.name == "_build"
    assert "Python.h" not in native.SOURCE.read_text()
    assert native.get_fastio() is port           # built once a process


def test_parse_pdb_equals_mad_tpu(both, tmp_path, monkeypatch):
    """make_protein files, one with 4-character atom names and HETATM
    records: the port's parse_pdb (native), mad_tpu's (native) and both
    packages' Python parsers give one Structure."""
    plain = make_protein(n_res=50, seed=4)
    odd = make_protein(n_res=12, seed=5)
    odd.info = [list(row) for row in odd.info]
    for i, row in enumerate(odd.info):
        if i % 3 == 0:
            row[1] = "HG21"                         # 4-character name
        if i % 4 == 1:
            row[6] = "HETATM"
        if i % 5 == 2:
            row[5] = "FE"
    for s in (plain, odd):
        path = str(tmp_path / f"p{len(s.info)}.pdb")
        jstructure.write_pdb(s, path)
        with recording(tstructure, "_parse_pdb_native") as natives:
            a = tstructure.parse_pdb(path)
        assert len(natives) == 1
        for b in (jstructure.parse_pdb(path),
                  jstructure._parse_pdb_python(path),
                  tstructure._parse_pdb_python(path)):
            _same_structure(a, b)
    assert {r[1] for r in a.info} >= {"HG21"}
    assert {r[6] for r in a.info} == {"ATOM", "HETATM"}
    # without a C compiler the Python path gives the same Structure
    monkeypatch.setattr(tstructure, "get_fastio", lambda: None)
    _same_structure(tstructure.parse_pdb(path), a)


def _fixed(line: str, n: int) -> str:
    return (line + " " * 80)[:n]


EDGE_LINES = {
    # tests/test_native.py's malformed lines
    "header": "HEADER    junk",
    "bad atom": "ATOM   bad line",
    # line lengths around the 54-byte skip and the 78-byte element
    "53": _fixed(LINE, 53), "54": _fixed(LINE, 54),
    "77": LINE[:76] + "N", "78": LINE,
    "crlf": LINE + "\r",
    "lone cr": LINE[:60] + "\r" + LINE[61:],
    "  ATOM": "  " + LINE[:-2], "ATOMX": "ATOMX" + LINE[5:],
    "ATOM tab": "ATOM\t" + LINE[5:], "HETATM": HET,
    # number fields: strtol / strtod against Python's int and float
    "serial 1_0": LINE[:6] + "  1_0" + LINE[11:],
    "resnum 1_0": LINE[:22] + " 1_0" + LINE[26:],
    "x 0x1p3": LINE[:30] + "  0x1p3" + LINE[37:],
    "y inf": LINE[:38] + "     inf" + LINE[46:],
    "z nan": LINE[:46] + "     nan" + LINE[54:],
    "x -0.0": LINE[:30] + "    -0.0" + LINE[38:],
}


@pytest.mark.parametrize("newline", ["\n", "\r\n"])
def test_edge_lines_equal_mad_tpu(both, tmp_path, newline):
    port, ref = both
    for name, line in EDGE_LINES.items():
        data = (line + newline + LINE + newline).encode()
        _same_pdb(port, ref, data)
        path = tmp_path / "e.pdb"
        path.write_bytes(data)
        for t, j in ((tstructure._parse_pdb_native,
                      jstructure._parse_pdb_native),
                     (tstructure._parse_pdb_python,
                      jstructure._parse_pdb_python)):
            args = (port,) if t is tstructure._parse_pdb_native else ()
            _same_structure(t(str(path), *args),
                            j(str(path), *((ref,) if args else ())))
    _same_pdb(port, ref, b"")
    _same_pdb(port, ref, LINE.encode())            # no newline at the end


_PRINTABLE = string.printable


@st.composite
def pdb_text(draw):
    """Lines of printable ASCII: ATOM / HETATM records with random bytes
    put in, cut at random lengths, and random lines."""
    lines = []
    for _ in range(draw(st.integers(1, 12))):
        if draw(st.booleans()):
            line = list(draw(st.sampled_from([LINE, HET])))
            for _ in range(draw(st.integers(0, 6))):
                i = draw(st.integers(0, len(line) - 1))
                line[i] = draw(st.sampled_from(_PRINTABLE))
            line = "".join(line)[:draw(st.integers(40, 82))]
        else:
            line = draw(st.text(alphabet=_PRINTABLE, max_size=90))
        lines.append(line)
    sep = draw(st.sampled_from(["\n", "\r\n"]))
    return sep.join(lines).encode()


@settings(max_examples=300, deadline=None, database=None)
@given(data=pdb_text())
def test_printable_lines_equal_mad_tpu(data):
    port, ref = native.get_fastio(), jget_fastio()
    if port is None or ref is None:
        pytest.skip("no C toolchain")
    _same_pdb(port, ref, data)


def test_parse_floats_bit_for_bit(both):
    port, ref = both
    rng = np.random.default_rng(0)
    v = rng.normal(scale=10.0, size=4000) * rng.choice([1e-3, 1.0, 1e4],
                                                       4000)
    bodies = [
        b"",
        " ".join("%6.6f" % x for x in v).encode(),
        " ".join("%.17g" % x for x in v).encode(),
        " ".join("%.6e" % x for x in v).encode(),
        b"1.5 -2.25e1\n 3  \t4.0 .5 5. -0.0 +7 1e400 1e-400 0x1p3 inf -nan "
        b"12345678901234567890 0.12345678901234567890123 9007199254740993",
        b"x1.5y,2.5;;--3..4e 5e+ 6E-1z\x00 7 \x7f8",
    ]
    for body in bodies:
        a = port.parse_floats(body)
        b = np.frombuffer(ref.parse_floats(body), np.float64)
        assert a.dtype == np.float64 and a.tobytes() == b.tobytes(), body[:40]
    assert port.parse_floats(b"").shape == (0,)


def test_read_map_sit_equals_the_python_path(both, tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(9, 7, 11)).astype(np.float32)
    data[2, 3, 4] = 0.0
    g = DensityGrid(data=torch.as_tensor(data), origin=np.array(
        [3.0, -4.2, 10.5]), voxsp=1.4, name="m")
    path = str(tmp_path / "m.sit")
    write_sit(g, path)
    with recording(native.FastIO, "parse_floats") as floats:
        a = read_map(path, 0.0, device="cpu")
    assert len(floats) == 1
    monkeypatch.setattr(tgrid, "get_fastio", lambda: None)
    b = read_map(path, 0.0, device="cpu")
    assert a.data.numpy().tobytes() == b.data.numpy().tobytes()
    np.testing.assert_array_equal(a.origin, b.origin)
    ref = jread_map(path, 0.0)
    assert a.host().tobytes() == np.asarray(ref.data).tobytes()
    assert os.path.getsize(path) > 0
