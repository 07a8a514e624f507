"""The port's heteromer assembly (``engine/assemble.subcomplexes`` and
``build_heteromer``, the plain versions of K9, K18, K20 and K17 on the
CPU) against a plain reference that imports neither package
(``tests/plain_hetero.py``), on seeded random small structures: three
kinds, the second of two copies, 4-7 solutions a kind.

- ``host``: 5, 6 and 4 solutions, a product the host ranks;
- ``device``: 7 solutions a kind, the two-copy kind's 7 far apart so that
  none of its 21 pairs is left out: 7 x 21 x 7 = 1,029 tuples, past
  4 x 256, so K20's head ranks them and the host decodes the head.

Held: each kind's subcomplex tuples and the models' tuples equal; the
models' sum, std and max overlap within 1e-6 (float64 sums of the same
float32 fractions, whose occupancies both sides count exactly); the
models' CCs within 1e-5 (both simulate in float32 with the blur's sums
in another order, and correlate in float64: the gaps are ~1e-7). Traced,
the spans ``assembly.subcomplexes`` and ``assembly.enumerate_hetero`` and
the counters ``hetero_tuples`` and ``hetero_device_ranks``.
"""

import io

import numpy as np
import pytest
import torch

import plain_hetero as plain
from mad_tpu_torch.convert import structure_from_numpy
from mad_tpu_torch.core.config import AssemblyConfig
from mad_tpu_torch.core.structure import parse_pdb, write_complex, write_pdb
from mad_tpu_torch.engine import assemble as asm
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.testing import make_protein
from mad_tpu_torch.utils import profiling

torch.set_num_threads(1)

SUM_TOL, CCC_TOL = 1e-6, 1e-5
MAX_MODELS, MAX_OVERLAP = 10, 0.2
CFG = AssemblyConfig()

# each kind: residues, copies, solutions, radius of their spots (A)
CASES = {"host": [(30, 1, 5, 6.0), (36, 2, 6, 20.0), (42, 1, 4, 6.0)],
         "device": [(30, 1, 7, 6.0), (36, 2, 7, 60.0), (42, 1, 7, 6.0)]}


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _solutions(case):
    """Each kind's (n_copies, [Structure]): its subunit turned at random
    about spots on a circle about the origin, where the kinds meet."""
    rng = np.random.default_rng(sum(map(ord, case)))
    kinds = []
    for k, (n_res, n_copies, n_sol, radius) in enumerate(CASES[case]):
        sub = make_protein(n_res=n_res, seed=60 + k)
        coords = sub.coords - sub.coords.mean(axis=0)
        sols = []
        for j in range(n_sol):
            ang = 2 * np.pi * j / n_sol
            t = radius * np.array([np.cos(ang), np.sin(ang), 0.0])
            sols.append(structure_from_numpy(
                coords @ _rotation(rng) + t + rng.normal(scale=2.0, size=3),
                sub.masses, sub.ca_idx, sub.bb_idx, source=f"k{k}s{j}"))
        kinds.append((n_copies, sols))
    return kinds


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kinds = _solutions(request.param)
    truth = [s for n, sols in kinds for s in sols[:n]]
    dmap = simulate_density(np.concatenate([s.coords for s in truth]), 8.0,
                            2.0, masses=np.concatenate(
                                [s.masses for s in truth]), device="cpu")
    return request.param, kinds, dmap


def _port(kinds, dmap):
    subs = {f"k{k}": asm.subcomplexes(sols, n, CFG, MAX_OVERLAP, "cpu")
            for k, (n, sols) in enumerate(kinds)}
    models, flat = asm.build_heteromer(
        {key: s.structures for key, s in subs.items()}, dmap, CFG,
        MAX_MODELS, MAX_OVERLAP, "cpu")
    asm.pop_enum_notes()
    return subs, models, flat


def test_assembly_equals_plain(case):
    name, kinds, dmap = case
    subs, models, flat = _port(kinds, dmap)
    coords, masses, sizes = [], [], []
    for (n, sols), got in zip(kinds, subs.values()):
        tuples, sub_coords, sub_masses = plain.subcomplexes(
            [s.coords for s in sols], [s.masses for s in sols], n,
            MAX_OVERLAP)
        assert [tuple(t) for t in got.tuples.tolist()] == tuples
        coords += sub_coords
        masses += sub_masses
        sizes.append(len(tuples))
    for s, c in zip(flat, coords, strict=True):
        np.testing.assert_array_equal(s.coords, c)
    product = int(np.prod(sizes))
    assert (product > 4 * 256) == (name == "device"), sizes
    ranked = plain.rank(plain.overlap32(coords, masses), sizes, MAX_MODELS,
                        MAX_OVERLAP)
    assert [m.components for m in models] == [list(t) for t, _ in ranked]
    assert len(models) > 1
    for m, (_t, stats) in zip(models, ranked):
        np.testing.assert_allclose(
            [m.sum_overlap, m.std_overlap, m.max_overlap], stats, rtol=0,
            atol=SUM_TOL)
    cccs = plain.model_cccs(dmap.data.numpy(), dmap.origin, dmap.voxsp,
                            coords, masses, [t for t, _ in ranked])
    np.testing.assert_allclose([m.ccc for m in models], cccs, rtol=0,
                               atol=CCC_TOL)


def test_traced_spans_and_counters(case):
    name, kinds, dmap = case
    profiling.clear_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            subs, models, _flat = _port(kinds, dmap)
        log, counters = profiling.spans(), profiling.counters()
    finally:
        profiling.clear_spans()
    got = [r for r in log if r.name == "assembly.subcomplexes"]
    assert [r.counts for r in got] == [
        dict(solutions=len(sols), copies=n, subcomplexes=len(s.tuples))
        for (n, sols), s in zip(kinds, subs.values())]
    product = int(np.prod([len(s.tuples) for s in subs.values()]))
    (enum,) = [r for r in log if r.name == "assembly.enumerate_hetero"]
    on_device = int(name == "device")
    assert enum.counts == dict(tuples=product, on_device=on_device)
    assert counters["hetero_tuples"] == product
    assert counters["hetero_device_ranks"] == on_device
    # the heteromer's overlap, ranking and scores inside no subcomplex span
    (ov,) = [r for r in log if r.name == "assembly.overlap"
             and r.parent < 0 and r.counts["solutions"] == sum(
                 len(s.tuples) for s in subs.values())]
    assert enum.start_ns >= ov.end_ns and enum.parent < 0
    assert models


def test_subcomplex_is_what_write_complex_writes(tmp_path):
    parts = []
    for k, n_res in enumerate((12, 9, 15)):
        path = str(tmp_path / f"p{k}.pdb")
        write_pdb(make_protein(n_res=n_res, seed=k), path)
        parts.append(parse_pdb(path))
    merged = asm.merge_structures(parts)
    ours, theirs = str(tmp_path / "merged.pdb"), str(tmp_path / "parts.pdb")
    write_complex([merged], ours)
    write_complex(parts, theirs)
    assert io.open(ours).read() == io.open(theirs).read()
    again = parse_pdb(ours)
    np.testing.assert_array_equal(merged.ca_idx, again.ca_idx)
    np.testing.assert_array_equal(merged.bb_idx, again.bb_idx)
    np.testing.assert_array_equal(merged.masses, again.masses)
