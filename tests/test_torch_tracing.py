"""The port's tracer (``mad_tpu_torch.utils.profiling``): spans and
counters that record exactly while a ``torch.profiler`` does, on the
profiler's clock, and cost one flag read otherwise.

- off, a span neither enters a profiler range nor logs, and costs under
  1 us;
- on, each span's logged start and end lie within 100 us of its
  ``mad.*`` event in the profiler's trace (and in ``device_trace``'s file);
- parents and request ids nest as the calls do;
- counters move only while the profiler records;
- the dock stages are spans under their own names, their seconds those of
  the stage registry;
- ``match.pose_data`` counts the pairs, the distinct rows they take and
  the distinct anchors of those rows;
- a small dock gives the same solutions bit for bit with the profiler on
  and off, and with tracing off synchronizes nothing.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from mad_tpu_torch.convert import descriptor_set_from_numpy
from mad_tpu_torch.core.config import MadConfig, MatchConfig
from mad_tpu_torch.engine import docking
from mad_tpu_torch.engine.match import match_pairs
from mad_tpu_torch.engine.pipeline import describe_grid, describe_structure
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.testing import decoy_transform, make_assembly
from mad_tpu_torch.timing import stage
from mad_tpu_torch.utils import profiling

torch.set_num_threads(1)

RES, VOXSP = 8.0, 2.0
CLOCK_US = 100.0


def profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@profiling.spanned("second")
def second():
    torch.ones(8).sum()


def nested_calls():
    with profiling.span("outer"):
        profiling.tag(rows=3)
        with profiling.span("inner.a"):
            torch.ones(8).sum()
        with profiling.span("inner.b"):
            with profiling.span("leaf"):
                profiling.tag(found=2)
            profiling.tag(pairs=5)
        profiling.tag(done=1)
    second()


def test_off_a_span_enters_nothing_and_logs_nothing(monkeypatch):
    entered = []
    real = profiling._Range

    def spy(name, *args, **kw):
        entered.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(profiling, "_Range", spy)
    assert not profiling.tracing()
    nested_calls()
    profiling.count("launches")
    profiling.pull(torch.ones(3))
    assert entered == [] and profiling.spans() == []
    assert profiling.counters() == {}
    with profiler():
        with profiling.span("on"):
            pass
    assert entered == ["mad.on"]
    assert [r.name for r in profiling.spans()] == ["on"]


def test_off_a_span_costs_under_a_microsecond():
    span, n = profiling.span, 5_000

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with span("match.pose_data"):
                pass
        return (time.perf_counter() - t) / n

    # the least of many short loops: the cost itself, not the load that
    # other processes put on the host while it is measured
    best = min(loop() for _ in range(30))
    assert best < 1e-6, f"{best * 1e6:.3f} us a span"


def test_spans_on_the_profilers_clock(tmp_path):
    def events(prof):
        return sorted((e for e in prof.profiler.kineto_results.events()
                       if e.name().startswith("mad.")),
                      key=lambda e: e.start_ns())

    worst = []
    for _attempt in range(3):          # a preempted attempt is retried
        with profiler() as prof:
            nested_calls()             # first calls: lazy set-up
            profiling.clear_spans()
            nested_calls()
        evs = [e for e in events(prof)][-len(profiling.spans()):]
        log = profiling.spans()
        assert [e.name() for e in evs] == ["mad." + r.name for r in log]
        off = max(max(abs(r.start_ns - e.start_ns()),
                      abs(r.end_ns - e.start_ns() - e.duration_ns()))
                  for r, e in zip(log, evs))
        worst.append(off / 1e3)
        if off / 1e3 <= CLOCK_US:
            break
    assert min(worst) <= CLOCK_US, f"{worst} us"
    for r in log:
        assert r.start_ns <= r.end_ns
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("in_file"):
            pass
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert "mad.in_file" in names


def test_parents_and_requests_nest_as_the_calls_do():
    with profiler():
        nested_calls()
        nested_calls()
    log = profiling.spans()
    names = [r.name for r in log]
    assert names == ["outer", "inner.a", "inner.b", "leaf", "second"] * 2
    parents = [r.parent for r in log]
    assert parents == [-1, 0, 0, 2, -1, -1, 5, 5, 7, -1]
    requests = [r.request for r in log]
    assert len(set(requests)) == 4
    assert requests[:4] == [requests[0]] * 4 and requests[4] != requests[0]
    assert requests[5:9] == [requests[5]] * 4
    assert log[0].counts == {"rows": 3, "done": 1}
    assert log[2].counts == {"pairs": 5} and log[3].counts == {"found": 2}
    for r in log:
        if r.parent >= 0:
            p = log[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


def test_counters_move_only_while_the_profiler_records():
    profiling.count("launches")
    profiling.count("pull_bytes", 512)
    assert profiling.counters() == {}
    with profiler():
        profiling.count("launches")
        profiling.count("launches", 2)
        profiling.count("pull_bytes", 256)
        profiling.pull(torch.ones(4))     # a host tensor: no copy
    profiling.count("launches")
    assert profiling.counters() == {"launches": 3, "pull_bytes": 256}
    profiling.clear_spans()
    assert profiling.counters() == {} and profiling.spans() == []


def test_stages_are_spans_and_keep_their_seconds():
    profiling.show_timing(reset=True)
    timings = {}
    with profiler():
        with stage(timings, "match", "cpu"):
            sum(range(1000))
        with stage(None, "cluster", "cpu"):
            pass
        with profiling.stage("refine"):
            pass
    assert [r.name for r in profiling.spans()] == ["match", "cluster",
                                                   "refine"]
    assert timings["match"] == profiling.get_timings()["match"]
    assert "cluster" not in profiling.get_timings()
    profiling.show_timing(reset=True)


def test_pose_data_counts_the_distinct_rows():
    """Rows of 6 groups of descriptor columns: every same-group pair
    clears the threshold; the anchors sit on 5 and 9 points."""
    rng = np.random.default_rng(4)

    def rows(n, points, name):
        desc = np.zeros((n, 1024), np.int16)
        for i in range(n):
            desc[i, (i % 6) * 32:(i % 6 + 1) * 32] = rng.integers(20, 40, 32)
        coords = rng.normal(size=(points, 3))[np.arange(n) % points]
        return descriptor_set_from_numpy(
            desc=desc, coords=coords, map_coords=coords, subv_coords=coords,
            rfinal=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
            octave=np.zeros(n, np.int32), anchor_id=np.arange(n),
            main_bin=np.zeros(n, np.int32), sec_bin=np.zeros(n, np.int32),
            name=name, device="cpu")

    with profiler():
        pairs = match_pairs(rows(90, 9, "map"), rows(20, 5, "sub"),
                            MatchConfig())
    span = next(r for r in profiling.spans() if r.name == "match.pose_data")
    c = span.counts
    assert c == dict(pairs=len(pairs["rows"]),
                     hi_rows=len(np.unique(pairs["rows"])),
                     lo_rows=len(np.unique(pairs["cols"])),
                     hi_anchors=len(pairs["hi_cloud"]),
                     lo_anchors=len(pairs["lo_cloud"]))
    assert c["hi_anchors"] == 5 < c["hi_rows"] == 20 < c["pairs"] == 300
    assert c["lo_anchors"] == 9 < c["lo_rows"] == 90 <= c["pairs"]


@pytest.fixture(scope="module")
def dimer():
    """The SMALL dimer of chip_smoke.py with a rescue round."""
    c = MadConfig()
    cfg = c.replace(
        detect=dataclasses.replace(c.detect, max_anchors=1024),
        filter=dataclasses.replace(c.filter, rescue_rounds=1, n_samples=10))
    sub, copies = make_assembly(n_copies=2, n_res=40, seed=3, spread=14.0)
    coords = np.concatenate([x.coords for x in copies])
    masses = np.concatenate([x.masses for x in copies])
    dmap = simulate_density(coords, RES, VOXSP, device="cpu",
                            masses=masses).reduce_void()
    moved = decoy_transform(sub)
    m = describe_grid(dmap, cfg, name="map", device="cpu")
    return cfg, dmap, moved, m


def test_dock_the_same_with_the_profiler_on_and_off(dimer, monkeypatch):
    cfg, dmap, moved, m = dimer
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))

    def fit():
        s = describe_structure(moved, RES, VOXSP, cfg, name="sub",
                               device="cpu")
        return s, docking.dock_structure(m, s, moved, dmap, RES, cfg,
                                         verbose=False, n_copies=1,
                                         device="cpu")

    s_off, off = fit()
    assert syncs == [] and profiling.spans() == []
    with profiler():
        s_on, on = fit()
    assert syncs == []
    assert torch.equal(s_on.desc, s_off.desc)
    assert len(on) == len(off) >= 2
    for a, b in zip(on, off):
        assert a.structure.coords.tobytes() == b.structure.coords.tobytes()
        assert (a.weight, a.repeat, a.ccc) == (b.weight, b.repeat, b.ccc)
    log = profiling.spans()
    names = {r.name for r in log}
    assert {"describe_structure", "describe.simulate", "describe_grid",
            "describe.octave", "describe.rows", "describe.gather_norm",
            "dock_structure", "match", "match.similarity",
            "match.pose_data", "match.approx", "match.exact", "match.order",
            "cluster", "cluster.select", "cluster.candidates", "refine",
            "refine.starts", "post", "post.solutions", "score"} <= names
    dock = next(r for r in log if r.name == "dock_structure")
    assert dock.parent == -1
    assert dock.counts["solutions"] == len(on)
    assert dock.counts["rescue_rounds"] == 1
    assert dock.counts["pairs"] > 0 and dock.counts["candidates"] >= 2
    grid = next(r for r in log if r.name == "describe_grid")
    assert grid.counts["rows"] == s_on.n and grid.counts["anchors"] > 0
    i = log.index(dock)
    assert all(r.request == dock.request for r in log[i:])
