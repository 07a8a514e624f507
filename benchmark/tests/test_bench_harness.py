"""The harness on the CPU: the registry, the window, the trace
arithmetic, the percentile, the generators, and the command without a
card."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from harness import check, registry
from harness.cell import Cell, MapInput
from harness.stats import closed_loop, percentile
from harness.trace import Trace, gaps, innermost, intersect, total, union
from plainref import inputs

BENCH = Path(__file__).resolve().parent.parent


def test_every_piece_found_by_name():
    spec = registry.benchmark()
    names = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert Path(BENCH.parent / c["file"]).exists()
        assert registry.config(c["name"])["name"] == c["name"]
        system = registry.config(c["name"])["system"]
        assert callable(registry.system(
            system.get("builder", "homomer")).make_map)
    for w in spec["workloads"]:
        assert registry.workload(spec, w["name"]) is w
        assert w["config"] in names
        job = registry.job(registry.traffic(w["traffic"])["job"])
        limits = registry.config(w["config"])["limits"]
        for name in job.LAYERS:
            layer = registry.layer(name)
            assert set(layer.NUMBERS) <= set(limits)
            assert all(callable(getattr(layer, f))
                       for f in ("control", "compare", "fold"))
        assert all(callable(getattr(job, f))
                   for f in ("groups", "setup", "subunit", "run"))
        e2e = registry.metrics_of(spec, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        per = registry.metrics_of(spec, w["name"], "per_layer")
        assert per and {m["moves"] for m in per} <= {m["name"] for m in e2e}
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert callable(registry.reader(m["name"]))
    with pytest.raises(KeyError):
        registry.workload(spec, "no.such.cell")


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_counts_the_job_that_ends_it_and_a_stall_moves_it():
    clock = Clock()

    def job(i, stall_at=None):
        clock.t += 5.0 if i == stall_at else 1.0

    w = closed_loop(lambda i: job(i), 3.5, clock=clock)
    assert w.n == 4 and w.seconds == 4.0 and w.per_job() == 1.0
    clock.t = 0.0
    s = closed_loop(lambda i: job(i, stall_at=1), 3.5, clock=clock)
    assert s.n == 2 and s.job_s == [1.0, 5.0] and s.per_job() == 3.0


def test_busy_time_is_a_union():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert union(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert total(union(iv)) == 4.0
    t = Trace(device=[("k", s, e) for s, e in iv],
              spans=[("bench.job", 0.0, 10.0),
                     ("bench.describe_map", 2.0, 5.5)],
              window=(0.0, 10.0))
    assert t.busy_s() == 4.0
    assert t.busy_in("bench.describe_map") == pytest.approx(1.5)
    assert gaps(t.busy(), t.window) == [(3.0, 5.0), (6.0, 10.0)]
    assert dict(map(tuple, t.idle_by_span())) == {
        "bench.describe_map": 2.0, "bench.job": 4.0}
    assert t.top_ops() == [["k", 5.2]] or t.top_ops()[0][1] == \
        pytest.approx(5.2)
    assert intersect([(0.0, 1.0)], [(2.0, 3.0)]) == []
    assert innermost(t.spans, 20.0) == "no span"


def test_percentile_and_its_count():
    v = [float(i) for i in range(1, 101)]
    assert percentile(v, 95) == (95.0, 100)
    assert percentile([3.0], 95) == (3.0, 1)
    assert percentile([], 95) == (None, 0)


def _light_cell(traffic: dict, config: dict, seed: int) -> Cell:
    """A cell whose maps are the assemblies themselves (no simulation)."""
    c = Cell(config, traffic, seed, "cpu")
    s = config["system"]
    c.maps = []
    for a in config["assumed"]["assembly_seeds"][: c.n_maps]:
        sub, _copies, _ = inputs.make_assembly(s["n_copies"], s["n_res"], a,
                                               s["spread"], s["shell"])
        c.maps.append(MapInput(None, np.zeros(3), s["voxsp"], sub))
    return c


@pytest.mark.parametrize("mix", ["fit", "screen"])
def test_generator_follows_the_seed(tiny, mix):
    t = registry.traffic(mix)
    big = 2 ** 31 + 12345
    a = _light_cell(t, tiny, big)
    b = _light_cell(t, tiny, big)
    c = _light_cell(t, tiny, big + 1)
    g, rounds = a.groups, t["check_rounds"]
    jobs = list(range(-t["warmup_jobs"], 0)) + list(range(3 * g))
    seen = []
    for j in jobs:
        (m1, k1, x1), (m2, k2, x2) = a.job_inputs(j), b.job_inputs(j)
        assert (m1, k1) == (m2, k2) and np.array_equal(x1.coords, x2.coords)
        assert not np.array_equal(x1.coords, c.job_inputs(j)[2].coords)
        # the groups in turn, the warm-up's too
        assert (m1 if mix == "fit" else k1) == (j if j >= 0 else -1 - j) % g
        seen.append(x1.coords)
    # no job repeats another's inputs, in the window or in the warm-up
    for i in range(len(seen)):
        for k in range(i):
            assert not np.array_equal(seen[i], seen[k])
    # one checked job of each group, in the first rounds, drawn by the seed
    assert a.checked == b.checked
    assert sorted(j % g for j in a.checked) == list(range(g))
    assert max(a.checked) < g * rounds
    assert any(_light_cell(t, tiny, big + s).checked != a.checked
               for s in range(1, 9))


@pytest.mark.parametrize("name,gap", [("dock", "ccc_gap"),
                                      ("assembly", "model_ccc_gap")])
def test_a_nan_gap_fails_its_limit(tiny, name, gap):
    layer = registry.layer(name)
    nums = layer.fold({gap: [float("nan"), 1e-9],
                       "candidates": [], "solutions": [],
                       "models_differ": [0.0]})
    ok, rows = check.verdict(nums, tiny["limits"], layer.NUMBERS)
    assert not ok and np.isnan(nums[gap])


def test_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bench10.fit",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=BENCH.parent)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 3 and out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_benchmark_json_shape():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert all(w["chips"] == 1 for w in spec["workloads"])
    assert {m["name"] for m in spec["end_to_end"]} == {"setup_s", "fit_s",
                                                       "dock_s"}
