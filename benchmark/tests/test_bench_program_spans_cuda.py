"""On the card: a traced run of the small configuration reports every
metric that reads the program's spans and counters, and the program's
``mad.*`` ranges are not among the device operations (run on the chip
with ``python -m pytest -m cuda benchmark/tests``)."""

import time

import pytest

from harness import program_spans, registry, runner
from mad_tpu_torch.utils import profiling

from conftest import small_traffic

NEW = ("match_idle_s", "dock_tail_idle_s", "describe_idle_s",
       "assembly_idle_s", "launches", "pulls")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,mix", [("bench10.fit", "fit"),
                                      ("bench10.screen", "screen")])
def test_program_spans_on_the_card(tiny, card, cell, mix, monkeypatch):
    traces = []

    def keep(prof, *a, **k):
        traces.append(runner_from_profiler(prof, *a, **k))
        return traces[-1]

    runner_from_profiler = runner.from_profiler
    profiling.clear_spans()     # the counters of this cell's window alone
    monkeypatch.setattr(runner, "from_profiler", keep)
    t0 = time.perf_counter()
    spec = registry.benchmark()
    out = runner.run_cell(spec, cell, 2 ** 31 + 5, 1.0, True, card,
                          lambda: time.perf_counter() - t0, lambda m: None,
                          config=tiny, traffic=small_traffic(mix))
    assert out["correct"], out["check"]
    want = {m["name"] for m in registry.metrics_of(spec, cell, "per_layer")
            if m["name"].split(".")[0] in NEW}
    assert len(want) == (6 if cell.endswith("fit") else 5)
    got = out["metrics"]
    assert want <= set(got), sorted(want - set(got))
    for name in want:
        assert got[name]["value"] >= 0, name
        if name.split(".")[0] in ("launches", "pulls"):
            assert got[name]["value"] > 0, name
    trace = traces[0]
    assert not [n for n, _s, _e in trace.device if n.startswith("mad.")]
    assert program_spans.program_log() is not None
