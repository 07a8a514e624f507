"""The readers of the program's spans and counters
(``harness/program_spans.py`` and the ``*_idle_s``, ``launches`` and
``pulls`` metrics) on a synthetic trace and a synthetic span log."""

from types import SimpleNamespace

import pytest

from harness import readers, registry
from harness.trace import Trace

from mad_tpu_torch.utils import profiling

IDLE = ("describe_idle_s.fit", "match_idle_s.fit", "dock_tail_idle_s.fit",
        "assembly_idle_s.fit")


def rec(name, s, e, parent=-1):
    return profiling.SpanRecord(name, int(s * 1e9), int(e * 1e9), parent, 0)


# device busy (1, 2), (4, 4.5), (6, 7), (9.5, 11) in a window (0, 10):
# idle (0, 1), (2, 4), (4.5, 6), (7, 9.5), 7 s of the window
DEVICE = [("k", 1.0, 2.0), ("k", 4.0, 4.5), ("copy", 6.0, 7.0),
          ("k", 9.5, 11.0)]
LOG = [
    rec("describe_structure", -1.0, 0.5),     # starts before the window
    rec("describe.simulate", -1.0, 0.2, 0),
    rec("describe_grid", 0.5, 3.0),
    rec("describe.octave", 0.5, 2.5, 2),
    rec("dock_structure", 3.0, 7.5),
    rec("match", 3.0, 4.6, 4),
    rec("match.pose_data", 3.5, 4.0, 5),
    rec("match.order", 4.6, 5.0, 4),          # a rescue round's re-ranking
    rec("cluster", 5.0, 5.5, 4),
    rec("refine.starts", 5.5, 5.75, 4),
    rec("refine", 5.75, 6.5, 4),
    rec("post", 6.5, 7.0, 4),
    rec("score", 7.0, 7.5, 4),
    rec("assembly.overlap", 8.0, 8.5),
    rec("assembly.enumerate", 8.5, 9.0),
    rec("match", 10.5, 12.0),                 # after the window
]
# per layer, idle seconds in the window: describe (0, 1) + (2, 3);
# match (3, 4) + (4.5, 5); dock tail (5, 6) + (7, 7.5); assembly (8, 9);
# outside every span (7.5, 8) + (9, 9.5)
WANT = {"describe_idle_s.fit": 2.0, "match_idle_s.fit": 1.5,
        "dock_tail_idle_s.fit": 1.5, "assembly_idle_s.fit": 1.0}
OUTSIDE = 1.0


def run_of(jobs=2, log=LOG, counters=None, monkeypatch=None):
    monkeypatch.setattr(profiling, "spans", lambda: list(log))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters or {}))
    return SimpleNamespace(trace=Trace(device=list(DEVICE), spans=[],
                                       window=(0.0, 10.0)),
                           jobs=[None] * jobs)


def test_idle_gaps_go_to_the_layer_whose_spans_hold_them(monkeypatch):
    run = run_of(monkeypatch=monkeypatch)
    for name, want in WANT.items():
        assert registry.reader(name)(run) == pytest.approx(want / 2)
    for name in ("match_idle_s.screen", "dock_tail_idle_s.screen",
                 "describe_idle_s.screen"):
        assert registry.reader(name)(run) == pytest.approx(
            WANT[name.replace("screen", "fit")] / 2)
    # a layer with no span in the log reads 0
    no_asm = [r for r in LOG if not r.name.startswith("assembly.")]
    run = run_of(log=no_asm, monkeypatch=monkeypatch)
    assert registry.reader("assembly_idle_s.fit")(run) == 0.0


def test_spans_are_clipped_to_the_window(monkeypatch):
    run = run_of(jobs=1, monkeypatch=monkeypatch)
    # the log's first span starts 1 s before the window, the last ends 2 s
    # after it: only their part inside counts
    assert registry.reader("describe_idle_s.fit")(run) == pytest.approx(2.0)
    assert registry.reader("match_idle_s.fit")(run) == pytest.approx(1.5)
    shifted = [rec("match", -5.0, 0.5), rec("match", 9.75, 20.0)]
    run = run_of(jobs=1, log=shifted, monkeypatch=monkeypatch)
    assert registry.reader("match_idle_s.fit")(run) == pytest.approx(0.5)


def test_layers_add_up_to_the_idle_share(monkeypatch):
    from harness import program_spans
    for jobs in (1, 2, 7):
        run = run_of(jobs=jobs, monkeypatch=monkeypatch)
        idle = readers.idle_pct(run) / 100.0 * 10.0 / jobs
        parts = sum(registry.reader(n)(run) for n in IDLE)
        outside = program_spans.idle_outside(run)
        assert outside == pytest.approx(OUTSIDE / jobs)
        assert parts + outside == pytest.approx(idle)
        assert idle == pytest.approx(7.0 / jobs)
    # idle time in the dock outside its stages is in no layer: the sum
    # falls short by it
    longer = [rec("dock_structure", 3.0, 8.0) if r.name == "dock_structure"
              else r for r in LOG]
    run = run_of(jobs=1, log=longer, monkeypatch=monkeypatch)
    parts = sum(registry.reader(n)(run) for n in IDLE)
    assert parts + program_spans.idle_outside(run) == pytest.approx(6.5)


def test_counters_per_job_and_none_without_a_log(monkeypatch):
    run = run_of(jobs=4, counters={"launches": 400, "pulls": 52,
                                   "pull_bytes": 4096},
                 monkeypatch=monkeypatch)
    for cell in ("fit", "screen"):
        assert registry.reader(f"launches.{cell}")(run) == 100.0
        assert registry.reader(f"pulls.{cell}")(run) == 13.0
    # a program that logged nothing (untraced, or without the tracer, as
    # the parent of this metric is): every reader returns None
    names = list(WANT) + ["launches.fit", "pulls.screen"]
    run = run_of(log=[], monkeypatch=monkeypatch)
    assert all(registry.reader(n)(run) is None for n in names)
    monkeypatch.delattr(profiling, "spans")
    run.trace = Trace(device=list(DEVICE), window=(0.0, 10.0))
    assert all(registry.reader(n)(run) is None for n in names)
    run = SimpleNamespace(trace=None, jobs=[None])
    monkeypatch.undo()
    assert all(registry.reader(n)(run) is None for n in names)
