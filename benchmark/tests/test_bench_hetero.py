"""The heteromer cell's pieces (``systems/heteromer.py``, ``jobs/hetero.py``,
``layers/hetero_assembly.py``, ``plainref/hetero.py``) through
``runner.run_cell`` on the CPU, at a test run's size: three kinds of 40,
50 and 60 residues, one copy each, one map. Correct as it stands; not
correct with the assembly broken underneath: one model's tuple shifted to
the next model's, one kind's solutions dropped from the assembly, one
model's CC raised by 1 %."""

import copy
import time

import numpy as np
import pytest

from harness import registry, runner
from layers import hetero_assembly

from conftest import small_traffic

CELL = "hetero5.hetero"


@pytest.fixture
def small(tiny):
    """hetero5's configuration at a test run's size, tiny's method and
    limits."""
    config = dict(copy.deepcopy(tiny), name="hetero_small")
    config["system"] = dict(
        builder="heteromer", res_per_segment=10, spread=30.0,
        kinds=[dict(n_res=n, n_copies=1) for n in (40, 50, 60)],
        resolution=10.0, voxsp=1.4, map_bucket=16, void_padding=10)
    return config


def run(config):
    t0 = time.perf_counter()
    lines = []
    out = runner.run_cell(registry.benchmark(), CELL, 2 ** 31 + 7, 0.5,
                          False, "cpu", lambda: time.perf_counter() - t0,
                          lines.append, config=config,
                          traffic=small_traffic("hetero"))
    return out, lines


def failed(out, name):
    c = out["check"][name]
    return not out["correct"] and c["value"] > c["limit"]


def test_sound_run_is_correct(small):
    out, lines = run(small)
    assert out["correct"], out["check"]
    assert set(out["check"]) == {"rows_differ", "candidates_differ",
                                 "solutions_differ", "ccc_gap",
                                 "models_differ", "model_ccc_gap"}
    assert set(out["metrics"]) == {"setup_s", "fit_s"}
    assert out["failed"] == 0
    # the dock layer judged each of the three kinds
    (sols,) = [x for x in lines if x.startswith("solutions (")]
    assert len(sols.split(": ", 1)[1].split(", ")) == 3


def test_model_tuple_shifted(small, monkeypatch):
    from mad_tpu_torch.engine import assemble
    real = assemble.build_heteromer

    def shifted(*a, **k):
        models, structures = real(*a, **k)
        assert len(models) >= 2 and models[0].components != \
            models[1].components
        models[0].components = list(models[1].components)
        return models, structures
    monkeypatch.setattr(assemble, "build_heteromer", shifted)
    assert failed(run(small)[0], "models_differ")


def test_kind_dropped_from_the_assembly(small, monkeypatch):
    from mad_tpu_torch.engine import assemble
    real = assemble.build_heteromer

    def dropped(groups, *a, **k):
        return real(dict(list(groups.items())[:-1]), *a, **k)
    monkeypatch.setattr(assemble, "build_heteromer", dropped)
    assert failed(run(small)[0], "models_differ")


def test_model_score_raised(small, monkeypatch):
    from mad_tpu_torch.engine import assemble
    real = assemble.score_models

    def raised(*a, **k):
        models = real(*a, **k)
        models[-1].ccc = float(np.float32(models[-1].ccc * 1.01))
        return models
    monkeypatch.setattr(assemble, "score_models", raised)
    assert failed(run(small)[0], "model_ccc_gap")


def test_kind_with_copies_is_named():
    comp = dict(kind=1, n_copies=2, sol_coords=np.zeros((3, 4, 3)))
    with pytest.raises(hetero_assembly.KindWithCopies, match="kind 1"):
        hetero_assembly.compare(None, dict(components=[comp], models=[]))
