"""A whole run on the CPU at a test run's size, the harness's look for a
card skipped: correct as it stands, and not correct with the timed path
broken underneath: half of the map's descriptor rows left out; the
refinement skipped (each candidate returned at its start pose); half of
the dock's solutions left out; each solution's CC altered where the dock
produces it; the assembly's ranking of tuples shifted by one; each
model's CC altered where the assembly scores it."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from harness import registry, runner

from conftest import small_traffic


def run(tiny, cell="bench10.fit", mix="fit", seed=2 ** 31 + 99):
    """One run; the screen's window holds its two checked conformers."""
    t0 = time.perf_counter()
    return runner.run_cell(registry.benchmark(), cell, seed,
                           0.5 if mix == "fit" else 3.0,
                           False, "cpu", lambda: time.perf_counter() - t0,
                           lambda m: None, config=tiny,
                           traffic=small_traffic(mix))


def failed(out, name):
    c = out["check"][name]
    return not out["correct"] and c["value"] > c["limit"]


def halve_rows(ds):
    n = ds.desc.shape[0] // 2
    cut = {f.name: getattr(ds, f.name)[:n] for f in dataclasses.fields(ds)
           if f.name in ("desc", "desc_norm", "coords", "map_coords",
                         "subv_coords", "rfinal", "octave", "anchor_id",
                         "main_bin", "sec_bin")}
    return dataclasses.replace(ds, n_rows=n, **cut)


@pytest.mark.parametrize("cell,mix", [("bench10.fit", "fit"),
                                      ("bench10.screen", "screen")])
def test_sound_run_is_correct(tiny, cell, mix):
    out = run(tiny, cell, mix)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and list(out)[-1] == "check"


def test_half_of_the_rows_left_out(tiny, monkeypatch):
    from mad_tpu_torch.engine import pipeline
    real = pipeline.describe_grid
    monkeypatch.setattr(pipeline, "describe_grid",
                        lambda *a, **k: halve_rows(real(*a, **k)))
    assert failed(run(tiny), "rows_differ")


def test_refinement_skipped(tiny, monkeypatch):
    from mad_tpu_torch.engine import docking, refine

    def unrefined(dmap, starts, cfg, device=None, mesh=None):
        C = starts.shape[0]
        dev = torch.device(device) if device is not None else dmap.device
        rot = torch.eye(3, device=dev).repeat(C, 1, 1)
        trans = torch.zeros((C, 3), device=dev)
        coords = torch.as_tensor(np.asarray(starts, np.float32), device=dev)
        bad = torch.zeros(C, dtype=torch.bool, device=dev)
        return refine.RefineResult(
            rot=rot.numpy(), trans=trans.numpy(),
            coords=coords.numpy().astype(np.float64),
            converged=np.ones(C, bool), steps=np.zeros(C, np.int32),
            failed=bad.numpy(), device_out=(rot, trans, coords, bad))
    monkeypatch.setattr(docking, "refine_candidates", unrefined)
    assert failed(run(tiny), "solutions_differ")


def test_half_of_the_solutions_left_out(tiny, monkeypatch):
    from mad_tpu_torch.engine import docking
    real = docking._finalize_solutions
    monkeypatch.setattr(docking, "_finalize_solutions",
                        lambda *a, **k: real(*a, **k)[::2])
    assert failed(run(tiny), "solutions_differ")


def test_solution_score_altered(tiny, monkeypatch):
    from mad_tpu_torch.engine import docking
    real = docking._finalize_solutions

    def altered(*a, **k):
        sols = real(*a, **k)
        for s in sols:
            s.ccc *= 1.01
        return sols
    monkeypatch.setattr(docking, "_finalize_solutions", altered)
    assert failed(run(tiny), "ccc_gap")


def test_tuples_ranked_wrong(tiny, monkeypatch):
    from mad_tpu_torch.engine import assemble
    real = assemble.enumerate_homomultimer
    monkeypatch.setattr(assemble, "enumerate_homomultimer",
                        lambda *a, **k: tuple(x[1:] for x in real(*a, **k)))
    assert failed(run(tiny), "models_differ")


def test_model_score_altered(tiny, monkeypatch):
    from mad_tpu_torch.engine import assemble
    real = assemble.score_models

    def altered(*a, **k):
        models = real(*a, **k)
        for m in models:
            m.ccc = float(np.float32(m.ccc * 1.01))
        return models
    monkeypatch.setattr(assemble, "score_models", altered)
    assert failed(run(tiny), "model_ccc_gap")
