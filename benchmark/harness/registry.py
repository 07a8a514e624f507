"""Finds the pieces of a cell by name.

- a cell: an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
  the checkout, naming its configuration and its traffic;
- a configuration: ``benchmark/configs/<name>.json``;
- a traffic mix: ``benchmark/traffic/<name>.json``, parameters that the
  one generator (:mod:`harness.cell`) reads; its ``job`` names the chain
  of program calls a job makes, ``benchmark/jobs/<job>.py``;
- a per-layer metric: ``benchmark/metrics/<name>.py``, a reader with
  ``read(run)`` that returns a number, or None where it finds nothing;
- a system: ``benchmark/systems/<name>.py``, the builder of a
  configuration's maps (``make_map``), named by its ``system``'s
  ``builder`` (``homomer`` where it names none);
- a judge layer: ``benchmark/layers/<name>.py``, one of a job's ``LAYERS``:
  the numbers it gives and its comparison of a checked job's outputs with
  the reference (:mod:`harness.check` says what it holds).

A later cell, mix, configuration, system, job, layer or metric is a new
file and a new entry; nothing here names one. Each piece is looked for
under ``BENCH_DIR`` when it is asked for.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return load_json(path)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def metrics_of(spec: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _module(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module("metrics", name).read


def job(name: str):
    """The module ``jobs/<name>.py`` (:mod:`harness.cell` says what it
    holds)."""
    return _module("jobs", name)


def system(name: str):
    """The module ``systems/<name>.py``: ``make_map(system, assembly_seed,
    device)`` gives one map of the configuration as a
    :class:`harness.cell.MapInput`."""
    return _module("systems", name)


def layer(name: str):
    """The module ``layers/<name>.py`` (:mod:`harness.check` says what it
    holds)."""
    return _module("layers", name)
