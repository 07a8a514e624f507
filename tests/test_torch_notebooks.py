"""The port's notebooks (docs/WALKTHROUGH_torch.ipynb,
docs/TEMPLATE_torch.ipynb) without running the pipeline: each parses and
every code cell compiles; no code cell imports JAX or mad_tpu (the port's
package, mad_tpu_torch, only); each generator
(scripts/make_{walkthrough,template}_torch.py) reproduces its committed
notebook byte for byte; and the first code cell, with its device variable
unset, asks for the card and raises on a machine without one (the CPU
tests name "cpu"). tests/test_torch_walkthrough_slow.py runs every cell.
"""

import ast
import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOKS = {
    "walkthrough": ("WALKTHROUGH_torch.ipynb", "make_walkthrough_torch.py",
                    "MAD_WALKTHROUGH_DEVICE", 7),
    "template": ("TEMPLATE_torch.ipynb", "make_template_torch.py",
                 "MAD_TEMPLATE_DEVICE", 2),
}


def _code_cells(name):
    with open(os.path.join(ROOT, "docs", NOTEBOOKS[name][0]),
              encoding="utf-8") as fh:
        nb = json.load(fh)
    assert nb["nbformat"] == 4
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_parses_and_cells_compile(name):
    cells = _code_cells(name)
    assert len(cells) == NOTEBOOKS[name][3]
    for i, src in enumerate(cells):
        compile(src, f"{name}-cell-{i}", "exec")


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_no_cell_imports_jax_or_mad_tpu(name):
    roots = set()
    for src in _code_cells(name):
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                roots.add(node.module.split(".")[0])
    assert "mad_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "mad_tpu"}, roots


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_generator_reproduces_the_notebook(name):
    nb_file, script, _var, _n = NOTEBOOKS[name]
    spec = importlib.util.spec_from_file_location(
        f"gen_{name}", os.path.join(ROOT, "scripts", script))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(os.path.join(ROOT, "docs", nb_file), encoding="utf-8") as fh:
        assert fh.read() == gen.notebook()
    assert os.path.samefile(gen.OUT, os.path.join(ROOT, "docs", nb_file))


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_first_cell_asks_for_the_card(name, tmp_path, monkeypatch):
    nb_file, _script, var, _n = NOTEBOOKS[name]
    monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    first = _code_cells(name)[0]
    assert f'os.environ.get("{var}")' in first
    with pytest.raises(RuntimeError, match="no CUDA card"):
        exec(compile(first, f"{name}-cell-0", "exec"), {})
    assert not os.listdir(tmp_path)
