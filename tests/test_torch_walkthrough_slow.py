"""Execute the port's notebooks cell by cell on the CPU
(docs/WALKTHROUGH_torch.ipynb, docs/TEMPLATE_torch.ipynb), as
tests/test_walkthrough.py does for mad_tpu's: every code cell runs, the
notebooks' own asserts hold (the homomer's best CA-RMSD below 4 A), the
ensemble ranking is not empty and the template writes its models.
``MAD_*_DEVICE=cpu`` is the caller's choice of device, the kernels' plain
PyTorch versions; ``chip_smoke.py`` runs the same cells on the card.
"""

import os

import pytest
import torch

from mad_tpu_torch.testing import run_notebook

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.mark.slow
def test_walkthrough_notebook_runs(tmp_path, monkeypatch):
    monkeypatch.setenv("MAD_WALKTHROUGH_DIR", str(tmp_path / "wt"))
    monkeypatch.setenv("MAD_WALKTHROUGH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    ns = run_notebook(os.path.join(ROOT, "docs", "WALKTHROUGH_torch.ipynb"),
                      "walkthrough")
    assert ns["device"] == torch.device("cpu")
    assert ns["rankings"] and all(ns["rankings"].values())
    assert ns["mesh"] is None


@pytest.mark.slow
def test_template_notebook_runs(tmp_path, monkeypatch):
    monkeypatch.setenv("MAD_TEMPLATE_DIR", str(tmp_path / "tpl"))
    monkeypatch.setenv("MAD_TEMPLATE_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    ns = run_notebook(os.path.join(ROOT, "docs", "TEMPLATE_torch.ipynb"),
                      "template")
    mad = ns["mad"]
    assert mad.solutions and mad.out_folder
    assert os.path.isdir(os.path.join(mad.out_folder, "assembly_models"))
