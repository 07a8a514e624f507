"""The judge's numbers and parts of the control (the reference computed in
bfloat16 in the program's place) on the tiny configuration, two seeds of
each mix, pinned bit for bit as the judge read them when its layers sat
in one module (``control_numbers.json``). Left out: ``ccc_gap`` and
``model_ccc_gap``, whose sums fall in an order that the number of CPU
threads sets (3 and 8 threads read them apart). The pin was read at 8
threads, and the test runs the judge at 8."""

import json
from pathlib import Path

import pytest
import torch

from harness import check
from harness.cell import Cell

from conftest import small_traffic

PINNED = json.loads((Path(__file__).parent / "control_numbers.json")
                    .read_text())


@pytest.fixture
def eight_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("key", sorted(PINNED))
def test_control_numbers_pinned(tiny, key, eight_threads):
    mix, seed = key.split(".")
    cell = Cell(tiny, small_traffic(mix), int(seed), "cpu")
    cell.setup()
    for j in range(max(cell.checked) + 1):
        cell.outs.append(cell.run_job(j))
    got = check.numbers(cell, control=True)
    assert {k: got[k] for k in PINNED[key]} == PINNED[key]
