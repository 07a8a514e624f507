"""The control at a test run's size: the reference computed in bfloat16,
put in the program's place, fails a limit that the program passes (on
the CPU here; ``benchmark/readings.py --control-seeds`` reads it on the
card at the cells' own sizes)."""

import pytest

from harness import check
from harness.cell import Cell

from conftest import small_traffic


@pytest.mark.parametrize("mix", ["fit", "screen"])
def test_control_is_not_correct(tiny, mix):
    cell = Cell(tiny, small_traffic(mix), 2 ** 31 + 5, "cpu")
    cell.setup()
    for j in range(max(cell.checked) + 1):
        cell.outs.append(cell.run_job(j))
    limits, names = tiny["limits"], check.required(cell)
    prog = check.numbers(cell)
    ctrl = check.numbers(cell, control=True)
    ok_prog, rows_prog = check.verdict(prog, limits, names)
    ok_ctrl, rows = check.verdict(ctrl, limits, names)
    assert ok_prog, rows_prog
    assert not ok_ctrl, rows
    assert ctrl["rows_differ"] > limits["rows_differ"]
    assert ctrl["ccc_gap"] > limits["ccc_gap"]
