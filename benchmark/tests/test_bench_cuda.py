"""On the card: a whole run of the small configuration through the
kernels, correct against the reference (run on the chip with
``python -m pytest -m cuda benchmark/tests``)."""

import time

import pytest

from harness import registry, runner

from conftest import small_traffic


@pytest.mark.cuda
@pytest.mark.parametrize("cell,mix", [("bench10.fit", "fit"),
                                      ("bench10.screen", "screen")])
def test_small_cell_on_the_card(tiny, card, cell, mix):
    t0 = time.perf_counter()
    out = runner.run_cell(registry.benchmark(), cell, 2 ** 31 + 3, 1.0,
                          True, card, lambda: time.perf_counter() - t0,
                          lambda m: None, config=tiny,
                          traffic=small_traffic(mix))
    assert out["correct"], out["check"]
    assert out["device"]["busy_s"] > 0
