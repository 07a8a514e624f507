"""The benchmark's own tests: the harness and the reference on the CPU,
and, marked ``cuda``, a small cell on the card (skipped without one).

    python -m pytest benchmark/tests            # from the checkout root
"""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def tiny():
    """A configuration of the bench's kind at a test run's size: 3 copies
    of a 60-residue subunit on a ring, its own limits those of bench10."""
    with open(Path(__file__).parent / "tiny_config.json") as f:
        return json.load(f)


def small_traffic(name: str) -> dict:
    """A mix of the registry cut to a test run: one map, one warm-up job,
    the checked jobs in the first round; a screen of the true subunit
    and one deformed conformer."""
    from harness import registry
    t = registry.traffic(name)
    t.update(warmup_jobs=1, check_rounds=1, maps=1)
    if "scales" in t:
        t["scales"] = t["scales"][:1]
    return t


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")
