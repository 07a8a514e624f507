#!/usr/bin/env python3
"""Ensemble conformer ranking at bench scale through the PyTorch / CUDA
port on one NVIDIA card: mad_tpu's scripts/ensemble_bench.py.

    python3 scripts/torch_ensemble_bench.py [workdir]

Seven conformers (the bench subunit and six ``deform_structure``
decoys at 3-15 A) are docked as one ensemble of 10 copies into the
10-copy bench map through the ``MaD`` session, and ``score_ensembles``
ranks them (``mad_tpu_torch.testing.run_ensemble_bench``). Exits 0 when
the true conformer ranks first by RWmCC, the MaD score. The session's
files go to ``workdir`` (a fresh temporary directory by default).
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mad_tpu_torch.testing import run_ensemble_bench  # noqa: E402


def main():
    if len(sys.argv) > 1:
        os.makedirs(sys.argv[1], exist_ok=True)
        ok = run_ensemble_bench(sys.argv[1])["ok"]
    else:
        with tempfile.TemporaryDirectory(prefix="ens_bench_") as root:
            ok = run_ensemble_bench(root)["ok"]
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
