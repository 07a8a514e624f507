#!/usr/bin/env python3
"""Scale stress through the PyTorch / CUDA port on one NVIDIA card:
mad_tpu's scripts/stress_large.py (16 subunits of 260 residues in one
map, spread 165, seed 1, one rescue round, 10 A at 1.4 A).

    python3 scripts/torch_stress_large.py [n_copies] [n_res] [spread]

The map's upsampled octave passes the 250 M voxel gate, so its gradient
field is bfloat16 (``ops/scalespace.BF16_VOXELS``). Prints the map's shape
and its octaves' fields, then each pass's seconds, solutions, models,
recovered copies (best CA-RMSD < 10 A), median best CA-RMSD and peak
device memory (``mad_tpu_torch.testing.run_stress``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mad_tpu_torch.testing import run_stress  # noqa: E402


def main():
    n_copies = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    n_res = int(sys.argv[2]) if len(sys.argv) > 2 else 260
    spread = float(sys.argv[3]) if len(sys.argv) > 3 else 165.0
    run_stress(n_copies=n_copies, n_res=n_res, spread=spread)


if __name__ == "__main__":
    main()
