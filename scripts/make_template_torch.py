"""Generate docs/TEMPLATE_torch.ipynb, the blank-slate user template of the
PyTorch / CUDA port (mad_tpu_torch).

    python3 scripts/make_template_torch.py

It mirrors docs/TEMPLATE.ipynb (scripts/make_template.py), the reference's
``MaD_template.ipynb`` (add map, add components, run, build), through the
port, with a demo-inputs cell so that it runs as it is. Every entry point
runs on the card unless MAD_TEMPLATE_DEVICE names another device (the CPU
tests set "cpu"). tests/test_torch_walkthrough_slow.py executes every code
cell on the CPU, ``chip_smoke.py`` on the card;
tests/test_torch_notebooks.py checks that this script reproduces the
committed notebook byte for byte.
"""

import json
import os

MD = "markdown"
CODE = "code"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "docs",
                   "TEMPLATE_torch.ipynb")

CELLS = [(MD, """
# MaD template for `mad_tpu_torch` (PyTorch and CUDA)

Fill in your own inputs below and run the pipeline (the structure mirrors
the reference `MaD_template.ipynb`). The first cell builds a small
synthetic demo system so the template runs as-is; replace `map_file`,
`component_file`, `resolution` and `n_copies` with your own data. The
pipeline runs on the card; set `MAD_TEMPLATE_DEVICE=cpu` to run it on the
CPU instead.
"""), (CODE, """
import os
import numpy as np

from mad_tpu_torch.device import resolve

# The card, unless MAD_TEMPLATE_DEVICE names another device ("cpu" runs
# the kernels' plain PyTorch versions); unset without a card, this raises.
device = resolve(os.environ.get("MAD_TEMPLATE_DEVICE"))
workdir = os.environ.get("MAD_TEMPLATE_DIR", "template_results")
os.makedirs(workdir, exist_ok=True)

# --- replace with your own data ------------------------------------
# map_file = "/path/to/map.mrc";  resolution = 7.0;  n_copies = 6
# component_file = "/path/to/subunit.pdb"
# -------------------------------------------------------------------
# demo values: a synthetic homodimer and its simulated 8 A map
from mad_tpu_torch.testing import make_assembly
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.core.grid import write_mrc
from mad_tpu_torch.core.structure import write_pdb

subunit, copies = make_assembly(n_copies=2, n_res=60, seed=11, spread=14.0)
coords = np.concatenate([c.coords for c in copies])
masses = np.concatenate([c.masses for c in copies])
map_file = os.path.join(workdir, "demo_map.mrc")
component_file = os.path.join(workdir, "demo_subunit.pdb")
write_mrc(simulate_density(coords, 8.0, 2.0, masses=masses, device=device),
          map_file)
write_pdb(subunit, component_file)
resolution = 8.0
n_copies = 2
"""), (CODE, """
from mad_tpu_torch import MaD

# Make instance
mad = MaD(workdir=workdir, device=device)

# Add map (specify resolution after path), then add components
mad.add_map(map_file, resolution)

# Add component and specify number of copies
mad.add_subunit(component_file, n_copies=n_copies)

# Get solutions
mad.run(transform_subunits=True)

# Build assembly
mad.build_assembly()
""")]


def cell(kind, src):
    return {
        "cell_type": kind,
        "metadata": {},
        "source": src.strip("\n").splitlines(keepends=True),
        **({"outputs": [], "execution_count": None} if kind == CODE else {}),
    }


def notebook() -> str:
    """The notebook's text, as written to docs/TEMPLATE_torch.ipynb."""
    nb = {
        "cells": [cell(kind, src) for kind, src in CELLS],
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3.12"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }
    return json.dumps(nb, indent=1, ensure_ascii=False) + "\n"


if __name__ == "__main__":
    with open(OUT, "w", encoding="utf-8") as fh:
        fh.write(notebook())
    print(f"wrote {os.path.normpath(OUT)} ({len(CELLS)} cells)")
