"""Generate docs/WALKTHROUGH_torch.ipynb, the walkthrough of the PyTorch /
CUDA port (mad_tpu_torch).

    python3 scripts/make_walkthrough_torch.py

It mirrors docs/WALKTHROUGH.ipynb (scripts/make_walkthrough.py) section
for section on the same synthetic self-fit systems, through the port's
modules; its fifth section holds the port's own notes (cards and meshes,
the kernels' build, the caches, the debugging switches, the refinement's
``field_dtype``). Every entry point runs on the card unless
MAD_WALKTHROUGH_DEVICE names another device (the CPU tests set "cpu").
tests/test_torch_walkthrough_slow.py executes every code cell on the CPU,
``chip_smoke.py`` on the card; tests/test_torch_notebooks.py checks that
this script reproduces the committed notebook byte for byte.
"""

import json
import os

MD = "markdown"
CODE = "code"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "docs",
                   "WALKTHROUGH_torch.ipynb")

CELLS = [(MD, """
# MaD on PyTorch and CUDA — walkthrough of `mad_tpu_torch`

This walkthrough contains what you need to run MaD through `mad_tpu_torch`,
the port of mad_tpu to PyTorch with hand-written CUDA kernels for an
NVIDIA H100. It mirrors the reference MaD walkthrough
(`MaD_notebook_instructions.ipynb`) and mad_tpu's own
(`docs/WALKTHROUGH.ipynb`) section by section; because the reference's
EMDB/PDB testing data is not redistributable, the runnable examples build
**synthetic self-fit systems** (simulated assemblies, the protocol of the
reference's own simulated dataset, notebook cell 22). Every cell runs
end-to-end on one card; set `MAD_WALKTHROUGH_DEVICE=cpu` to run it on the
CPU instead, with the kernels' plain PyTorch versions.

1. **Minimal examples**
    1. Homomultimer (synthetic trimer) + output explanation
    2. Heteromultimer (two distinct subunits)
2. **Tweaking parameters** — the reference's documented system matrix
3. **Ensemble docking**
4. **Anchor files**
5. **Notes on the port: cards, kernels, caches, debugging**

You'll find the solutions in the `individual_solutions` and
`assembly_models` subfolders within the folder created for your assembly,
inside the main `results` folder.
"""), (MD, """
## 1. Minimal examples

### A. Homomultimer

This minimal code predicts the assembly of a synthetic homotrimer from a
single monomer and a 8 Å map simulated from the trimer. As in the
reference protocol, `transform_subunits=True` first moves the subunit away
from its deposited pose (rotation + 150 Å translation), so recovering the
fit is unbiased (self-fit decoy protocol, reference
`structure_utils.py:30-56`).

For homomultimeric assemblies, only a single copy of the repeated
structure is required (`n_copies` tells MaD the stoichiometry).

Results are saved in the `results` folder; the folder name is built from
the map and component names, resolution, copies and isovalue. Re-running
the same system creates `..._1`, `..._2`, and so on. Descriptors are
cached in `dsc_db/` — restarting is faster because descriptors are loaded
instead of recomputed.

Every entry point of the port runs on the card (`device.resolve`: "cuda"
unless the caller names another device), and raises on a machine without
one: there is no silent fallback. The first cell names the device once and
passes it on.
"""), (CODE, """
import os
import numpy as np

from mad_tpu_torch.device import resolve

# The card, unless MAD_WALKTHROUGH_DEVICE names another device ("cpu" runs
# the kernels' plain PyTorch versions); unset without a card, this raises.
device = resolve(os.environ.get("MAD_WALKTHROUGH_DEVICE"))
workdir = os.environ.get("MAD_WALKTHROUGH_DIR", "walkthrough_results")
os.makedirs(workdir, exist_ok=True)

# --- synthetic system: a homotrimer and its simulated 8 A map ---
from mad_tpu_torch.testing import make_assembly
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.core.grid import write_mrc
from mad_tpu_torch.core.structure import write_pdb

subunit, copies = make_assembly(n_copies=3, n_res=60, seed=4, spread=18.0)
coords = np.concatenate([c.coords for c in copies])
masses = np.concatenate([c.masses for c in copies])
write_mrc(simulate_density(coords, 8.0, 2.0, masses=masses, device=device),
          os.path.join(workdir, "trimer_map.mrc"))
write_pdb(subunit, os.path.join(workdir, "subunit.pdb"))
"""), (CODE, """
from mad_tpu_torch import MaD

mad = MaD(workdir=workdir, device=device)
mad.add_map(os.path.join(workdir, "trimer_map.mrc"), resolution=8.0)
mad.add_subunit(os.path.join(workdir, "subunit.pdb"), n_copies=3)
mad.run(transform_subunits=True)
mad.build_assembly()
"""), (MD, """
#### Explanation of output

1. Descriptors are generated for all structures (anchor detection,
   orientation, description). If available in the database (`dsc_db`
   folder), descriptors are loaded instead.
2. Matching occurs:
   1. Local descriptor matching identifies pairs that may yield a valid
      transformation of the subunit into the density (one matrix product
      of the descriptor rows, then a hand-written top-pairs kernel).
   2. Filtering: ranking according to global anchor matching
      (repeatability), then clustering; one solution per cluster.
   3. Local rigid refinement fixes inaccuracies from anchor coordinates
      and orientations (every candidate and every step in one kernel
      launch on the card).
3. Scoring:
   * **Repeat** — repeatability, the percentage of anchors with a
     correspondence in the target density.
   * **Weight** — the size of the corresponding cluster (descriptor pairs
     agreeing with that localization).
   * **mCC** — map cross-correlation.
   * **RWmCC** — the product of the previous scores.
4. Assembly building is a combinatorial exploration respecting the target
   stoichiometry: pairwise overlaps (structural clashes estimated from
   co-located non-zero voxels) are printed as a table; candidate tuples
   rank by overlap and the best clash-free ones are CC-scored and written
   to `assembly_models/Model_*.pdb` with `complex_ranking.csv`.

Verify the recovered fit below: each copy of the trimer should be matched
by a solution within a couple of Å of CA-RMSD.
"""), (CODE, """
sols = mad.solutions["subunit"]
print(f"{len(sols)} solutions")
for i, c in enumerate(copies):
    best = min(s.structure.rmsd_ca_with(c) for s in sols)
    print(f"copy {i}: best CA-RMSD {best:.2f} A")
assert min(s.structure.rmsd_ca_with(c) for s in sols) < 4.0
"""), (MD, """
### B. Heteromultimer

Heteromers list several components; each is docked independently and the
assembly stage builds per-component subcomplexes, then combines them
across components (cartesian product, ranked on the card). Components can
have different copy numbers.
"""), (CODE, """
from mad_tpu_torch.testing import make_protein

# two distinct subunits placed side by side
a = make_protein(n_res=60, seed=7)
b = make_protein(n_res=80, seed=9)
a = a.with_coords(a.coords - a.coords.mean(0))
b = b.with_coords(b.coords - b.coords.mean(0) + np.array([34.0, 0.0, 0.0]))
coords = np.concatenate([a.coords, b.coords])
masses = np.concatenate([a.masses, b.masses])
write_mrc(simulate_density(coords, 8.0, 2.0, masses=masses, device=device),
          os.path.join(workdir, "hetero_map.mrc"))
write_pdb(a, os.path.join(workdir, "subA.pdb"))
write_pdb(b, os.path.join(workdir, "subB.pdb"))

het = MaD(workdir=workdir, device=device)
het.add_map(os.path.join(workdir, "hetero_map.mrc"), resolution=8.0)
het.add_subunit(os.path.join(workdir, "subA.pdb"), n_copies=1)
het.add_subunit(os.path.join(workdir, "subB.pdb"), n_copies=1)
het.run(transform_subunits=True)
het.build_assembly()
"""), (MD, """
## 2. Tweaking parameters

All examples above use default parameters — MaD is as plug-and-play as it
gets. The reference documents eight experimental systems and the few
parameter tweaks they need (`run_MaD.py:6-60`, notebook cells 7-20); the
same knobs exist here with the same names and defaults:

| System (EMDB / PDB) | Resolution | Tweaks | Why |
|---|---|---|---|
| RAG complex (EMD-7845 / 6dbl) | 5 Å | defaults | — |
| NMDA receptor (EMD-8581 / 5up2) | 6 Å | defaults | 5 hetero-subunits |
| VAT complex (EMD-3436 / 5g4f) | 7 Å | defaults | 6 copies |
| Actin:tropomyosin (EMD-5751 / 3j4k) | 8 Å | defaults | ×5 |
| Microtubule + kinesin (EMD-1340 / 2p4n) | 9 Å | `cc_threshold=0.5, n_samples=80` | poorly resolved kinesin, large voxels |
| MecA-ClpC (EMD-5609 / 3j3u) | 10 Å | `n_samples=100, cc_threshold=0.5` | MecA (~25 kDa) undockable |
| GluK2 (EMD-8290 / 5kuh) | 11.6 Å | `patch_size=24` | low resolution: larger descriptor support |
| β-galactosidase (EMD-2548 / 4ckd) | 13 Å | `n_samples=120, patch_size=12` | 3 Å voxels: shrink patch to 36 Å; Fabs undockable |

Guidance distilled from the reference:
* **`cc_threshold`** (default 0.6) — descriptor-matching cosine cut. Lower
  to 0.5 when density is poorly resolved so valid pairs survive.
* **`n_samples`** (default 60) — descriptor pairs consumed by clustering
  (per copy). Raise (80-120) together with lower `cc_threshold`.
* **`patch_size`** (default 16 voxels) — descriptor support diameter. At
  large voxel spacings shrink it (12) so the patch stays comparable to the
  subunit; at low resolution with small voxels, grow it (24).
* **minimum dockable size** — roughly 90-100 kDa at 13 Å resolution;
  smaller domains (Fabs, MecA) cannot be reliably docked at such
  resolutions.

The same tweaks apply through `run()` here:
"""), (CODE, """
# cc_threshold / n_samples / weight_threshold don't change the descriptors,
# so this run loads them from dsc_db and only redoes matching onwards.
# (patch_size DOES change descriptors and would recompute them.)
tweaked = MaD(workdir=workdir, device=device)
tweaked.add_map(os.path.join(workdir, "trimer_map.mrc"), resolution=8.0)
tweaked.add_subunit(os.path.join(workdir, "subunit.pdb"), n_copies=3)
tweaked.run(transform_subunits=True, cc_threshold=0.5, n_samples=80)
print(f"{len(tweaked.solutions['subunit'])} solutions with tweaked knobs")
"""), (MD, """
## 3. Ensemble docking

An ensemble is passed like any other structure: give `add_subunit` a
**folder** of PDB frames instead of a file. Each frame docks
independently; `score_ensembles()` aggregates the per-frame
`Solutions_refined_*.csv` tables and ranks conformers by mean
Repeatability / Weight / mCC / RWmCC (a 4-panel bar plot is saved as
`Plot_score_ensemble.png` where matplotlib imports).

For large stoichiometries (e.g. GroEL ×14 in the reference) skip
`build_assembly()` on the full ensemble: rank the conformers first, then
re-run MaD on the best frame alone and build the assembly from it.
"""), (CODE, """
ens_dir = os.path.join(workdir, "ensemble")
os.makedirs(ens_dir, exist_ok=True)
rng = np.random.default_rng(0)
write_pdb(subunit, os.path.join(ens_dir, "frame_a.pdb"))
jit = subunit.with_coords(
    subunit.coords + rng.normal(scale=0.4, size=subunit.coords.shape))
write_pdb(jit, os.path.join(ens_dir, "frame_b.pdb"))

ens = MaD(workdir=workdir, device=device)
ens.add_map(os.path.join(workdir, "trimer_map.mrc"), resolution=8.0)
ens.add_subunit(ens_dir, n_copies=3)
ens.run(transform_subunits=True)
rankings = ens.score_ensembles()
print(rankings)
"""), (MD, """
The ranking reports, per conformer:

* **R** — repeatability (percentage of corresponding anchors),
* **|clust|** — cluster size (descriptor pairs agreeing with a
  localization),
* **CC** — cross-correlation with the map,
* **S** — the merged score (their product).

The undeformed frame (`frame_a`) should rank at or near the top on S.
"""), (MD, """
## 4. Anchor files

Within `results/<system>/individual_solutions` you will find an
`anchor_files` folder with the anchors and descriptors behind each
solution (all ChimeraX/VMD-ready, same formats as the reference):

* `anchor_cor_<COMPONENT>_<IDX>.bld` — correspondences between component
  and map anchors that yielded solution IDX (cylinders).
* `anchor_hi/lo_<COMPONENT>_<IDX>.pdb` — coordinates of the anchors with
  valid descriptors; `hi` = component anchors, `lo` = map anchors.
* `anchor_ori_hi/lo_<COMPONENT>_<IDX>.bld` — dominant orientation arrows
  of those anchors.
* `corresp_anchors_<COMPONENT>_<IDX>.pdb` — corresponding anchors for a
  solution (useful during global matching even without valid
  descriptors).

Pre-refinement artifacts (`pre_solutions/` + `Solutions_filtered_*.csv`)
can be enabled with `mad.save_pre_solutions = True` before `run()`.
"""), (MD, """
## 5. Notes on the port: cards, kernels, caches, debugging

* **Several cards**: `MaD(workdir, mesh="auto")` builds a mesh over every
  card of the machine when there are two or more
  (`mad_tpu_torch.parallel.mesh.auto_mesh`) and runs on one card
  otherwise; `mesh=None` (the default) runs on one device. The describe
  stage splits each volume into slabs with halos (capacity mode), the dock
  splits descriptor pairs and pose candidates over the cards; the results
  equal the one-card run bit for bit.
* **Kernels**: every device stage is a hand-written CUDA kernel in
  `mad_tpu_torch/csrc/`. The first call that needs one builds them all
  with `nvcc` (one process per source, started together, then one link)
  into `mad_tpu_torch/_build/`, a directory git ignores, under a name
  hashed from the sources and flags, so an unchanged checkout builds once.
  The build needs the CUDA toolkit and a Hopper card (`sm_90a`). With
  `device="cpu"` nothing is built: each kernel's plain PyTorch version
  runs instead.
* **Descriptor cache**: `dsc_db/` holds descriptors keyed by all describe
  parameters, and `pose_db/` each docked subunit's solutions; they are
  HDF5 files (`.h5`, mad_tpu's datasets) where `h5py` imports and `.npz`
  files of the same names otherwise. Delete them to force recomputation.
* **NaN debugging**: `MAD_TPU_NANCHECK=1` checks each stage's outputs and
  raises naming the stages that produced a NaN or inf; with
  `MAD_TPU_NANCHECK=global` every kernel launch is synchronized and its
  floating inputs are checked, naming the kernel. `MAD_TPU_HBM=1` records
  each stage's peak device memory in the stage timings
  (`mad_tpu_torch.utils.profiling.show_timing`).
* **The refinement's gradient field**: `RefineConfig.field_dtype` is
  `"float32"` by default. `"bfloat16"` stores the field in bfloat16, half
  its memory and half the bytes the refinement kernel reads, on maps of
  fewer than 67,108,864 voxels, mad_tpu's gate; above it the field stays
  float32. The poses then follow the rounded field, as mad_tpu's do:
  ```python
  import dataclasses
  from mad_tpu_torch import MadConfig
  cfg = MadConfig()
  cfg = cfg.replace(refine=dataclasses.replace(cfg.refine,
                                               field_dtype="bfloat16"))
  mad = MaD(workdir, config=cfg)
  ```
"""), (CODE, """
import torch
from mad_tpu_torch.parallel.mesh import auto_mesh

mesh = auto_mesh() if device.type == "cuda" else None
print(f"{torch.cuda.device_count()} card(s); mesh = {mesh}")
# With >= 2 cards this runs the sharded pipeline:
if mesh is not None:
    sharded = MaD(workdir=workdir, mesh=mesh)
    sharded.add_map(os.path.join(workdir, "trimer_map.mrc"), resolution=8.0)
    sharded.add_subunit(os.path.join(workdir, "subunit.pdb"), n_copies=3)
    sharded.run(transform_subunits=True)
    print(f"sharded run: {len(sharded.solutions['subunit'])} solutions")
""")]


def cell(kind, src):
    return {
        "cell_type": kind,
        "metadata": {},
        "source": src.strip("\n").splitlines(keepends=True),
        **({"outputs": [], "execution_count": None} if kind == CODE else {}),
    }


def notebook() -> str:
    """The notebook's text, as written to docs/WALKTHROUGH_torch.ipynb."""
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
