"""Copied from mad_tpu/demo.py, on the card through the port's session.

Synthetic end-to-end demo session, mirroring the reference's canonical
usage script (run_MaD.py): build a synthetic trimer map, decoy-transform the
subunit, dock it back and build assembly models. The repo-root
``run_mad_tpu_torch.py`` delegates here, and so does the console entry
``mad-tpu-torch-demo``.
"""

import os
import tempfile

import numpy as np


def main(workdir=None, device=None):
    """device: None runs on the card ("cuda") and raises without one."""
    from mad_tpu_torch import MaD, simulate_density, write_mrc, write_pdb
    from mad_tpu_torch.device import resolve
    from mad_tpu_torch.testing import make_assembly

    device = resolve(device)
    workdir = (workdir or os.environ.get("MAD_TPU_DEMO_DIR")
               or tempfile.mkdtemp(prefix="mad_tpu_torch_demo_"))
    print(f"MaD> demo session in {workdir}")
    sub, copies = make_assembly(n_copies=3, n_res=80, seed=0, spread=24.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    dmap = simulate_density(coords, 8.0, 2.0, device=device, masses=masses)
    map_path = os.path.join(workdir, "trimer_map.mrc")
    sub_path = os.path.join(workdir, "trimer_subunit.pdb")
    write_mrc(dmap, map_path)
    write_pdb(copies[0], sub_path)

    mad = MaD(workdir=workdir, device=device)
    mad.add_map(map_path, resolution=8.0)
    mad.add_subunit(sub_path, n_copies=3)
    mad.run(transform_subunits=True)
    mad.build_assembly()
    print(f"MaD> demo artifacts under {workdir}")


if __name__ == "__main__":
    main()
