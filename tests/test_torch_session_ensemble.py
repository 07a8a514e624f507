"""The port's ``MaD`` session with an ensemble folder: two frames of the
same subunit dock into the self-fit dimer of tests/test_api_e2e.py and
``score_ensembles`` ranks them from their Solutions_refined_*.csv files
(parity with mad/MaD.py:225-286 and the slow-tier ensemble test of
tests/test_api_e2e.py), on the CPU."""

import os

import numpy as np
import torch

from mad_tpu_torch.api import MaD
from mad_tpu_torch.core.grid import write_mrc
from mad_tpu_torch.core.structure import write_pdb
from mad_tpu_torch.ops.simulate import simulate_density
from mad_tpu_torch.testing import make_assembly

torch.set_num_threads(1)


def test_ensemble_frames_dock_and_rank(tmp_path):
    _sub, copies = make_assembly(n_copies=2, n_res=60, seed=4, spread=16.0)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    map_path = str(tmp_path / "dimer_map.mrc")
    write_mrc(simulate_density(coords, 8.0, 2.0, device="cpu", masses=masses),
              map_path)
    ens = tmp_path / "ensemble"
    ens.mkdir()
    write_pdb(copies[0], str(ens / "frame_a.pdb"))
    jitter = np.random.default_rng(0).normal(scale=0.3,
                                             size=copies[0].coords.shape)
    write_pdb(copies[0].with_coords(copies[0].coords + jitter),
              str(ens / "frame_b.pdb"))

    mad = MaD(workdir=str(tmp_path), device="cpu")
    mad.add_map(map_path, resolution=8.0)
    mad.add_subunit(str(ens), n_copies=2)
    mad.run(transform_subunits=True)
    assert sorted(mad.dsc_dict) == ["frame_a", "frame_b"]
    assert all(isinstance(v, str) and os.path.exists(v)
               for v in mad.dsc_dict.values())
    rankings = mad.score_ensembles()
    assert [r[0] for r in rankings["ensemble"]] == ["frame_a", "frame_b"]
    for row in rankings["ensemble"]:
        assert row[3] > 0.5          # mean mCC of a correct dock is high
    assert len(mad.buildable_subunits["ensemble"][1]) >= 4
