"""mad_tpu_torch -- PyTorch + CUDA port of mad_tpu, for one NVIDIA H100.

The public surface is mad_tpu's (mad_tpu/__init__.py), with its names and
signatures; every entry point also takes a keyword-only ``device``, the
card unless the caller names another (``device.resolve``):

    from mad_tpu_torch import MaD
    mad = MaD()
    mad.add_map("emd_3436.mrc", 7)
    mad.add_subunit("5g4f_subunit.pdb", n_copies=6)
    mad.run()
    mad.build_assembly()

Importing the package builds no kernel and touches no CUDA state: the
kernels build at their first CUDA call (``kernels/build.py``).
"""

from .api import MaD
from .core.config import MadConfig
from .core.grid import DensityGrid, read_map, write_mrc, write_sit
from .core.structure import Structure, parse_pdb, write_pdb
from .engine.pipeline import DescriptorSet, describe_grid, describe_structure
from .engine.docking import dock_structure, Solution
from .ops.simulate import simulate_density

__version__ = "0.1.0"

__all__ = [
    "MaD", "MadConfig", "DensityGrid", "Structure", "DescriptorSet",
    "Solution", "read_map", "write_mrc", "write_sit", "parse_pdb",
    "write_pdb", "describe_grid", "describe_structure", "dock_structure",
    "simulate_density",
]
