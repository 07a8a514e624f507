"""Rigid-body gradient-ascent refinement of pose candidates (port of the
monolithic loop of mad_tpu/engine/refine.py:63-162).

Replaces structure_utils.refine_pdb (mad/structure_utils.py:58-161): up to
``n_steps`` alternating translation / rotation steps driven by the map's
density gradient, all candidates advancing together. Per step:
  * coords = (Y0 - center) @ rot + center + trans (center = initial
    centroid);
  * atoms outside the strict map interior contribute nothing;
  * translation steps move along the normalized force sum by step_size;
    rotation steps turn about the normalized torque by
    step_size / max distance from the centre;
  * every ``batch_size`` steps the step halves for candidates that moved
    less than it; a candidate freezes when its step drops below min_step,
    or when a NaN appears (then it is flagged failed, the reference's
    per-candidate abort, mad/structure_utils.py:97-98).
The loop itself is kernel K15 (:mod:`mad_tpu_torch.kernels.refine`): one
CUDA launch per call on the card, the plain PyTorch loop on the CPU.

``RefineConfig.field_dtype`` "bfloat16" stores the gradient field in
bfloat16 below mad_tpu's gate (``core.config.refine_field_dtype``): K3
writes the float32 differences rounded to nearest even, mad_tpu's
``pack_corners(field, "bfloat16")``, and K15 interpolates the rounded
values in float32, as ``trilinear_packed`` does (mad_tpu/engine/
refine.py:86-92, mad_tpu/ops/interp.py:37-82).

With a mesh (mad_tpu's ``_compiled_refine(mesh)``, the candidates sharded,
the map replicated) the gradient field is built once per distinct device,
the starts and their centroids once on the home device, and K15 runs on
each shard's block of candidates; its outputs gather on the home device,
where K16 reads them. Each candidate's loop is independent of the others,
so on the card the result is the single-device one bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.config import RefineConfig, refine_field_dtype
from ..core.geometry import norm3
from ..core.grid import DensityGrid
from ..kernels import refine as k15
from ..ops.scalespace import gradient
from ..parallel.mesh import Mesh, map_rows, replicate, run_device
from ..utils import profiling


@dataclass
class RefineResult:
    rot: np.ndarray           # (C, 3, 3) total rotation (about the centroid)
    trans: np.ndarray         # (C, 3) total translation
    coords: np.ndarray        # (C, N, 3) refined atom coordinates (float64)
    converged: np.ndarray     # (C,) bool
    steps: np.ndarray         # (C,) int32 active steps until convergence
    failed: np.ndarray        # (C,) bool: numerical failure (NaN guard)
    # K15's (rot, trans, coords, failed) as they are on the device, for K16
    device_out: Optional[tuple] = None


def map_inputs(dmap: DensityGrid, device, field_dtype: str = "float32"):
    """The map's part of the loop's inputs on ``device``: its gradient
    field, in the dtype ``refine_field_dtype`` gives for the map and
    ``field_dtype``, and the float32 [origin, hi bound, voxsp] bounds."""
    map_data = dmap.data.to(device=device, dtype=torch.float32)
    field = gradient(map_data,                   # np.gradient parity
                     refine_field_dtype(map_data.shape, field_dtype))
    origin = torch.as_tensor(np.asarray(dmap.origin, dtype=np.float32),
                             device=device)
    voxsp = torch.tensor(np.float32(dmap.voxsp), device=device)
    shape = torch.as_tensor(map_data.shape, device=device)
    hi_bound = origin + (shape - 1) * voxsp
    return field, torch.cat([origin, hi_bound, voxsp[None]])


def start_inputs(start_coords: np.ndarray, device):
    """The candidates' part on ``device``: the (C, N, 3) start coords,
    their centroids and the rotation-angle denominators."""
    y0 = torch.as_tensor(np.asarray(start_coords, dtype=np.float32),
                         device=device)
    N = y0.shape[1]
    center = y0.sum(dim=1, keepdim=True) / float(max(N, 1))  # (C, 1, 3)
    max_dist = norm3(y0 - center).amax(dim=1)
    angle_den = torch.clamp(max_dist, min=1e-6)
    return y0, center, angle_den


def refine_inputs(dmap: DensityGrid, start_coords: np.ndarray, device,
                  field_dtype: str = "float32"):
    """The loop's inputs on ``device``: the map's gradient field, the
    (C, N, 3) start coords, their centroids, the rotation-angle
    denominators and the float32 [origin, hi bound, voxsp] bounds."""
    field, bounds = map_inputs(dmap, device, field_dtype)
    return (field, *start_inputs(start_coords, device), bounds)


def refine_candidates(dmap: DensityGrid, start_coords: np.ndarray,
                      cfg: RefineConfig, device=None,
                      mesh: Optional[Mesh] = None) -> RefineResult:
    """Refine C candidate poses; start_coords is (C, N, 3) in Angstroms.
    With a mesh, over its shards' blocks of candidates (module docstring);
    ``device`` is then the mesh's home."""
    home = run_device(mesh, device, dmap.device)
    mesh = mesh or Mesh((home,))
    y0, center, angle_den = start_inputs(start_coords, home)
    maps = replicate(mesh, lambda d: map_inputs(dmap, d, cfg.field_dtype))
    rot, trans, coords, frozen, counts, failed = map_rows(
        mesh, y0.shape[0], lambda d, a, e: k15.refine_loop(
            maps[d][0], y0[a:e].to(d), center[a:e].to(d),
            angle_den[a:e].to(d), maps[d][1], cfg))
    pull = profiling.pull
    return RefineResult(
        rot=pull(rot).numpy(), trans=pull(trans).numpy(),
        coords=pull(coords).numpy().astype(np.float64),
        converged=pull(frozen).numpy(), steps=pull(counts).numpy(),
        failed=pull(failed).numpy(), device_out=(rot, trans, coords, failed))
