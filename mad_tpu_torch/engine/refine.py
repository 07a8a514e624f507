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
The loop stops once every candidate is frozen; it checks that only at
step-halving boundaries (frozen candidates do not change, so the extra
steps are no-ops), one host sync per ``batch_size`` steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import RefineConfig
from ..core.geometry import axis_angle_mat, norm3, unit
from ..core.grid import DensityGrid
from ..ops.interp import trilinear
from ..ops.scalespace import gradient


@dataclass
class RefineResult:
    rot: np.ndarray           # (C, 3, 3) total rotation (about the centroid)
    trans: np.ndarray         # (C, 3) total translation
    coords: np.ndarray        # (C, N, 3) refined atom coordinates (float64)
    converged: np.ndarray     # (C,) bool
    steps: np.ndarray         # (C,) int32 active steps until convergence
    failed: np.ndarray        # (C,) bool: numerical failure (NaN guard)


def refine_candidates(dmap: DensityGrid, start_coords: np.ndarray,
                      cfg: RefineConfig, device=None) -> RefineResult:
    """Refine C candidate poses; start_coords is (C, N, 3) in Angstroms."""
    device = torch.device(device) if device is not None else dmap.device
    map_data = dmap.data.to(device=device, dtype=torch.float32)
    field = gradient(map_data)                   # np.gradient parity
    y0 = torch.as_tensor(np.asarray(start_coords, dtype=np.float32),
                         device=device)
    C, N = y0.shape[:2]
    origin = torch.as_tensor(np.asarray(dmap.origin, dtype=np.float32),
                             device=device)
    voxsp = torch.tensor(np.float32(dmap.voxsp), device=device)
    shape = torch.as_tensor(map_data.shape, device=device)
    hi_bound = origin + (shape - 1) * voxsp
    center = y0.sum(dim=1, keepdim=True) / float(max(N, 1))  # (C, 1, 3)
    arm = y0 - center
    max_dist = norm3(arm).amax(dim=1)

    trans = torch.zeros((C, 3), dtype=torch.float32, device=device)
    rot = torch.eye(3, dtype=torch.float32, device=device).repeat(C, 1, 1)
    step_size = torch.full((C,), float(cfg.max_step), dtype=torch.float32,
                           device=device)
    prev = y0.clone()
    frozen = torch.zeros(C, dtype=torch.bool, device=device)
    failed = torch.zeros(C, dtype=torch.bool, device=device)
    counts = torch.zeros(C, dtype=torch.int32, device=device)
    angle_den = torch.clamp(max_dist, min=1e-6)

    for step in range(cfg.n_steps):
        if step % cfg.batch_size == 0 and bool(frozen.all()):
            break
        coords = arm @ rot + center + trans[:, None]
        inb = ((coords > origin) & (coords < hi_bound)).all(dim=-1)
        vox = (coords - origin) / voxsp
        g = trilinear(field, vox) * inb.to(coords.dtype)[..., None]
        upd = ~frozen
        if step % 2 == 0:
            # Translation move (mad/structure_utils.py:109-116).
            dtrans = unit(g.sum(dim=1)) * step_size[:, None]
            trans = torch.where(upd[:, None], trans + dtrans, trans)
        else:
            # Rotation move (mad/structure_utils.py:119-138).
            torque = unit(torch.linalg.cross(g, coords - center,
                                             dim=-1).sum(dim=1))
            rstep = axis_angle_mat(torque, step_size / angle_den)
            rot = torch.where(upd[:, None, None], rot @ rstep, rot)
        new_coords = arm @ rot + center + trans[:, None]
        if (step + 1) % cfg.batch_size == 0:
            disp = norm3(prev - new_coords).amax(dim=1)
            shrink = (disp < step_size) & upd
            step_size = torch.where(shrink, step_size * 0.5, step_size)
            prev = torch.where(upd[:, None, None], new_coords, prev)
        finite = (torch.isfinite(new_coords).all(dim=2).all(dim=1)
                  & torch.isfinite(trans).all(dim=1))
        failed = failed | ~finite
        counts += upd.to(torch.int32)
        frozen = frozen | (step_size < cfg.min_step) | failed

    coords = arm @ rot + center + trans[:, None]
    return RefineResult(
        rot=rot.cpu().numpy(), trans=trans.cpu().numpy(),
        coords=coords.cpu().numpy().astype(np.float64),
        converged=frozen.cpu().numpy(), steps=counts.cpu().numpy(),
        failed=failed.cpu().numpy())
