"""K15: the rigid-body refinement loop, all steps of all candidates.

Replaces the loop of mad_tpu/engine/refine.py:63-162 (``_compiled_refine``,
with the trilinear gather of mad_tpu/ops/interp.py:37-82). The CUDA kernel
``csrc/refine.cu`` runs each candidate on a thread-block cluster through
every step, one pass over the atoms and one cluster barrier a step, with
the pose in every thread's registers, and exits when the candidate freezes
(its note says what bounds it); :func:`refine_loop_plain` is the plain
PyTorch version, a Python loop of batched tensor ops with one host sync
every ``batch_size`` steps.

Inputs of both: the (X, Y, Z, 3) float32 or bfloat16 gradient field
(bfloat16: ``RefineConfig.field_dtype``; each corner is widened to float32,
exactly, before the float32 interpolation, as mad_tpu's
``trilinear_packed`` does with its bfloat16 rows), the (C, N, 3)
float32 start coordinates ``y0``, their (C, 1, 3) centroids, the (C,)
rotation-angle denominators max(max_dist, 1e-6), and ``bounds``: float32
[origin (3), origin + (shape - 1) * voxsp (3), voxsp]. Outputs: rot
(C, 3, 3), trans (C, 3), coords (C, N, 3), frozen (C,) bool, steps (C,)
int32 and failed (C,) bool.
"""

from __future__ import annotations

import torch

from ..core.config import RefineConfig
from ..core.geometry import axis_angle_mat, norm3, unit
from ..ops.interp import trilinear
from . import build

launches = 0            # kernel launches since the last reset
bf16_launches = 0       # of those, launches on a bfloat16 field

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def refine_loop_plain(field: torch.Tensor, y0: torch.Tensor,
                      center: torch.Tensor, angle_den: torch.Tensor,
                      bounds: torch.Tensor, cfg: RefineConfig):
    device = y0.device
    C = y0.shape[0]
    field = field.float()                # bfloat16 widens exactly
    origin, hi_bound, voxsp = bounds[0:3], bounds[3:6], bounds[6]
    arm = y0 - center

    trans = torch.zeros((C, 3), dtype=torch.float32, device=device)
    rot = torch.eye(3, dtype=torch.float32, device=device).repeat(C, 1, 1)
    step_size = torch.full((C,), float(cfg.max_step), dtype=torch.float32,
                           device=device)
    prev = y0.clone()
    frozen = torch.zeros(C, dtype=torch.bool, device=device)
    failed = torch.zeros(C, dtype=torch.bool, device=device)
    counts = torch.zeros(C, dtype=torch.int32, device=device)

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
    return rot, trans, coords, frozen, counts, failed


def refine_loop(field: torch.Tensor, y0: torch.Tensor, center: torch.Tensor,
                angle_den: torch.Tensor, bounds: torch.Tensor,
                cfg: RefineConfig):
    """Refine C candidates; CPU tensors take the plain version."""
    if field.device.type == "cpu":
        return refine_loop_plain(field, y0, center, angle_den, bounds, cfg)
    global launches, bf16_launches
    if (field.dim() != 4 or field.shape[3] != 3
            or field.dtype not in _DTYPES or not field.is_contiguous()):
        raise ValueError(f"refine_loop: need a contiguous (X, Y, Z, 3) "
                         f"float32 or bfloat16 field, got "
                         f"{tuple(field.shape)} {field.dtype}")
    C, N = y0.shape[:2]
    if (y0.shape != (C, N, 3) or center.shape != (C, 1, 3)
            or angle_den.shape != (C,) or bounds.shape != (7,)):
        raise ValueError(f"refine_loop: bad shapes {tuple(y0.shape)}, "
                         f"{tuple(center.shape)}, {tuple(angle_den.shape)}, "
                         f"{tuple(bounds.shape)}")
    for t in (y0, center, angle_den, bounds):
        if t.dtype != torch.float32:
            raise ValueError(f"refine_loop: float32 inputs, got {t.dtype}")
    build.require_cuda("refine_loop", field, y0, center, angle_den, bounds)
    dev = field.device
    rot = torch.empty((C, 3, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((C, 3), dtype=torch.float32, device=dev)
    coords = torch.empty((C, N, 3), dtype=torch.float32, device=dev)
    frozen = torch.empty(C, dtype=torch.uint8, device=dev)
    failed = torch.empty(C, dtype=torch.uint8, device=dev)
    steps = torch.empty(C, dtype=torch.int32, device=dev)
    if C == 0:
        return rot, trans, coords, frozen.bool(), steps, failed.bool()
    X, Y, Z = field.shape[:3]
    build.launch(
        build.library().mad_refine, dev, field.data_ptr(),
        _DTYPES[field.dtype], X, Y, Z,
        y0.data_ptr(), C, N, center.data_ptr(), angle_den.data_ptr(),
        bounds.data_ptr(), int(cfg.n_steps), int(cfg.batch_size),
        float(cfg.max_step), float(cfg.min_step), rot.data_ptr(),
        trans.data_ptr(), coords.data_ptr(), frozen.data_ptr(),
        steps.data_ptr(), failed.data_ptr())
    launches += 1
    bf16_launches += field.dtype == torch.bfloat16
    return rot, trans, coords, frozen.bool(), steps, failed.bool()
