"""Forward pass of one octave: density grid -> descriptor matrix (port of
mad_tpu/engine/forward.py).

mad_tpu compiles this as one XLA program with static shapes (LoG,
gradient, detect, orient, a stable lane compaction, describe). Here it is
a plain function over the pipeline's own stages, sized from the real
counts: ``engine.pipeline.octave_lanes`` (K1's LoG, K4 + K5, K3, K6 and
its lane compaction, valid lanes in (anchor, main, sec) order), then K7 on
at most ``max_desc`` lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.config import MadConfig
from ..ops.describe import describe_anchors
from ..ops.scalespace import Octave
from .pipeline import octave_lanes


def build_forward(shape: Tuple[int, int, int], cfg: MadConfig,
                  max_anchors: int = 512, max_desc: int = 2048,
                  oct_mode: str = "base"):
    """Returns fn(grid) -> (desc, valid, coords, rfinal) for a float32
    (X, Y, Z) grid tensor, described as one base octave (mad_tpu's body
    describes the base octave whatever ``oct_mode`` says; so does this).

    mad_tpu returns ``max_desc`` lanes, the valid ones first; this returns
    only the oriented lanes, at most ``max_desc``, in the same order:
    ``desc`` (L, D) int16, ``valid`` (L,) the descriptor's validity,
    ``coords`` (L, 3) anchor voxels, ``rfinal`` (L, 3, 3) frames. ``shape``
    is the grid's shape, kept for mad_tpu's signature: nothing here is
    compiled for it."""
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 max_anchors=max_anchors))

    def forward(grid: torch.Tensor):
        octv = Octave(grid.to(torch.float32), 1.0, False, cfg.scalespace)
        lanes = octave_lanes(octv, cfg)
        coords = lanes.coords[:max_desc]
        rfinal = lanes.rfinal[:max_desc]
        desc, valid = describe_anchors(
            lanes.grad, coords, rfinal,
            torch.ones(coords.shape[0], dtype=torch.bool,
                       device=coords.device),
            octv.real_shape, False, cfg.describe)
        return desc, valid, coords, rfinal

    return forward
