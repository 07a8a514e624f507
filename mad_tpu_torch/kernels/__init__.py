"""Hand-written CUDA kernels of the port, one wrapper module each.

Each module holds the kernel's wrapper, its plain PyTorch version and a
``launches`` counter (a module with more entries, one counter each, named
in ``COUNTERS``); the wrapper runs the plain version for CPU tensors
and the kernel for CUDA tensors (no fallback between the two). The CUDA
sources are in ``mad_tpu_torch/csrc`` and build on first use
(:mod:`.build`).
"""

from . import (approx, ccc, cluster, conv1d, crop_pad, describe, enumerate,
               field, gather_norm, gradient, hetero, localize, orient,
               overlap, pairs, peaks, post, refine, repeat, scatter,
               select_exact, upsample)

# name -> (wrapper module, CUDA source, the mad_tpu body it replaces), in
# the order of the bodies' K numbers (ROADMAP Queue 2)
KERNELS = {
    "conv1d": (conv1d, "mad_tpu_torch/csrc/conv1d.cu",
               "mad_tpu/ops/convolve.py:79"),
    "log_gauss": (conv1d, "mad_tpu_torch/csrc/conv1d.cu",
                  "mad_tpu/ops/convolve.py:144"),
    "upsample2": (upsample, "mad_tpu_torch/csrc/upsample.cu",
                  "mad_tpu/ops/convolve.py:184"),
    "gradient": (gradient, "mad_tpu_torch/csrc/gradient.cu",
                 "mad_tpu/ops/scalespace.py:238"),
    "peak_mask_compact": (peaks, "mad_tpu_torch/csrc/peaks.cu",
                          "mad_tpu/ops/detect.py:190"),
    "localize": (localize, "mad_tpu_torch/csrc/localize.cu",
                 "mad_tpu/ops/detect.py:125"),
    "orient": (orient, "mad_tpu_torch/csrc/orient.cu",
               "mad_tpu/ops/orient.py:212"),
    "descriptor_hist": (describe, "mad_tpu_torch/csrc/describe.cu",
                        "mad_tpu/ops/describe.py:79"),
    "gather_norm": (gather_norm, "mad_tpu_torch/csrc/gather_norm.cu",
                    "mad_tpu/engine/pipeline.py:229"),
    "scatter_atoms": (scatter, "mad_tpu_torch/csrc/scatter.cu",
                      "mad_tpu/ops/simulate.py:78"),
    "blur_divide": (conv1d, "mad_tpu_torch/csrc/conv1d.cu",
                    "mad_tpu/ops/simulate.py:103"),
    "blur_max": (conv1d, "mad_tpu_torch/csrc/conv1d.cu",
                 "mad_tpu/ops/simulate.py:105"),
    "simulate_scale": (scatter, "mad_tpu_torch/csrc/scatter.cu",
                       "mad_tpu/ops/simulate.py:105"),
    "pair_head": (pairs, "mad_tpu_torch/csrc/pairs.cu",
                  "mad_tpu/engine/match.py:74"),
    "pair_merge": (pairs, "mad_tpu_torch/csrc/pairs.cu",
                   "mad_tpu/engine/match.py:84"),
    "anchor_field": (field, "mad_tpu_torch/csrc/field.cu",
                     "mad_tpu/engine/match.py:94"),
    "approx_repeat": (approx, "mad_tpu_torch/csrc/approx.cu",
                      "mad_tpu/engine/match.py:126"),
    "exact_repeat": (repeat, "mad_tpu_torch/csrc/repeat.cu",
                     "mad_tpu/engine/match.py:176"),
    "cluster_select": (cluster, "mad_tpu_torch/csrc/cluster.cu",
                       "mad_tpu/engine/dock_fused.py:50"),
    "refine": (refine, "mad_tpu_torch/csrc/refine.cu",
               "mad_tpu/engine/refine.py:63"),
    "post": (post, "mad_tpu_torch/csrc/post.cu",
             "mad_tpu/engine/dock_fused.py:344"),
    "post_lanes": (post, "mad_tpu_torch/csrc/post.cu",
                   "mad_tpu/engine/dock_fused.py:374"),
    "post_lanes_dedup": (post, "mad_tpu_torch/csrc/post.cu",
                         "mad_tpu/engine/dock_fused.py:374"),
    "post_points": (post, "mad_tpu_torch/csrc/post.cu",
                    "mad_tpu/engine/dock_fused.py:419"),
    "post_rows": (post, "mad_tpu_torch/csrc/post.cu",
                  "mad_tpu/engine/dock_fused.py:433"),
    "post_compact": (post, "mad_tpu_torch/csrc/post.cu",
                     "mad_tpu/engine/dock_fused.py:438"),
    "batched_ccc": (ccc, "mad_tpu_torch/csrc/ccc.cu",
                    "mad_tpu/engine/score.py:31"),
    "pack_overlap": (overlap, "mad_tpu_torch/csrc/overlap.cu",
                     "mad_tpu/engine/assemble.py:123"),
    "enumerate_head": (enumerate, "mad_tpu_torch/csrc/enumerate.cu",
                       "mad_tpu/engine/assemble.py:338"),
    "hetero_head": (hetero, "mad_tpu_torch/csrc/enumerate.cu",
                    "mad_tpu/engine/assemble.py:500"),
    "select_exact": (select_exact, "mad_tpu_torch/csrc/select_exact.cu",
                     "mad_tpu/engine/match.py:224"),
    "axis_flags": (crop_pad, "mad_tpu_torch/csrc/crop_pad.cu",
                   "mad_tpu/core/grid.py:31"),
    "crop_pad": (crop_pad, "mad_tpu_torch/csrc/crop_pad.cu",
                 "mad_tpu/core/grid.py:45"),
}


# the counter of each entry of a module with several (default "launches"):
# K1's fused LoG passes and its blur epilogues (launches of the single-axis
# entry, which "conv1d" counts as well), K9's scale-and-clamp pass, K10's
# merge of the shards' heads, K16's lane, eligibility and compaction stages
# ("post" counts its dedup) and the lanes and dedup in one launch, K23 (K22
# shares its module)
COUNTERS = {"log_gauss": "log_launches", "blur_divide": "divide_launches",
            "blur_max": "max_launches", "simulate_scale": "scale_launches",
            "pair_merge": "merge_launches",
            "post_lanes": "lane_launches",
            "post_lanes_dedup": "fold_launches",
            "post_points": "point_launches", "post_rows": "row_launches",
            "post_compact": "compact_launches", "crop_pad": "pad_launches"}


# the entries that write (K3) or read (K6, K7) a bfloat16 gradient field,
# the octaves above scalespace.BF16_VOXELS: their ``bf16_launches`` count
# those launches beside ``launches``
BF16_ENTRIES = ("gradient", "orient", "descriptor_hist")


def reset_launches() -> None:
    for name, (mod, _src, _rep) in KERNELS.items():
        setattr(mod, COUNTERS.get(name, "launches"), 0)
    for name in BF16_ENTRIES:
        KERNELS[name][0].bf16_launches = 0


def bf16_counts() -> dict:
    return {name: KERNELS[name][0].bf16_launches for name in BF16_ENTRIES}


def launch_counts() -> dict:
    return {name: getattr(mod, COUNTERS.get(name, "launches"))
            for name, (mod, _s, _r) in KERNELS.items()}
