"""Copied from mad_tpu/core/config.py: the configuration dataclasses only.

The original also sets JAX's global matmul precision and its compilation
cache at import time; none of that applies here. The port states its
float32 precision where it matters instead (``torch.backends`` flags in
``chip_smoke.py`` and the tests). TPU-only knobs (a static lane frame,
segmented and cascade refinement, compile warm-up) are kept so a config
built for either package round-trips field for field; ``UNREAD_FIELDS``
names them, the fields the port does not read. ``RefineConfig.field_dtype``
is read: ``refine_field_dtype`` states mad_tpu's rule for the
refinement's gradient field.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScaleSpaceConfig:
    """Scale-space construction (reference: mad/MapSpace.py:13,69-189)."""

    detect_sigma: float = 2.0      # sig_init: LoG / Gaussian sigma (voxels)
    presmooth_sigma: float = 1.0   # smoothing after x2 upsample
    map_padding: int = 9           # zero padding around the input grid
    oct_mode: str = "both"         # "base" | "up" | "both"
    truncate: float = 4.0          # Gaussian kernel truncation, in sigmas


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Anchor detection (reference: mad/Detector.py:18-123)."""

    threshold_abs: float = 5e-2    # min LoG response for a peak
    exclude_border: int = 12       # voxels excluded at each octave border
    max_offset: float = 0.6        # Newton subvoxel offset acceptance bound
    newton_iters: int = 5          # max Newton relocalization steps
    max_anchors: int = 4096        # per-octave anchor cap (top by response)


@dataclasses.dataclass(frozen=True)
class OrientConfig:
    """Orientation assignment (reference: mad/Orientator.py:13-110)."""

    eqsp_size: int = 112           # zones of the orientation histogram sphere
    max_main: int = 6              # max candidate dominant bins per anchor
    max_sec: int = 6               # max candidate secondary bins
    patch_size: int = 16           # full patch diameter (radius = patch_size//2)
    cutoff_magn: float = 1e-5      # gradient magnitudes below this count as 0
    gw_sig: float = 0.0            # optional Gaussian window sigma (0 = off)


@dataclasses.dataclass(frozen=True)
class DescribeConfig:
    """Descriptor generation (reference: mad/Descriptor.py:14-96)."""

    subeqsp_size: int = 16         # zones per subregion histogram
    subregions: int = 64           # 64 | 27 | 8 | 1 spatial subregions
    patch_size: int = 16           # lattice diameter (16**3 sample points)
    cutoff_magn: float = 1e-12     # normalize cutoff
    zero_magn: float = 1e-5        # samples below this excluded from counts
    max_descriptors: int = 16384   # per-octave descriptor cap
    static_lanes: int = 2048       # TPU lane frame (unused by the port)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching + pose scoring (reference: mad/MaD.py:414-453)."""

    cc_threshold: float = 0.6      # min cosine similarity between descriptors
    anchor_dist: float = 4.0       # repeatability correspondence radius (A)
    max_pairs: int = 65536         # cap on candidate pairs
    row_cap: int = 128             # per-subunit-descriptor pair candidates
    exact_top: int = 1024          # pairs re-scored with exact NN distances


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Pose clustering / filtering (reference: mad/MaD.py:456-553)."""

    weight_threshold: int = 4      # min cluster weight
    n_samples: int = 60            # top-by-repeatability poses clustered
    rmsd_cloud: float = 10.0       # cloud-RMSD threshold for a new cluster
    min_repeat: float = 5.0        # floor of the repeatability cut
    repeat_frac: float = 0.3       # keep clusters with repeat >= frac * best
    # Rescue rounds: after refinement, pairs whose map anchor no solution
    # explains get a fresh n_samples clustering budget under the same
    # gates. 0 = reference-parity output.
    rescue_rounds: int = 0


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Rigid-body refinement (reference: mad/structure_utils.py:58-161)."""

    n_steps: int = 500
    max_step: float = 1.0
    min_step: float = 0.1
    batch_size: int = 4            # steps between step-size halving checks
    dedup_rmsd: float = 6.0        # CA-RMSD merging threshold post-refine
    segment_steps: int = 128       # TPU lane compaction (unused by the port)
    cascade: bool = True           # TPU lane compaction (unused by the port)
    field_dtype: str = "float32"   # the refinement's gradient field:
                                   # "bfloat16" rounds it, below the gate of
                                   # refine_field_dtype


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    """Assembly building (reference: mad/MaD.py:192-223,632-843)."""

    max_models: int = 10
    max_overlap: float = 0.1
    sim_resolution: float = 5.0    # low-res sim for overlap grids
    sim_voxsp: float = 2.0
    sim_isovalue: float = 0.2
    cc_resolution: float = 4.0     # resolution for final model CC


@dataclasses.dataclass(frozen=True)
class MadConfig:
    """Full pipeline configuration with reference defaults."""

    scalespace: ScaleSpaceConfig = ScaleSpaceConfig()
    detect: DetectConfig = DetectConfig()
    orient: OrientConfig = OrientConfig()
    describe: DescribeConfig = DescribeConfig()
    match: MatchConfig = MatchConfig()
    filter: FilterConfig = FilterConfig()
    refine: RefineConfig = RefineConfig()
    assembly: AssemblyConfig = AssemblyConfig()
    warm_start: bool = True        # TPU compile warm-up (unused by the port)
    # Box granularity of simulated subunit grids (ops/simulate): it sets
    # the grid shape, hence the detector's border cut and the CCC box, so
    # it is part of the results and not only of the compile inventory.
    shape_bucket: int = 32

    def replace(self, **kw) -> "MadConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_run_kwargs(
        detect_sigma: float = 2.0,
        presmooth_sigma: float = 1.0,
        ori_eqsp_size: int = 112,
        dsc_eqsp_size: int = 16,
        dsc_subregions: int = 64,
        patch_size: int = 16,
        cc_threshold: float = 0.6,
        weight_threshold: int = 4,
        n_samples: int = 60,
        base: "MadConfig" = None,
    ) -> "MadConfig":
        """Build a config from the reference ``run()`` kwarg surface
        (parity with mad/MaD.py:87)."""
        base = base or MadConfig()
        return base.replace(
            scalespace=dataclasses.replace(
                base.scalespace,
                detect_sigma=detect_sigma,
                presmooth_sigma=presmooth_sigma,
            ),
            orient=dataclasses.replace(
                base.orient, eqsp_size=ori_eqsp_size, patch_size=patch_size
            ),
            describe=dataclasses.replace(
                base.describe,
                subeqsp_size=dsc_eqsp_size,
                subregions=dsc_subregions,
                patch_size=patch_size,
            ),
            match=dataclasses.replace(base.match, cc_threshold=cc_threshold),
            filter=dataclasses.replace(
                base.filter,
                weight_threshold=weight_threshold,
                n_samples=n_samples,
            ),
        )


# mad_tpu's config fields that the port does not read ("section.field", or
# "field" of MadConfig); none of them changes a result:
UNREAD_FIELDS = (
    "describe.static_lanes",   # a TPU lane frame; rows past it redo wider
    "refine.segment_steps",    # lane compaction, the same trajectories bit
    "refine.cascade",          # for bit (mad_tpu/engine/refine.py:203-213)
    "warm_start",              # compiles ahead of a TPU session
)

# mad_tpu packs the refinement's field into corner rows of 64 bytes (at
# bfloat16) when they take less than this (mad_tpu/engine/refine.py:86-92)
PACKED_FIELD_BYTES = 4 << 30
FIELD_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def refine_field_dtype(shape, field_dtype: str = "float32") -> torch.dtype:
    """The dtype of the refinement's gradient field over a map of ``shape``
    (mad_tpu's rule): bfloat16 when ``field_dtype`` asks for it and the
    map's X * Y * Z corner rows of 64 bytes take less than 4 GiB
    (67,108,864 voxels), where mad_tpu rounds the field into its packed
    rows; float32 otherwise, as mad_tpu's unpacked path is. mad_tpu takes
    any dtype name; the port only these two."""
    if field_dtype not in FIELD_DTYPES:
        raise ValueError(f"RefineConfig.field_dtype {field_dtype!r}: the "
                         f"port takes {' or '.join(FIELD_DTYPES)}")
    if (field_dtype != "float32"
            and math.prod(int(n) for n in shape) * 64 < PACKED_FIELD_BYTES):
        return torch.bfloat16
    return torch.float32


def bucket(n: int, b: int) -> int:
    """Round up to a multiple of b."""
    return ((int(n) + b - 1) // b) * b
