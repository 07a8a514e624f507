#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (mad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) when it fails:
  1. device: needs torch.cuda.is_available() (there is no CPU path);
     prints the card's name and power limit, the torch and CUDA versions
     and whether h5py imports (the session's caches are HDF5 files where
     it does, .npz files otherwise); TF32 off for matmul and cuDNN;
  2. build: the hand-written kernels from mad_tpu_torch/csrc (one nvcc per
     source, all at once, then one link);
  3. warm pass of the main path, the whole of bench.py's run_fit: a
     10-copy assembly map (make_assembly(10, 260, seed 0, spread 115,
     shell), 10 A at 1.4 A, reduce_void), the map and a decoy subunit
     described, 10 copies docked with one rescue round, solutions
     CC-scored, then the assembly step: solution overlap, the C(n, 10)
     homomultimer ranking, up to 10 models CC-scored at 4 A;
  4. each kernel against its plain PyTorch version on the same CUDA
     tensors at the main path's shapes, with the tolerance of its tests
     (K1's single-axis entry along each axis of the upsampled octave and
     on a batch's 'full' blur, and its fused LoG of the octave, bit for
     bit; K9 on the bench map, the subunit, the solutions' and the
     models' batches, bit for bit with its plain version run on the CPU,
     five launches equal and its maxima equal to amax's, each timed beside
     index_add_ and index_put_(accumulate=True), whose grid is printed as
     bit-equal to K9's or not (index_put_ sorts its indices; not
     asserted); K6 on every anchor of both octaves, equal
     on every anchor, and on the base octave also at patch sizes 12 and
     24 and with a Gaussian window (>= 99 % of the anchors), each
     launched twice; K15 on the first-round candidates (its steps, and
     the kernel alone beside the wrapper); the matching
     front on the bench's pairs: K10's head, K11 and K14 equal, K12 equal
     on every pair (those with a moved anchor within 1e-4 voxel of a .5
     rounding edge counted, and among them those whose edge is on the
     pair's own anchor; its field reads, the in-grid anchors in a set
     cell of its coarse map, beside the 1.5 M moved anchors); K10's head
     also with max_pairs K10_CUT_PAIRS (fewer
     keys kept than its row heads hold); K13 on the match stage's head
     pairs and at K13_STRESS (groups of 32 anchors and map tiles repeat),
     equal except pairs with an anchor within 1e-4 A of the radius,
     counted; K14 also on a 4,000-row stress table (K14_STRESS) at
     the bench's rmsd_cloud, with every row its own cluster and with one
     cluster, equal to its plain version, alone beside the wrapper;
     the describe stage's K2 (the map's and the subunit's bases, all three
     axes in one launch, and ragged shapes cut from the map's base), K3
     (the upsampled Gaussian volume and ragged shapes cut from it, float32
     and bfloat16), both also with their 64-bit offsets forced on the
     ragged shapes, K5 (the fit's four LoG volumes with K4's peaks, in its
     flat form and in its offset form on the same seeds; each launch alone
     and wrapped, with its bound; then detect_anchors at each map octave)
     and K8 (the map's two octave tables and keep indices, the
     subunit's, both on its 16-byte path; the map's tables 2 bytes off
     alignment on its scalar path; the cache loader's call) bit for
     bit, at the inputs a describe_grid of the bench map gives them; K7 at
     the fit's four octaves (the map's and the subunit's upsampled and
     base octaves, as describe_grid and describe_structure call it: its
     lanes out of bounds, rows within K7's tolerance, the kernel alone
     beside the wrapper); K4 bit
     for bit at the fit's four LoG volumes (the map's and the subunit's
     upsampled and base octaves: the voxels above threshold, the kernel
     alone beside the wrapper) and at ragged cuts of the map's upsampled
     one, own rows off a 16-byte boundary in the offset form, and with a
     NaN beside K4_NAN_PEAKS of its peaks (those no peaks); K18 bit for
     bit on the fit's solutions and on 80 (the heteromer phase's count),
     the kernel alone beside the wrapper, torch.mm of the frame-placed
     occupancy (the counts only) as its library yardstick at both; K16
     (the first docking round's 28 lanes and the table rows the rescue
     round may take: hits, counts, accepted,
     slots and rows equal, moved anchors within 1e-12 A; the hits and rows
     also equal to cKDTree's on its poses; then each of its five stage
     entries, lanes, dedup ("post"), cloud points, table rows and
     compaction, against its plain version, and the fold of the lanes and
     the dedup that the round takes on one device, post_lanes_dedup,
     equal to the two entries bit for bit), K17 at both of
     its call sites (the solutions' score and score_models: CCC within
     1e-5) and the simulation body at the fit's five simulate calls
     (the map, the subunit, score, overlap, score_models: K9 with its
     maxima, K1's blur with its divide and max epilogues, the
     scale-and-clamp pass, bit for bit with the plain body whose scatter
     runs on the CPU; each call's time and peak memory beside the plain
     body's; at score_models' call the divide pass, the max pass and the
     scale-and-clamp pass against their plain versions), at the inputs one
     more bench fit gives them), both timed with CUDA events, beside the
     one PyTorch call that computes the same function where there is one
     (K10's head: torch.topk per row, then over the flat heads; K3:
     torch.gradient; K8: F.normalize of the gathered rows; K9: index_add_,
     and index_put_(accumulate=True) printed beside it), and the
     kernel's bound: the larger of the bytes it must move over 3.35 TB/s
     and the operations it does over 67 TFLOP/s (float32, no tensor cores;
     K14's, K16's and K17's over 34 TFLOP/s, float64); a kernel alone
     (K4, K5, K7, K8 at the map's and the subunit's call, K10's head,
     K11, K12, K13, K14, K15, K16's five entries, K18, K19, K20) is timed on
     preallocated buffers with the stream held back while the host
     enqueues its launches (kernel_ms; bare: the wrapper's launch
     recorded once and repeated alone); then describe_grid
     on the bench map with the kernels and with the plain versions of K1's
     LoG, K2, K3, K5, K8 and K23 must give the same DescriptorSet (desc,
     desc_norm, coords, subv_coords, rfinal) bit for bit; K21 bit for bit
     on the match stage's 46,848 repeatabilities at its n_use (1,024; one
     launch, and its three launches forced) and at n_use = P (three), and
     on K21_EDGE (ties at the n_use-th key, zeros of both signs, NaN,
     -inf; one launch, and three at n_use = P); K22 and K23 bit for bit on
     the unreduced bench map (its flags, also on a view of it off 16-byte
     alignment, and reduce_void's crop), the map's
     and the subunit's prepare (recorded during a describe) and a volume
     with NaN and -0.0 (edge_volume), each with its library call (K21:
     torch.topk of the keys with its three gathers, torch.sort of the keys
     and a slice printed beside it; K22: three torch.any reductions; K23:
     F.pad of the cropped view);
  5. timed pass of the main path (after one more warm pass) with every
     launch counter reset first;
     fails unless every kernel of the path launched (the mesh's entries,
     MESH_ONLY, none: K10's merge, K16's lane and dedup entries, which one
     device runs as the fold), K1 (both entries)
     at most K1_FIT_LAUNCHES times, K2 K2_FIT_LAUNCHES times (once a
     described structure), the solutions are
     finite, at least 9 of 10 copies are recovered (best CA-RMSD < 10 A)
     and at least one model comes back, with a finite CCC, its first
     model made of 10 distinct solutions, and no F.pad called on a CUDA
     tensor; then the fit once more with the
     plain versions of K1's LoG, K2, K3, K5, K6, K8, K15, the matching front
     (K10's head, K11, K12, K14, K21), K16, K17, K22 and K23 swapped in
     (stage seconds side by side), which must recover as many copies, and
     once with only K21, K22 and K23's plain versions, which must give the
     timed fit's solutions bit for bit;
  6. the same assembly on the same solutions with the plain versions
     (the simulation body, K1's blur, K17, K18, K19 and K20 with their
     plain overlap staging) swapped in on the card: the same
     tuples and model components, model CCCs within 1e-5, the overlap
     within its tolerance (the plain scatter's index_add_ adds with
     atomics on the card: testing.overlap_tolerance);
  7. the MaD session: the bench map and subunit written to a fresh
     workdir, add_map / add_subunit(n_copies=10) / run(transform_subunits)
     / build_assembly on the card; K1's LoG, K2, K3, K5, K6, K8, K15, K16
     and K17 must launch in its first run, >= 9/10 copies come back in the
     written sol_*.pdb files, one Solutions_refined CSV row per solution,
     model artifacts; a second run() must load the
     dsc_db and pose_db caches and give the same solutions; the C parsers
     (mad_tpu_torch/native) must build, and every parse_pdb call of the
     two runs go through them; then the host I/O, each a median of
     HOST_IO_REPS: parse_pdb of the bench subunit and of the sol_*.pdb
     files, native beside the Python parser (equal Structures),
     write_complex of the solutions, write_pdb of the subunit, the bench
     map's MRC write and read (bit for bit);
  8. a heteromer ranking (16^5 tuples over 80 solutions, seeded random
     overlap) with the counters reset first: K20 must launch (it stages
     the overlap itself), and the plain versions on the card must give
     the same tuples;
  9. a small two-copy fit through the card and through the CPU (plain
     versions) must recover the same copies at the same poses, and the
     assembly of the card's solutions on the card and on the CPU must
     agree as in phase 6;
 10. capacity mode: describe_grid of the bench map on a mesh of 4 and of
     3 shards that share the card (make_mesh(n, devices=["cuda:0"] * n)),
     the launch counters reset just before the first run of each, must
     give the single-device DescriptorSet bit for bit, launch K1-K7, and
     read no field with more rows than its slab's own plus twice the
     octave's largest halo; its seconds (median of 3) beside the
     single-device run's, with the peak memory of each; then the shard
     bodies' kernels at shard 1's inputs (the upsampled octave's build on
     its halo block, K4 and K5's offset forms, K6's, K7's), recorded during
     one more run, against their plain versions and timed with their
     bounds: the report rows sharded_scalespace, detect_shard, orient_shard
     and describe_shard, with their launches in the 4-shard run;
 11. the dock on a mesh: dock_structure on the bench fit's single-device
     DescriptorSets on 4 and on 3 shards of the card, the launch counters
     reset just before the first run of each, must give the single-device
     solutions bit for bit (coords, weights, repeat, CCC, matched anchors)
     and launch K10's head and its merge, K11-K16 and K16's stages; its
     seconds (median of 3) and peak memory beside the single-device
     dock's; then the SMALL dimer docked with a rescue round that clusters
     (RESCUE) on 4 and 3 shards, bit for bit, its rescue re-score (K13)
     and K16's row stage on the mesh; then the shard bodies at shard 1's
     inputs of the 4-shard bench dock against their plain versions and
     timed with their bounds (report rows match_pairs_shard, repeat_shard,
     dock_post_shard, refine_shard, and pair_merge, the merge entry, with
     torch.sort of the keys beside it); then MaD(mesh=) on 2 shards of
     the card through run on phase 7's inputs, the map and the subunit
     described afresh, must give phase 7's DescriptorSets and solutions
     bit for bit, and multichip_step(4) on the card at least one
     solution;
 12. the public surface and the regimes: mad_tpu_torch.__all__ must be
     mad_tpu's list (MAD_TPU_ALL) and every entry point's device
     keyword-only; the bench map written by write_mrc and by write_sit
     and read back by read_map(path, 0.0) must land on the card and equal
     the map (bit for bit from MRC, within SIT_TOL from Situs), the Situs
     read through the native parse_floats, whose values must equal
     np.fromiter's bit for bit (each parse's seconds); ccc_with,
     ccc_maps_scaled and overlap_fraction against a shifted copy must be
     finite; build_scale_space of the map must equal iter_octaves' fields
     bit for bit; build_forward on the prepared base volume must launch
     K1, K3, K4, K5, K6 and K7 and give describe_grid's base-octave rows,
     coords and frames bit for bit; functional.setup -> get_descriptors
     -> match_and_dock on the written files must recover >= 9/10 copies;
     the stage sanitizer (MAD_TPU_NANCHECK=1) must stay silent on a clean
     bench fit and, on the 48^3 map with one NaN voxel, match mad_tpu's
     test (NAN_STAGES) and name exactly the stages the CPU port and
     mad_tpu name there (NAN_STAGE_LIST), and global mode must name a
     kernel there;
     profiling (MAD_TPU_HBM=1) prints one fit's stage table, the same
     seconds as timing.stage's, with a peak for every stage; then
     mad_tpu's 20 documented regimes (testing.TOPOLOGY_REGIMES,
     KNOB_REGIMES, DEGRADATION_LADDER) through the port's runners on the
     card, each printed with its recovery, distinct solutions, median best
     CA-RMSD, map shape and seconds, at mad_tpu's own test gates: every
     topology all copies recovered and claiming distinct solutions, median
     below half its threshold; every knob regime at least half the copies
     in solutions, all recovered, median below half its threshold;
     noise_10pct 3/3 with a median below 2.5 A; the other rungs printed
     beside PARITY.md section 10's recovery (LADDER_PARITY), not asserted;
 13. the scale stress, mad_tpu's scripts/stress_large.py (STRESS: 16
     subunits of 260 residues, spread 165, seed 1, one rescue round, 10 A
     at 1.4 A; testing.build_system and timed_pass, bench.py's chain),
     after match_pairs' times on the bench fit's sets (unique_times;
     the sets are then freed): the map's shape beside mad_tpu's
     (STRESS_MAD_TPU); a warm pass that records the inputs of K3, K6, K7,
     K19 and match_pairs: its map's upsampled octave passes the 250 M
     voxel gate, so its gradient field must be bfloat16; at those inputs
     each K3 field (the one K6 and K7 read) bit for bit with the plain
     version, K6 agreeing on every anchor (frames within K6_RFINAL_TOL),
     K7 as in phase 4 (k7_checks, with times) and each K19 head equal to
     the plain version's; match_pairs and its two host np.unique calls
     timed on the stress's pairs; then, after a second warm pass, a
     timed pass with the launch counters reset first, which must give
     the first warm pass's solutions bit for bit, launch every kernel of
     the main path but STRESS_SKIP, and K3, K6 and K7 on a bfloat16
     field, describe the map's upsampled octave with a bfloat16 field,
     give finite solutions, recover at least STRESS_MIN of 16 copies and
     build a model with a finite CCC (the count and median printed
     beside mad_tpu's 16/16 and 0.11 A); then a pass with the gate
     raised above the octave, whose float32 field must recover the same
     copies; each pass's seconds and peak memory;
 14. the ensemble at bench scale, mad_tpu's scripts/ensemble_bench.py
     (testing.run_ensemble_bench): the bench map and seven conformers
     (conf_0 and six deform_structure decoys at 3-15 A) through the MaD
     session, 10 copies, on the card, the launch counters reset first;
     the session's kernels must launch and conf_0 be first by RWmCC, the
     other three scores printed beside PARITY.md (c)'s (ENSEMBLE_PARITY).
The last three lines are the kernel report (JSON), the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

RES, VOXSP, N_COPIES, N_RES, SPREAD, SEED = 10.0, 1.4, 10, 260, 115.0, 0
BENCH_MAP_SHAPE = (273, 276, 262)
T_START = time.perf_counter()   # reset by main()
RECOVER_RMSD, MIN_RECOVERED = 10.0, 9
HOST_IO_REPS = 3                # host I/O timings: median of this many calls
SMALL = dict(n_copies=2, n_res=40, seed=3, spread=14.0, res=8.0, voxsp=2.0)
SMALL_POSE_TOL = 0.5            # A, best CA-RMSD per copy, card vs CPU
CCC_TOL = 1e-5                  # model CCC, kernels vs plain / card vs CPU
K9_REPEATS = 5                  # K9 launches on the same inputs, all equal
# the fit's simulate calls, in order (ops/simulate._simulate_batch)
SIMULATE_CALLS = ("map", "subunit", "score", "overlap", "score_models")
K1_FIT_LAUNCHES = 40            # K1 launches (both entries) in the timed fit
K2_FIT_LAUNCHES = 2             # K2: one a described structure (map, subunit)
# K2 and K3 also at ragged shapes cut from the bench map's base: axes of 1,
# 2 and 3 samples, and tiles cut short on every axis
K2_SHAPES = ((1, 2, 3), (3, 1, 2), (2, 3, 1), (9, 17, 35), (5, 9, 67))
K3_SHAPES = ((2, 2, 2), (3, 2, 33), (35, 10, 37), (33, 9, 65))
HETERO = dict(n_per=16, n_groups=5, seed=12)
K6_AGREE, K6_RFINAL_TOL = 0.99, 1e-6   # anchors agreeing, frame max diff
# (at the default settings every anchor of both map octaves must agree)
# K6 also at the smaller and larger patches users run (24 is the 5kuh
# setting) and with a Gaussian window: (patch size, gw_sig)
K6_SETTINGS = ((12, 0.0), (24, 0.0), (16, 3.0))
K15_MEDIAN = 0.05               # A, median CA-RMSD kernel vs plain
REFINE_FLOPS = 160              # K15 flops per atom and step (both passes)
NEWTON_FLOPS = 120              # K5 flops per peak and active Newton step
SADDLE_FLOPS = 30               # K5 flops per peak of the saddle test
R2_FLOPS = 102                  # K14 float64 flops per (row, cluster) RMSD
# K14's stress table (testing.pose_table: 4,000 repeat-ordered rows around
# 60 centre poses) at the bench's rmsd_cloud, with every row its own
# cluster, and with one cluster
K14_STRESS = dict(n=4000, n_centers=60, seed=7, noise=0.6)
K14_STRESS_RMSD = (("default", 10.0), ("own", 1e-3), ("one", 1e9))
# K13's stress shape (testing.repeat_inputs: 1,024 poses of 400 subunit
# anchors over 5,000 map anchors), and K10's head with max_pairs cut below
# the bench's 46,848 row-head keys
K13_STRESS = dict(a_hi=400, a_lo=5000, n_pairs=1024, seed=15)
K10_CUT_PAIRS = 8192
APPROX_FLOPS = 20               # K12 flops per moved, rounded anchor
DIST_FLOPS = 9                  # K16 float64 flops per squared distance
POSE_FLOPS = 18                 # K16 float64 flops per atom of a centroid
K16_ANCHOR_TOL = 1e-12          # A, K16's moved anchors vs plain
K12_EDGE = 1e-4                 # voxel, K12's .5 rounding edge
# NVIDIA H100 SXM at 700 W: HBM bytes/s, and float32 and float64 flop/s
# outside the tensor cores (NVIDIA's data sheet), the denominators of each
# bound.
PEAK_BYTES_S, PEAK_F32_S, PEAK_F64_S = 3.35e12, 67e12, 34e12
HOLD_CYCLES = 20_000_000        # kernel_ms's spin, ~10 ms at the card's clock
# K4 (K5, K7) at the fit's four LoG volumes (describe_grid's two octaves,
# then describe_structure's), and K4 at ragged cuts of the map's upsampled one:
# (cut, own row0, own rows or None, x0), own rows off a 16-byte boundary
# where row0 * Y * Z is not a multiple of 4
K4_SHAPES = ("map upsampled", "map base", "subunit upsampled",
             "subunit base")
K4_CUTS = (((1, 2, 3), 0, None, 0), ((5, 9, 67), 0, None, 0),
           ((37, 29, 31), 1, 20, 17), ((64, 65, 63), 3, 50, 0),
           ((291, 294, 279), 5, 200, 40))
K4_RAGGED_THRESHOLD = -1.0      # every voxel of the LoG a candidate
K4_NAN_PEAKS = 16               # peaks given a NaN z neighbour
K18_HETERO_M = 80               # the heteromer phase's solution count
# K21 on a synthetic table: P rows whose n_use-th key lies inside a run of
# ties, with zeros of both signs, NaN and -inf ({value: rows}, the rest
# random), shuffled
K21_EDGE = dict(P=5000, n_use=1024, seed=21,
                values={100.0: 300, 75.0: 300, 50.0: 900, 25.0: 500, 0.0: 800,
                        -0.0: 800, float("nan"): 200, float("-inf"): 200})
REDUCE_PAD = 10                 # reduce_void's zeros_padding (bench.py)
ASSEMBLY_STAGES = ("overlap", "enumerate", "score_models")
# kernels the session's first run must launch (K1's LoG, K2, K3, K5, K6,
# K8, K15, K16, K17, K21; K22 and K23 as it loads the map)
SESSION_KERNELS = ("log_gauss", "upsample2", "gradient", "localize",
                   "orient", "gather_norm", "refine", "post_lanes_dedup",
                   "batched_ccc", "select_exact", "axis_flags", "crop_pad")
# capacity mode: the shard counts, the kernels its octave chain must
# launch, the DescriptorSet fields held bit for bit, and the report rows of
# the shard bodies: name -> (the kernels whose launches it counts, source,
# the mad_tpu body)
CAPACITY_SHARDS = (4, 3)
CAPACITY_KERNELS = ("conv1d", "log_gauss", "upsample2", "gradient",
                    "peak_mask_compact", "localize", "orient",
                    "descriptor_hist")
SET_FIELDS = ("coords", "map_coords", "subv_coords", "rfinal", "octave",
              "anchor_id", "main_bin", "sec_bin")
# the dock on a mesh: the shard counts, the kernels its dock must launch,
# the rescue case (the SMALL dimer docked with one copy asked for and 10
# samples a round, so that the first round finds one copy and the rescue
# round, which clusters, the other) and the report rows of the shard
# bodies: name -> (the kernels whose launches it counts, source, the
# mad_tpu body)
DOCK_SHARDS = (4, 3)
# entries that only a mesh runs (on one device the merge of the shards'
# heads is not needed, and K16's lanes and dedup are one launch, the fold);
# their launches in the report are the 4-shard dock's
MESH_ONLY = ("pair_merge", "post_lanes", "post")
DOCK_KERNELS = ("pair_head", "pair_merge", "anchor_field", "approx_repeat",
                "select_exact", "exact_repeat", "cluster_select", "refine",
                "post",
                "post_lanes", "post_points", "post_rows", "post_compact")
RESCUE = dict(n_copies=1, n_samples=10)
DOCK_ROWS = {
    "match_pairs_shard": (("pair_head", "pair_merge"),
                          "mad_tpu_torch/csrc/pairs.cu",
                          "mad_tpu/engine/match.py:251"),
    "repeat_shard": (("approx_repeat", "exact_repeat"),
                     "mad_tpu_torch/csrc/approx.cu",
                     "mad_tpu/engine/match.py:160"),
    "dock_post_shard": (("post_lanes", "post_points", "post_rows"),
                        "mad_tpu_torch/csrc/post.cu",
                        "mad_tpu/engine/dock_fused.py:455"),
    "refine_shard": (("refine",), "mad_tpu_torch/csrc/refine.cu",
                     "mad_tpu/engine/refine.py:164"),
}
CAPACITY_ROWS = {
    "sharded_scalespace": (("conv1d", "log_gauss", "upsample2",
                            "gradient"),
                           "mad_tpu_torch/csrc/conv1d.cu",
                           "mad_tpu/parallel/volume.py:79"),
    "detect_shard": (("peak_mask_compact", "localize"),
                     "mad_tpu_torch/csrc/peaks.cu", "mad_tpu/ops/detect.py:236"),
    "orient_shard": (("orient",), "mad_tpu_torch/csrc/orient.cu",
                     "mad_tpu/ops/orient.py:369"),
    "describe_shard": (("descriptor_hist",), "mad_tpu_torch/csrc/describe.cu",
                       "mad_tpu/ops/describe.py:179"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*a):
    print(*a, flush=True)


# -- phase 1 --------------------------------------------------------------

def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port's smoke run needs one CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(smi)
    try:
        import h5py
        h5 = f"h5py {h5py.__version__}: the caches are .h5 files"
    except ImportError:
        h5 = "no h5py: the caches are .npz files"
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; {h5}")
    return torch.device("cuda:0"), smi


# -- phase 2 --------------------------------------------------------------

def build_phase():
    from mad_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    say(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s)")
    # per kernel: its registers, shared memory, stack frame and spills
    entry = ""
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "stack frame" in line or "registers" in line:
            say(f"  ptxas {entry[:72]}: {line.split(':', 1)[-1].strip()}")


# -- main path ------------------------------------------------------------

def bench_config():
    import dataclasses
    from mad_tpu_torch.core.config import MadConfig
    cfg = MadConfig()
    return cfg.replace(filter=dataclasses.replace(cfg.filter,
                                                  rescue_rounds=1))


def run_fit(device, timings, cfg, n_copies=N_COPIES, n_res=N_RES,
            seed=SEED, spread=SPREAD, res=RES, voxsp=VOXSP, shell=True):
    """bench.py's run_fit through the port (testing.build_system and
    fit_pass): the map simulated, described, docked, and the assembly
    step (testing.assemble_solutions) when there are two solutions or
    more; fit_pass's dict with the copies and the map."""
    from mad_tpu_torch.testing import build_system, fit_pass
    sub, copies, dmap = build_system(n_copies, n_res, voxsp, res, spread,
                                     seed, shell, device=device,
                                     timings=timings)
    return dict(fit_pass(sub, copies, dmap, res, cfg, device=device,
                         timings=timings), copies=copies, dmap=dmap)


def assembly_swaps():
    """The plain PyTorch versions of the kernels the assembly step launches
    (the simulation body: K9, K1's blur with its epilogues and the
    scale-and-clamp pass; K17, K18, K19 and K20, whose plain versions
    stage the overlap with sym_trim_plain), as (module, name, plain
    function)."""
    import mad_tpu_torch.ops.convolve as convolve
    import mad_tpu_torch.ops.simulate as simulate
    from mad_tpu_torch.kernels import (ccc, conv1d, enumerate as k_enum,
                                       hetero, overlap)
    return [(simulate, "_simulate_batch", simulate.simulate_batch_plain),
            (convolve, "conv1d_along", conv1d.conv1d_along_plain),
            (ccc, "batched_ccc", ccc.batched_ccc_plain),
            (overlap, "pack_overlap", overlap.pack_overlap_plain),
            (k_enum, "enumerate_head", k_enum.enumerate_head_plain),
            (hetero, "hetero_head", hetero.hetero_head_plain)]


def orient_refine_swaps():
    """The plain PyTorch versions of K6 and K15."""
    from mad_tpu_torch.kernels import orient as k6, refine as k15
    return [(k6, "orient", k6.orient_plain),
            (k15, "refine_loop", k15.refine_loop_plain)]


def match_swaps():
    """The plain PyTorch versions of the matching front: K10's head, K11,
    K12, K21 (engine/match.py) and K14 (engine/docking.py)."""
    from mad_tpu_torch.engine import docking, match
    from mad_tpu_torch.kernels import (approx, cluster, field, pairs,
                                       select_exact as k21)
    return [(match, "pair_head", pairs.pair_head_plain),
            (match, "anchor_field", field.anchor_field_plain),
            (match, "approx_repeat", approx.approx_repeat_plain),
            (match, "select_exact", k21.select_exact_plain),
            (docking, "cluster_select", cluster.cluster_select_plain)]


def select_pad_swaps():
    """The plain PyTorch versions of K21 (engine/match.py), K22 and K23
    (core/grid.py's reduce_void and padded, ops/scalespace.py's
    prepare) among fit_swaps()."""
    from mad_tpu_torch.kernels import crop_pad, select_exact
    return [sw for sw in fit_swaps()
            if sw[2].__module__ in (crop_pad.__name__, select_exact.__name__)]


def describe_swaps():
    """The plain PyTorch versions of the describe stage's K1 LoG, K2, K3, K5
    and K8 at each of their call sites (the refinement's map field and the
    cache loader's unit rows included), and of the map build's K22 and
    K23."""
    from mad_tpu_torch import convert
    from mad_tpu_torch.core import grid
    from mad_tpu_torch.engine import pipeline, refine
    from mad_tpu_torch.kernels import (conv1d, crop_pad as k23,
                                       gather_norm as k8, gradient as k3,
                                       localize as k5, upsample as k2)
    from mad_tpu_torch.ops import convolve, detect, scalespace
    return [(convolve, "log_gauss", conv1d.log_gauss_plain),
            (scalespace, "upsample2", k2.upsample2_plain),
            (pipeline, "gradient", k3.gradient_plain),
            (refine, "gradient", k3.gradient_plain),
            (detect, "localize_peaks", k5.localize_peaks_plain),
            (detect, "localize", k5.localize_plain),
            (pipeline, "gather_norm", k8.gather_norm_plain),
            (convert, "gather_norm", k8.gather_norm_plain),
            (grid, "axis_flags", k23.axis_flags_plain),
            (grid, "crop_pad", k23.crop_pad_plain),
            (scalespace, "crop_pad", k23.crop_pad_plain)]


def post_ccc_swaps():
    """The plain PyTorch versions of K16 (engine/docking.py) and K17 (its
    wrapper module, which engine/score.py calls through)."""
    from mad_tpu_torch.engine import docking
    from mad_tpu_torch.kernels import ccc, post
    return [(docking, "post", post.post_plain),
            (ccc, "batched_ccc", ccc.batched_ccc_plain)]


def fit_swaps():
    """The plain versions that the fit-level comparison swaps in."""
    return (orient_refine_swaps() + match_swaps() + describe_swaps()
            + post_ccc_swaps())


# the plain version of each entry of K1's and K9's modules, which hold
# several (the blur's epilogues and K9's closing pass are part of the
# simulation body)
SPLIT_PLAIN = {"conv1d": "conv1d_along_plain", "log_gauss": "log_gauss_plain",
               "blur_divide": "simulate_batch_plain",
               "blur_max": "simulate_batch_plain",
               "scatter_atoms": "simulate_batch_plain",
               "simulate_scale": "simulate_batch_plain"}


@contextlib.contextmanager
def cuda_pads():
    """The shapes of the CUDA tensors given to F.pad inside the block (the
    port pads on the card with K23)."""
    import torch.nn.functional as F
    seen, real = [], F.pad

    def spy(x, *args, **kw):
        if x.is_cuda:
            seen.append(tuple(x.shape))
        return real(x, *args, **kw)

    F.pad = spy
    try:
        yield seen
    finally:
        F.pad = real


def swapped_kernels(swaps):
    """The KERNELS names whose wrapper module holds a swapped-in plain
    version (in K1's module, the entry whose own plain version it is)."""
    from mad_tpu_torch.kernels import KERNELS
    mods = {fn.__module__ for _mod, _name, fn in swaps}
    names = {fn.__name__ for _mod, _name, fn in swaps}
    return [name for name, (mod, _s, _r) in KERNELS.items()
            if mod.__name__ in mods
            and (name not in SPLIT_PLAIN or SPLIT_PLAIN[name] in names)]


@contextlib.contextmanager
def plain_versions(swaps):
    """Swap the given plain versions in for their kernels, on whatever
    device."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _f in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def compare_assemblies(a, b, tol, what):
    """Same tuples and model components, CCCs within CCC_TOL, overlap
    within the (n, n) tolerance ``tol``."""
    err = np.abs(a["overlap"] - b["overlap"])
    check(np.all(err <= tol), f"{what}: overlap differs by {err.max()} "
          f"(bound {tol[np.unravel_index(err.argmax(), err.shape)]})")
    check(np.array_equal(a["tuples"], b["tuples"]),
          f"{what}: the ranked tuples differ")
    check([m.components for m in a["models"]]
          == [m.components for m in b["models"]],
          f"{what}: the model components differ")
    dccc = max((abs(x.ccc - y.ccc) for x, y in zip(a["models"],
                                                    b["models"])),
               default=0.0)
    check(dccc <= CCC_TOL, f"{what}: model CCCs differ by {dccc}")
    return float(err.max()), dccc


def best_rmsds(structs, copies):
    """Per copy, the best CA-RMSD of any of the structures to it."""
    return [min((s.rmsd_ca_with(c) for s in structs), default=np.inf)
            for c in copies]


# -- phase 4: kernels against their plain versions -------------------------

def same_bits(a, b):
    """Equal bit for bit (a float's sign of zero included)."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints), b.contiguous().view(ints))


def cuda_ms(fn, reps=3):
    """Mean milliseconds of fn() on the card (one warm call first)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(launch, reps=20):
    """Mean milliseconds of the device work of launch() alone (a wrapper's
    bare kernel launch, on preallocated buffers): one warm call, then the
    stream held back by a spin kernel (torch.cuda._sleep) while the host
    enqueues the launches, so that the events around them time the card's
    work and none of the host's."""
    import torch
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bare(fn):
    """The one kernel launch that fn() makes, to be repeated alone: fn()
    runs once with kernels/build.launch recorded and every tensor it makes
    kept alive (a TorchDispatchMode), and the function returned calls the
    launcher again with the same arguments on the same buffers, without
    the wrapper's checks, allocations, conversions and launch count (the
    launcher's arguments are its ``call``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from mad_tpu_torch.kernels import build
    calls, kept = [], []

    class Keep(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            kept.append(out)
            return out

    real = build.launch
    build.launch = lambda *args: (calls.append(args), real(*args))[1]
    try:
        with Keep():
            fn()
    finally:
        build.launch = real
    check(len(calls) == 1, f"bare: {len(calls)} launches, not one")

    def launch():
        real(*calls[0])

    launch.kept, launch.call = kept, calls[0]
    return launch


def alone_ms(fn):
    """kernel_ms of fn()'s one launch (bare)."""
    return kernel_ms(bare(fn))


def bound(nbytes, ops, peak_ops=PEAK_F32_S):
    """The least time the card could take: the larger of the bytes the
    work must move over PEAK_BYTES_S and its operations over peak_ops
    (float32 by default), in ms, with which of the two it is."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes=float(nbytes), ops=float(ops))


def measure(err, kernel, plain, nbytes, ops, library=None,
            peak_ops=PEAK_F32_S):
    """One kernel's report entry: its error against the plain version, the
    times of the kernel, the plain version and the one PyTorch call that
    computes the same function (None where there is none), and its
    bound."""
    return dict(max_abs_err=float(err), ms=cuda_ms(kernel),
                plain_ms=cuda_ms(plain),
                library_ms=None if library is None else cuda_ms(library),
                **bound(nbytes, ops, peak_ops))


def say_measure(name, r):
    lib = r["library_ms"]
    say(f"  {name}: max abs err {r['max_abs_err']:g}, kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
        + ("none" if lib is None else f"{lib:.4f} ms")
        + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
        f"{r['bytes']:.4g} B, {r['ops']:.4g} ops; "
        f"{r['bound_ms'] / r['ms']:.1%} of the kernel's time)"
        + (f"; alone {r['kernel_ms']:.4f} ms" if r.get("kernel_ms")
           else ""))


def kernel_checks(fit, cfg, device):
    """Each kernel vs its plain version at main-path shapes; returns
    {name: measure(...)}."""
    import torch
    import torch.nn.functional as F
    from mad_tpu_torch.engine.match import match_descriptors
    from mad_tpu_torch.kernels import conv1d, repeat
    from mad_tpu_torch.ops.convolve import gaussian_kernel1d
    from mad_tpu_torch.ops.scalespace import iter_octaves
    from mad_tpu_torch.ops.simulate import _blur_taps

    out = {}
    ss = cfg.scalespace
    up_octave = next(o for _org, o in iter_octaves(fit["dmap"], ss)
                     if o.upsampled)
    vol = up_octave.volume()
    V = vol.numel()
    say(f"kernels at the upsampled octave {tuple(vol.shape)}")

    # K1's single-axis entry: the LoG's second-derivative taps along each
    # axis, bit for bit (the kernel rounds as the shift-add does); then a
    # batch of three volumes' 'full' blur, each axis one launch, bit for
    # bit with the plain version. Work: per axis a read and a write of the
    # volume, 2 * taps flops a voxel; the library call is F.conv3d with the
    # taps along the axis.
    g0 = gaussian_kernel1d(ss.detect_sigma, 0, ss.truncate)
    g2 = gaussian_kernel1d(ss.detect_sigma, 2, ss.truncate)
    for axis in range(3):
        a = conv1d.conv1d_along(vol, g2, axis)
        b = conv1d.conv1d_along_plain(vol, g2, axis)
        check(same_bits(a, b), f"K1 differs from the plain version along "
              f"axis {axis}")
        del a, b
    batch = torch.stack([vol[:96, :80, :72], vol[96:192, :80, :72],
                         vol[-96:, -80:, -72:]])
    sigma = RES / (math.pi * math.sqrt(2.0)) / VOXSP        # the bench blur
    blur = _blur_taps(sigma, int(math.ceil(3.0 * sigma)))
    for axis in range(3):
        check(same_bits(conv1d.conv1d_along(batch, blur, axis, "full"),
                        conv1d.conv1d_along_plain(batch, blur, axis,
                                                  "full")),
              f"K1's batched 'full' blur differs along axis {axis}")
    del batch
    three = lambda f: [f(vol, g2, axis) for axis in range(3)]
    taps = torch.as_tensor(g2, device=device)
    k = len(g2)

    def conv3d():
        x = vol[None, None]
        for axis in range(3):
            shape, pad = [1, 1, 1, 1, 1], [0, 0, 0]
            shape[2 + axis], pad[axis] = k, k // 2
            F.conv3d(x, taps.view(shape), padding=tuple(pad))
    out["conv1d"] = measure(0.0, lambda: three(conv1d.conv1d_along),
                            lambda: three(conv1d.conv1d_along_plain),
                            3 * 2 * 4 * V, 3 * 2 * k * V, conv3d)
    del taps

    # K1's fused LoG of the octave: the three passes against the nine
    # shift-adds and the epilogue's five ops, bit for bit (signed zeros
    # included). Work: the volume read once, the LoG and the Gaussian
    # written once; 2 flops a nonzero tap of each of the six g0 and three
    # g2 convolutions a voxel. No single PyTorch call computes the pair.
    log_args = (vol, g0, g2, ss.detect_sigma)
    got = conv1d.log_gauss(*log_args)
    ref = conv1d.log_gauss_plain(*log_args)
    check(all(same_bits(x, y) for x, y in zip(got, ref)),
          "K1's fused LoG differs from the plain version")
    del got, ref
    taps = 6 * int(np.count_nonzero(g0)) + 3 * int(np.count_nonzero(g2))
    out["log_gauss"] = measure(0.0, lambda: conv1d.log_gauss(*log_args),
                               lambda: conv1d.log_gauss_plain(*log_args),
                               3 * 4 * V, 2 * taps * V)
    say(f"  K1 LoG: {tuple(vol.shape)}, three launches, equal to the "
        f"plain version bit for bit; kernel {out['log_gauss']['ms']:.3f} "
        f"ms, plain {out['log_gauss']['plain_ms']:.3f} ms")

    del vol

    # K13: the head pairs that the match stage scores exactly. Equal except
    # pairs with an anchor within 1e-4 A of the 4 A radius. Work per pair:
    # each subunit anchor moved (15 flops) and its distance to every map
    # anchor (9 flops).
    m, s, dmap = fit["map_set"], fit["sub_set"], fit["dmap"]
    table = match_descriptors(m, s, dmap.shape, dmap.origin, dmap.voxsp,
                              cfg.match, min_exact=0, device=device)
    n_head = min(1024, table.n)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    args = (f32(table.hi_cloud), f32(table.lo_cloud),
            f32(table.rot[:n_head]), f32(table.hi_coord[:n_head]),
            f32(table.lo_coord[:n_head]), float(cfg.match.anchor_dist))
    r1 = repeat.exact_repeat(*args)
    r2 = repeat.exact_repeat_plain(*args)
    edge = _near_radius(*args)
    bad = (r1 != r2) & ~edge
    check(not bool(bad.any()), f"K13 differs on {int(bad.sum())} pairs")
    a_hi, a_lo = table.hi_cloud.shape[0], table.lo_cloud.shape[0]
    out["exact_repeat"] = measure(
        float((r1 - r2).abs().max()), lambda: repeat.exact_repeat(*args),
        lambda: repeat.exact_repeat_plain(*args),
        (a_hi + a_lo) * 12 + n_head * (36 + 24 + 4),
        n_head * a_hi * (15 + 9 * a_lo))
    out["exact_repeat"]["kernel_ms"] = alone_ms(
        lambda: repeat.exact_repeat(*args))
    say(f"  K13: {n_head} pairs x {a_hi} x {a_lo} anchors, "
        f"{int(edge.sum())} on the edge")
    args = k13_stress_args(device)
    r1, r2 = repeat.exact_repeat(*args), repeat.exact_repeat_plain(*args)
    edge = _near_radius(*args)
    bad = (r1 != r2) & ~edge
    check(not bool(bad.any()), f"K13 at the stress shape differs on "
          f"{int(bad.sum())} pairs")
    say(f"  K13 stress: {args[2].shape[0]} pairs x {args[0].shape[0]} x "
        f"{args[1].shape[0]} anchors, {int(edge.sum())} on the edge, equal "
        f"off it; kernel alone "
        f"{alone_ms(lambda: repeat.exact_repeat(*args)):.4f} ms, wrapper "
        f"{cuda_ms(lambda: repeat.exact_repeat(*args)):.4f} ms")
    out.update(match_kernel_checks(fit, cfg, device))
    out.update(assembly_kernel_checks(fit, cfg, device))
    out["orient"] = orient_check(fit, cfg, device)
    out["refine"] = refine_check(fit, cfg, device)
    out.update(describe_checks(fit, cfg, device))
    out.update(post_ccc_checks(fit, cfg, device))
    out.update(select_pad_checks(fit, cfg, device))
    return out


def unreduced_map(device):
    """The bench map as run_fit simulates it, before reduce_void."""
    from mad_tpu_torch.ops.simulate import simulate_density
    from mad_tpu_torch.testing import make_assembly
    _sub, copies = make_assembly(n_copies=N_COPIES, n_res=N_RES, seed=SEED,
                                 spread=SPREAD, shell=True)
    return simulate_density(
        np.concatenate([c.coords for c in copies]), RES, VOXSP, device=device,
        masses=np.concatenate([c.masses for c in copies]))


def edge_volume(device):
    """A sparse volume with a NaN voxel (occupied) and -0.0 voxels (not)."""
    import torch
    rng = np.random.default_rng(23)
    v = np.zeros((61, 47, 53), np.float32)
    v[7:50, 5:40, 9:44] = rng.random((43, 35, 35)) * (
        rng.random((43, 35, 35)) < 0.2)
    v[1, 2, 3] = np.nan
    v[60, 46, 52] = -0.0
    v[30, 0, 20] = -0.0
    return torch.as_tensor(v, device=device)


def k21_edge_args(device):
    """K21's inputs on the K21_EDGE table."""
    import torch
    e = K21_EDGE
    rng = np.random.default_rng(e["seed"])
    rep = (rng.normal(size=e["P"]) * 30).astype(np.float32)
    at = 0
    for value, n in e["values"].items():
        rep[at:at + n] = value
        at += n
    rep = rep[rng.permutation(e["P"])]
    return [torch.as_tensor(a, device=device) for a in (
        rep, rng.normal(size=(e["P"], 3, 3)).astype(np.float32),
        rng.normal(size=(e["P"], 3)).astype(np.float32),
        rng.normal(size=(e["P"], 3)).astype(np.float32))]


@contextlib.contextmanager
def k21_paths(one):
    """K21's wrapper with its path forced: the one launch (one True, which
    the wrapper takes by itself where the sizes allow) or the three
    launches (False); yields the wrapper."""
    from mad_tpu_torch.kernels import select_exact as k21
    real = k21.one_launch
    if not one:
        k21.one_launch = lambda P, n_use: False
    try:
        yield k21.select_exact
    finally:
        k21.one_launch = real


def select_pad_checks(fit, cfg, device):
    """K21, K22 and K23 against their plain versions, bit for bit: K21 at
    the inputs the match stage gives it (recorded during a
    match_descriptors of the fit's sets at the fit's min_exact), also at
    n_use = P, and on K21_EDGE; K22 and K23 on the unreduced bench map,
    the map's and the subunit's prepare (recorded) and edge_volume."""
    import torch
    import torch.nn.functional as F
    from mad_tpu_torch.engine import match as em
    from mad_tpu_torch.engine.pipeline import describe_structure
    from mad_tpu_torch.kernels import crop_pad as k23
    from mad_tpu_torch.kernels import select_exact as k21
    from mad_tpu_torch.ops import scalespace
    from mad_tpu_torch.testing import recording
    out = {}
    m, s, dmap = fit["map_set"], fit["sub_set"], fit["dmap"]

    # K21. Work: rep read once, the n_use rows' rotations and coordinates
    # read and written, top written; a key a row. Library: torch.topk of
    # the keys with the three gathers (printed beside torch.sort of the
    # keys, stable, descending, then the first n_use); the keys made
    # outside both. The one launch (the bench, K21_EDGE) and the three
    # launches (the bench's shapes forced, n_use = P, K21_EDGE at n_use =
    # P), each held against the plain version.
    with recording(em, "select_exact") as calls:
        em.match_descriptors(m, s, dmap.shape, dmap.origin, dmap.voxsp,
                             cfg.match, min_exact=cfg.filter.n_samples
                             * N_COPIES, device=device)
    check(len(calls) == 1, f"K21: {len(calls)} calls in the match stage")
    args = calls[0]
    rep, n_use = args[0], args[4]
    P = rep.shape[0]
    full = args[:4] + (P,)
    check(k21.one_launch(P, n_use) and not k21.one_launch(P, P),
          f"K21: the bench's {n_use} of {P} rows not in one launch")
    edge = k21_edge_args(device)
    for what, a, one in (
            ("the bench", args, True), ("the bench, three launches", args,
                                        False),
            ("n_use = P", full, False),
            ("K21_EDGE", edge + [K21_EDGE["n_use"]], True),
            ("K21_EDGE, n_use = P", edge + [K21_EDGE["P"]], False)):
        with k21_paths(one) as kernel:
            got, want = kernel(*a), k21.select_exact_plain(*a)
        check(all(same_bits(x, y) for x, y in zip(got, want)),
              f"K21 differs from the plain version on {what}")
        check(np.array_equal(got[0].cpu().numpy(), np.argsort(
            -a[0].cpu().numpy(), kind="stable")[:a[4]]),
            f"K21's order is not numpy's stable argsort on {what}")
    keys = k21.order_keys(rep)
    rot, hi, lo = args[1:4]

    def topk():
        top = torch.topk(keys, n_use).indices
        return top, rot[top], hi[top], lo[top]

    out["select_exact"] = measure(
        0.0, lambda: k21.select_exact(*args),
        lambda: k21.select_exact_plain(*args),
        P * 4 + n_use * (36 + 12 + 12) * 2 + n_use * 8, P, topk)
    out["select_exact"]["kernel_ms"] = alone_ms(
        lambda: k21.select_exact(*args))
    sort_ms = cuda_ms(lambda: torch.sort(keys, descending=True, stable=True
                                         ).indices[:n_use])
    with k21_paths(False) as three:
        three_alone = alone_ms(lambda: three(*args))
        three_ms = cuda_ms(lambda: three(*args))
    say(f"  K21: {P} repeatabilities, n_use {n_use}, bit for bit (also "
        f"three launches, at n_use = P and on K21_EDGE); one launch alone "
        f"{out['select_exact']['kernel_ms']:.4f} ms, wrapper "
        f"{out['select_exact']['ms']:.4f} ms; three launches alone "
        f"{three_alone:.4f} ms, wrapper {three_ms:.4f} ms; torch.topk with "
        f"its gathers {out['select_exact']['library_ms']:.4f} ms, "
        f"torch.sort and a slice {sort_ms:.4f} ms; at n_use = P alone "
        f"{alone_ms(lambda: k21.select_exact(*full)):.4f} ms, wrapper "
        f"{cuda_ms(lambda: k21.select_exact(*full)):.4f} ms")
    del keys, calls, edge

    # K22 on the unreduced bench map. Work: the volume read once, the
    # flags written; a compare a voxel. Library: three torch.any.
    # Also the map less its first voxel as an (X - 1, Y, Z) view: its data
    # 4 bytes past a 16-byte boundary, so a scalar head and tail.
    raw = unreduced_map(device).data
    edge = edge_volume(device)
    X, Y, Z = raw.shape
    shifted = raw.reshape(-1)[1:1 + (X - 1) * Y * Z].view(X - 1, Y, Z)
    for what, v in (("the unreduced bench map", raw), ("edge_volume", edge),
                    ("the map's view off 16-byte alignment", shifted)):
        check(same_bits(k23.axis_flags(v), k23.axis_flags_plain(v)),
              f"K22 differs from the plain version on {what}")
    flags = k23.axis_flags(edge).cpu().numpy()
    check(flags[1] and not flags[60] and flags[61 + 2] and flags[108 + 3]
          and not flags[108 + 52], "K22: NaN or -0.0 counted wrongly")
    V, X, Y, Z = raw.numel(), *raw.shape

    def any3():
        occ = raw != 0
        return (occ.any(dim=(1, 2)), occ.any(dim=(0, 2)),
                occ.any(dim=(0, 1)))

    out["axis_flags"] = measure(
        0.0, lambda: k23.axis_flags(raw), lambda: k23.axis_flags_plain(raw),
        V * 4 + X + Y + Z, V, any3)
    out["axis_flags"]["kernel_ms"] = alone_ms(lambda: k23.axis_flags(raw))
    say(f"  K22: the unreduced map {tuple(raw.shape)}, bit for bit (also "
        f"edge_volume and the view off alignment); alone "
        f"{out['axis_flags']['kernel_ms']:.4f} ms, wrapper "
        f"{out['axis_flags']['ms']:.4f} ms, bound "
        f"{out['axis_flags']['bound_ms']:.5f} ms; the view alone "
        f"{alone_ms(lambda: k23.axis_flags(shifted)):.4f} ms")
    del shifted

    # K23: reduce_void's crop of the unreduced map, the map's and the
    # subunit's prepare, edge_volume. Work: the box read once, the output
    # written once. Library: F.pad of the cropped view.
    fl = k23.axis_flags(raw).cpu().numpy()
    axes = [fl[:X], fl[X:X + Y], fl[X + Y:]]
    lo = [int(np.argmax(a)) for a in axes]
    box = [len(a) - int(np.argmax(a[::-1])) - l for a, l in zip(axes, lo)]
    with recording(scalespace, "crop_pad") as sub_pads:
        describe_structure(fit["moved"], RES, dmap.voxsp, cfg,
                           name="bench_sub", device=device)
    with recording(scalespace, "crop_pad") as map_pads:
        scalespace.prepare(dmap, cfg.scalespace)
    check(len(sub_pads) == len(map_pads) == 1,
          f"K23: {len(map_pads)} and {len(sub_pads)} prepare calls")
    cases = {"map prepare": map_pads[0], "subunit prepare": sub_pads[0],
             "reduce_void": (raw, lo, box, REDUCE_PAD),
             "edge_volume": (edge, (1, 2, 3), (59, 44, 50), 9)}
    for what, a in cases.items():
        got = k23.crop_pad(*a)
        check(same_bits(got, k23.crop_pad_plain(*a)),
              f"K23 differs from the plain version on {what}")
        vol, lo_, box_, pad = a
        nbytes = 4 * (int(np.prod(box_)) + got.numel())
        r = measure(0.0, lambda: k23.crop_pad(*a),
                    lambda: k23.crop_pad_plain(*a), nbytes, 0,
                    lambda: F.pad(vol[lo_[0]:lo_[0] + box_[0],
                                      lo_[1]:lo_[1] + box_[1],
                                      lo_[2]:lo_[2] + box_[2]],
                                  (pad,) * 6))
        r["kernel_ms"] = alone_ms(lambda: k23.crop_pad(*a))
        say_measure(f"K23 {what} ({tuple(vol.shape)} -> "
                    f"{tuple(got.shape)})", r)
        if what == "map prepare":
            out["crop_pad"] = r
        del got
    del raw, edge
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def wide_offsets(kernel):
    """Calls of K2 or K3 (``kernel``, its module) take the 64-bit offset
    path, which the bench map's volumes, below 2^32 elements, never do."""
    wide_from, kernel.WIDE_FROM = kernel.WIDE_FROM, 0
    try:
        yield
    finally:
        kernel.WIDE_FROM = wide_from


def describe_checks(fit, cfg, device):
    """K2, K3, K5 and K8 against their plain versions, bit for bit, at the
    inputs that a describe_grid of the bench map gives them; then that
    describe_grid with the kernels and with describe_swaps() must give the
    same DescriptorSet."""
    import torch
    import torch.nn.functional as F
    from mad_tpu_torch import convert
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.kernels import (gather_norm as k8, gradient as k3,
                                       localize as k5, upsample as k2)
    from mad_tpu_torch.ops import describe, detect, scalespace
    from mad_tpu_torch.testing import recording
    out = {}
    dmap = fit["dmap"]
    t0 = time.perf_counter()
    with recording(pipeline, "gradient") as grads, \
            recording(detect, "localize_peaks") as newton, \
            recording(pipeline, "gather_norm") as gathers, \
            recording(scalespace, "upsample2") as ups, \
            recording(detect, "peak_topk") as k4_calls, \
            recording(describe, "descriptor_hist") as k7_calls:
        a = pipeline.describe_grid(dmap, cfg, name="bench_map",
                                   device=device)
        torch.cuda.synchronize()
    t_kernels = time.perf_counter() - t0
    with recording(scalespace, "upsample2") as sub_ups, \
            recording(pipeline, "gather_norm") as sub_gathers, \
            recording(detect, "localize_peaks") as sub_newton, \
            recording(detect, "peak_topk") as sub_k4_calls, \
            recording(describe, "descriptor_hist") as sub_k7_calls:
        pipeline.describe_structure(fit["moved"], RES, dmap.voxsp, cfg,
                                    device=device)
    with recording(pipeline, "detect_anchors") as detects:
        pipeline.describe_grid(dmap, cfg, name="bench_map", device=device)
    out.update(k4_checks(k4_calls + sub_k4_calls))
    out.update(k7_checks(k7_calls + sub_k7_calls))
    del k4_calls, sub_k4_calls, k7_calls, sub_k7_calls

    # K2: the upsampled octave's base, all three axes in one launch, bit
    # for bit with the three per-axis passes; also the subunit's base and
    # ragged shapes cut from the map's. Work: the function's own, the base
    # read once and the octave written once, 7 flops a half sample of each
    # axis (the per-axis passes' own traffic printed beside).
    check(len(ups) == len(sub_ups) == 1, "K2 runs once a describe_grid")
    base, sub_base = ups[0][0], sub_ups[0][0]
    for v in [base, sub_base] + [base[:x, :y, :z] for x, y, z in K2_SHAPES]:
        got = k2.upsample2(v)
        check(same_bits(got, k2.upsample2_plain(v)),
              f"K2 differs from the plain version on {tuple(v.shape)}")
        check(tuple(got.shape) == tuple(2 * n - 1 for n in v.shape),
              f"K2's output shape {tuple(got.shape)}")
    with wide_offsets(k2):
        for x, y, z in K2_SHAPES:
            v = base[:x, :y, :z]
            check(same_bits(k2.upsample2(v), k2.upsample2_plain(v)),
                  f"K2's 64-bit offset path differs from the plain version "
                  f"on {tuple(v.shape)}")
    del got
    X, Y, Z = base.shape
    sizes = upsample_sizes(base.shape)
    nbytes = 4 * (sizes[0] + sizes[3])
    axes = 4 * sum(sizes[i] + sizes[i + 1] for i in range(3))
    out["upsample2"] = measure(
        0.0, lambda: k2.upsample2(base), lambda: k2.upsample2_plain(base),
        nbytes, upsample_ops(base.shape))
    say(f"  K2: {tuple(base.shape)} -> {(2 * X - 1, 2 * Y - 1, 2 * Z - 1)}, "
        f"the subunit's {tuple(sub_base.shape)} and {len(K2_SHAPES)} ragged "
        f"shapes, equal; one launch {out['upsample2']['ms']:.4f} ms, bound "
        f"{nbytes:.4g} B (the per-axis passes' {axes:.4g} B, "
        f"{axes / PEAK_BYTES_S * 1e3:.4f} ms)")
    del ups, sub_ups, base, sub_base

    # K3: the upsampled octave's Gaussian volume (the path's first call),
    # float32 as on the bench path and bfloat16 as above the 250 M voxel
    # gate, bit for bit, also on ragged shapes cut from it. Work: the
    # volume read once, the field written, 2 flops a component; library:
    # torch.gradient, stacked (and cast).
    gauss = grads[0][0]
    V = gauss.numel()
    for dtype in (torch.float32, torch.bfloat16):
        for v in [gauss] + [gauss[:x, :y, :z] for x, y, z in K3_SHAPES]:
            check(same_bits(k3.gradient(v, dtype),
                            k3.gradient_plain(v, dtype)),
                  f"K3 {dtype} differs from the plain version on "
                  f"{tuple(v.shape)}")
        with wide_offsets(k3):
            for x, y, z in K3_SHAPES:
                v = gauss[:x, :y, :z]
                check(same_bits(k3.gradient(v, dtype),
                                k3.gradient_plain(v, dtype)),
                      f"K3 {dtype}'s 64-bit offset path differs from the "
                      f"plain version on {tuple(v.shape)}")
        r = measure(0.0, lambda: k3.gradient(gauss, dtype),
                    lambda: k3.gradient_plain(gauss, dtype),
                    4 * V + 3 * V * (4 if dtype == torch.float32 else 2),
                    6 * V, lambda: torch.stack(torch.gradient(gauss),
                                               -1).to(dtype))
        say(f"  K3 {dtype}: {tuple(gauss.shape)}, equal; kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, torch.gradient "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms")
        if dtype == torch.float32:
            out["gradient"] = r
    del grads, gauss

    # K5: the fit's four LoG volumes (the map's and the subunit's
    # upsampled and base octaves) with K4's peaks, in the flat form as
    # detect_anchors calls it and in the offset form on the same seeds, bit
    # for bit; each launch alone and wrapped, with its bound; the row sums
    # the four. Work: the active Newton steps of this run's peaks and the
    # distinct voxels their patches read (newton_work), the peaks read and
    # the anchors written. Then detect_anchors (K4, K5 and the host work
    # between) at each map octave.
    check(len(newton) == 2 and len(sub_newton) == 2,
          f"K5 ran {len(newton)} and {len(sub_newton)} times a describe")
    total = dict(ms=0.0, plain_ms=0.0, kernel_ms=0.0)
    nbytes = ops = 0
    for label, args in zip(K4_SHAPES, newton + sub_newton):
        vol, flat, vals, real, thr, eb, mo, n_iter = args
        got = k5.localize_peaks(*args)
        check(all(same_bits(x, y) for x, y in
                  zip(got, k5.localize_peaks_plain(*args))),
              f"K5 differs from the plain version on the {label} octave")
        seeds = k5.flat_seeds(flat, vol.shape, real, eb)
        walk = (vol, seeds, real, mo, n_iter)
        got2 = k5.localize(*walk)
        check(all(same_bits(x, y) for x, y in
                  zip(got2, k5.localize_plain(*walk)))
              and same_bits(got2[0], got[0]) and same_bits(got2[1], got[1])
              and torch.equal(got2[2] & (vals > thr), got[2]),
              f"K5's offset form differs on the {label} octave")
        K = flat.shape[0]
        steps, voxels, most = newton_work(*walk)
        moved = int(((got[0] - seeds).abs().amax(dim=1) >= 2).sum())
        b = bound(4 * voxels + K * (8 + 4 + 24 + 12 + 1),
                  steps * NEWTON_FLOPS + K * SADDLE_FLOPS)
        r = dict(ms=cuda_ms(lambda: k5.localize_peaks(*args)),
                 plain_ms=cuda_ms(lambda: k5.localize_peaks_plain(*args)),
                 kernel_ms=alone_ms(lambda: k5.localize_peaks(*args)))
        for key in total:
            total[key] += r[key]
        nbytes += b["bytes"]
        ops += b["ops"]
        say(f"  K5 {label}: {K} peaks on {tuple(vol.shape)}, {steps} Newton "
            f"steps (at most {most} a peak), {moved} walked 2+ voxels, "
            f"{int(got[2].sum())} valid, bit for bit in both forms; alone "
            f"{r['kernel_ms']:.4f} ms, wrapper {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {b['bound_ms']:.3g} ms "
            f"({b['bound_by']}, {b['bound_ms'] / r['kernel_ms']:.2%} of "
            f"alone)")
    out["localize"] = dict(max_abs_err=0.0, library_ms=None,
                           **total, **bound(nbytes, ops))
    check(len(detects) == 2, f"{len(detects)} detect_anchors calls")
    for label, args in zip(K4_SHAPES, detects):
        say(f"  detect_anchors {label}: "
            f"{cuda_ms(lambda: detect.detect_anchors(*args)):.4f} ms")
    del newton, sub_newton, detects, args, vol, flat, vals, got, got2

    # K8: the map's two octave tables and keep indices. Work: the kept rows
    # read, the int16 and float32 rows written, the indices read, 3 flops a
    # bin; library: F.normalize of the gathered rows. The kernel alone at
    # the map's and at the subunit's call (describe_structure's), both on
    # the 16-byte path, and on the scalar path at the map's call (its
    # tables copied 2 bytes off 16-byte alignment); the cache loader's
    # call (convert.descriptor_set_from_numpy, every row of the map's
    # table), each bit for bit with the plain version.
    (tables, keeps), = gathers
    (sub_tables, sub_keeps), = sub_gathers
    odd = [torch.zeros(t.numel() + 1, dtype=t.dtype, device=device)
           for t in tables]
    for o, t in zip(odd, tables):
        o[1:] = t.reshape(-1)
    odd = [o[1:].view(t.shape) for o, t in zip(odd, tables)]
    check(k8.vector_path(tables) and k8.vector_path(sub_tables)
          and not k8.vector_path(odd),
          "K8: the describe path's tables not on the 16-byte path")
    for what, (t, k) in (("the map", (tables, keeps)),
                         ("the subunit", (sub_tables, sub_keeps)),
                         ("the map, scalar path", (odd, keeps))):
        got, ref = k8.gather_norm(t, k), k8.gather_norm_plain(t, k)
        check(same_bits(got[0], ref[0]) and same_bits(got[1], ref[1]),
              f"K8 rows differ from the plain version on {what}")
    n = got[0].shape[0]
    z3, z = np.zeros((n, 3)), np.zeros(n, np.int32)
    loaded = convert.descriptor_set_from_numpy(
        got[0].cpu().numpy(), z3, z3, z3, np.zeros((n, 3, 3)), z, z, z, z,
        device=device)
    check(same_bits(loaded.desc, ref[0]) and same_bits(
        loaded.desc_norm, k8.gather_norm_plain(
            [ref[0]], [torch.arange(n, device=device)])[1]),
        "K8 rows differ from the plain version in the cache loader")
    N, D = got[0].shape
    out["gather_norm"] = measure(
        0.0, lambda: k8.gather_norm(tables, keeps),
        lambda: k8.gather_norm_plain(tables, keeps),
        N * D * (2 + 2 + 4) + N * 8, 3 * N * D,
        lambda: F.normalize(torch.cat([t[k] for t, k in zip(tables, keeps)])
                            .float(), dim=1))
    out["gather_norm"]["kernel_ms"] = alone_ms(
        lambda: k8.gather_norm(tables, keeps))
    sub_ms = alone_ms(lambda: k8.gather_norm(sub_tables, sub_keeps))
    sub_n = sum(k.shape[0] for k in sub_keeps)
    out["gather_norm"]["sub_kernel_ms"] = sub_ms
    scalar_ms = alone_ms(lambda: k8.gather_norm(odd, keeps))
    say(f"  K8: {N} rows of {D} from {[t.shape[0] for t in tables]} lanes, "
        f"equal (also the subunit's, the scalar path's and the cache "
        f"loader's); kernel alone {out['gather_norm']['kernel_ms']:.4f} ms "
        f"(bound {bound(N * D * 8 + N * 8, 0)['bound_ms']:.5f}), at the "
        f"subunit's call ({sub_n} rows) {sub_ms:.4f} ms (bound "
        f"{bound(sub_n * D * 8 + sub_n * 8, 0)['bound_ms']:.5f}), the "
        f"scalar path at the map's {scalar_ms:.4f} ms; wrapper "
        f"{out['gather_norm']['ms']:.4f} ms")
    del odd, loaded
    del gathers, tables, keeps, got, ref, sub_gathers, sub_tables, sub_keeps

    t0 = time.perf_counter()
    with plain_versions(describe_swaps()):
        b = pipeline.describe_grid(dmap, cfg, name="bench_map",
                                   device=device)
        torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    check(a.n == b.n and torch.equal(a.desc, b.desc)
          and torch.equal(a.desc_norm, b.desc_norm)
          and all(np.array_equal(getattr(a, k), getattr(b, k))
                  for k in ("coords", "subv_coords", "rfinal")),
          "describe_grid differs with the plain versions of K1's LoG, K2, "
          "K3, K5, K8")
    say(f"  describe_grid of the bench map: {a.n} rows, the same with the "
        f"kernels ({t_kernels:.4f} s) and with the plain versions of K1's "
        f"LoG, K2, K3, K5, K8 ({t_plain:.4f} s)")
    return out


def k4_checks(calls):
    """K4 at the fit's four LoG volumes (``calls``: the recorded arguments
    of detect.peak_topk in one describe_grid of the bench map and one
    describe_structure of the subunit, in K4_SHAPES' order) and at
    K4_CUTS of the map's upsampled one, bit for bit with the plain
    version; at the four, the voxels above threshold, the kernel alone
    (kernel_ms) beside the wrapper's time. Work: the own rows read once,
    the top-k's values and indices written; a compare a voxel, and 27 for
    each voxel above threshold (this run's data)."""
    import torch
    from mad_tpu_torch.kernels import peaks
    check(len(calls) == len(K4_SHAPES),
          f"K4 ran {len(calls)} times in the describe calls, not "
          f"{len(K4_SHAPES)}")
    out = {}
    for label, args in zip(K4_SHAPES, calls):
        vol, real, thr = args[:3]
        v1, i1 = peaks.peak_topk(*args)
        v2, i2 = peaks.peak_topk_plain(*args)
        check(same_bits(v1, v2) and torch.equal(i1, i2),
              f"K4 {label}: peaks differ ({len(i1)} vs {len(i2)})")
        V = vol.numel()
        above = int((vol > thr).sum())
        keys = torch.empty(peaks._FIRST_CAPACITY, dtype=torch.int64,
                           device=vol.device)
        cand = torch.empty(peaks._FIRST_CANDIDATES, dtype=torch.int32,
                           device=vol.device)
        counter = torch.empty(3, dtype=torch.int32, device=vol.device)
        top = (torch.empty(args[4], device=vol.device),
               torch.empty(args[4], dtype=torch.int64, device=vol.device))
        r = measure(0.0, lambda: peaks.peak_topk(*args),
                    lambda: peaks.peak_topk_plain(*args),
                    4 * V + 12 * len(v1), V + 27 * above)
        r["kernel_ms"] = kernel_ms(lambda: peaks.compact(
            vol, real, thr, args[3], 0, vol.shape[0], 0, keys, cand,
            counter, *top))
        say(f"  K4 {label}: {tuple(vol.shape)}, {above} of {V} voxels above "
            f"threshold ({above / V:.3%}), {len(v1)} peaks, equal; kernel "
            f"alone {r['kernel_ms']:.4f} ms, wrapper {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bound_ms'] / r['kernel_ms']:.1%} of the "
            "kernel alone)")
        out["peak_mask_compact" if label == "map upsampled"
            else "peak_mask_compact_" + label.replace(" ", "_")] = r
    log, _real, thr, border, cap = calls[0][:5]
    for (x, y, z), row0, rows, x0 in K4_CUTS:
        cut = log[:x, :y, :z].contiguous()
        for t in (thr, K4_RAGGED_THRESHOLD):
            args = (cut, (x0 + x, y, z), t, border if t == thr else 1, cap,
                    row0, rows, x0)
            v1, i1 = peaks.peak_topk(*args)
            v2, i2 = peaks.peak_topk_plain(*args)
            check(same_bits(v1, v2) and torch.equal(i1, i2),
                  f"K4 differs from the plain version on {(x, y, z)}, own "
                  f"rows from {row0}, threshold {t}")
    say(f"  K4 at {len(K4_CUTS)} ragged cuts of the map's upsampled LoG "
        "(own rows off a 16-byte boundary, offset form), thresholds "
        f"{thr} and {K4_RAGGED_THRESHOLD}: equal")
    # NaN next to peaks: reduce_window's and max_pool3d's maximum is NaN
    # there, so those voxels are no peaks
    _v, first = peaks.peak_topk(*calls[0])
    bad = log.clone()
    flat = bad.view(-1)
    for i in first[:K4_NAN_PEAKS].tolist():
        flat[i + 1] = float("nan")
    args = (bad,) + tuple(calls[0][1:])
    v1, i1 = peaks.peak_topk(*args)
    v2, i2 = peaks.peak_topk_plain(*args)
    check(same_bits(v1, v2) and torch.equal(i1, i2)
          and not set(first[:K4_NAN_PEAKS].tolist()) & set(i1.tolist()),
          "K4 differs from the plain version next to NaN voxels")
    say(f"  K4 with NaN beside the map's first {K4_NAN_PEAKS} peaks: equal, "
        f"those peaks dropped ({len(first)} -> {len(i1)} peaks)")
    return out


def k7_checks(calls, tag=""):
    """K7 at a fit's four octaves (``calls``: the recorded arguments of
    ops/describe.descriptor_hist in one describe_grid of the map and one
    describe_structure of the subunit, in K4_SHAPES' order; ``tag``
    prefixes the printed lines) against its plain version: the same
    in-bounds flags, rows equal in >= 99 %, the rest within an L1 of 8
    counts (zone-bound ulps of atan2f / acosf); the lanes its bounds test
    puts out of bounds; the kernel alone (kernel_ms) beside the wrapper's
    time. Work per lattice sample of a valid lane in bounds (this run's
    data: the kernel gathers for no other lane): the field's 3 components
    read, 15 flops to place it, 8 to normalize, 15 to rotate, ~40 for
    atan2 / acos, 6 compares a zone; the frames, coords and flags read,
    the rows and flags written."""
    import torch
    from mad_tpu_torch.kernels import describe
    check(len(calls) == len(K4_SHAPES),
          f"{tag}K7 ran {len(calls)} times in the describe calls, not "
          f"{len(K4_SHAPES)}")
    out = {}
    for label, args in zip(K4_SHAPES, calls):
        d1, ok1 = describe.descriptor_hist(*args)
        d2, ok2 = describe.descriptor_hist_plain(*args)
        diff = (d1.long() - d2.long()).abs()
        row_l1 = diff.sum(dim=1)
        same = float((row_l1 == 0).float().mean())
        check(torch.equal(ok1, ok2),
              f"{tag}K7 {label}: in-bounds flags differ")
        check(same >= 0.99 and int(row_l1.max()) <= 8,
              f"{tag}K7 {label}: rows equal {same:.4f}, max row L1 "
              f"{int(row_l1.max())}")
        grad, valid, lattice, bounds = args[0], args[3], args[5], args[7]
        L, P, nz, n_ok = len(ok1), len(lattice), len(bounds), int(ok1.sum())
        oob = int((valid & ~ok1).sum())
        r = measure(float(diff.max()), lambda: describe.descriptor_hist(*args),
                    lambda: describe.descriptor_hist_plain(*args),
                    n_ok * P * 3 * grad.element_size() + L * (12 + 36 + 1)
                    + d1.numel() * 2 + L,
                    n_ok * P * (15 + 8 + 15 + 40 + 6 * nz))
        r["kernel_ms"] = alone_ms(lambda: describe.descriptor_hist(*args))
        say(f"  {tag}K7 {label}: field {tuple(grad.shape)} {grad.dtype}, "
            f"{L} lanes, {int(valid.sum())} valid, {oob} out of bounds, rows "
            f"equal {same:.5f}; kernel alone {r['kernel_ms']:.4f} ms, "
            f"wrapper {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        out["descriptor_hist" if label == "map upsampled"
            else "descriptor_hist_" + label.replace(" ", "_")] = r
    return out


def upsample_sizes(shape):
    """The volume's voxels before and after each axis of the x2 upsample
    (x, then y, then z)."""
    X, Y, Z = shape
    return [X * Y * Z, (2 * X - 1) * Y * Z, (2 * X - 1) * (2 * Y - 1) * Z,
            (2 * X - 1) * (2 * Y - 1) * (2 * Z - 1)]


def upsample_ops(shape):
    """K2's flops: 7 a half sample (four products, three sums) of each
    axis."""
    sizes = upsample_sizes(shape)
    return sum(7 * (sizes[i + 1] - sizes[i]) for i in range(3))


def newton_work(vol, seeds, real_shape, max_offset, n_iter, goff=0,
                nx=None):
    """The Newton steps that this run's peaks take (a peak stops once it
    is accepted or bad), the distinct voxels their patches read (the work
    of K5's function on these peaks) and the most steps a peak takes.
    Walks as localize_plain."""
    import torch
    from mad_tpu_torch.kernels.localize import (_hessian_grad, _inv3,
                                                patch_index)
    K = seeds.shape[0]
    X, Y, Z = vol.shape
    rs = torch.as_tensor(real_shape, device=vol.device)
    pos = seeds.clone()
    frozen = torch.zeros(K, dtype=torch.bool, device=vol.device)
    steps, ids, most = 0, [], 0
    for it in range(n_iter):
        active = int((~frozen).sum())
        steps += active
        most = it + 1 if active else most
        p = patch_index(pos, vol.shape, goff, nx)
        ids.append(((p[..., 0] * Y + p[..., 1]) * Z
                    + p[..., 2])[~frozen].reshape(-1))
        Hn, G = _hessian_grad(vol[p[..., 0], p[..., 1], p[..., 2]]
                              .reshape(K, 3, 3, 3))
        Hinv, ok = _inv3(Hn)
        off = -(Hinv[..., 0] * G[:, 0:1] + Hinv[..., 1] * G[:, 1:2]
                + Hinv[..., 2] * G[:, 2:3])
        acc = (torch.abs(off) < max_offset).all(dim=1) & ok
        step = (((off < -max_offset) & (pos - 1 > 0)).long() * -1
                + ((off > max_offset) & (pos + 1 < rs - 1)).long())
        pos = torch.where((frozen | acc)[:, None], pos, pos + step)
        frozen = frozen | acc | ~ok
    distinct = int(torch.unique(torch.cat(ids)).numel()) if ids else 0
    return steps, distinct, most


def in_map_voxels(shape, box, starts):
    """Voxels of the boxes (box extent, (M, 3) corners) inside the map."""
    lo = np.clip(starts, 0, shape)
    hi = np.clip(starts + np.asarray(box), 0, shape)
    return int(np.prod(hi - lo, axis=1).sum())


def post_ccc_checks(fit, cfg, device):
    """K16, K17 and the simulation body against their plain versions at
    the inputs that one more bench fit gives them, recorded at their call
    sites: K16's first round (its lanes, and the table's rows that the
    rescue round may take), K17 at both of its call sites (the solutions'
    score, then score_models), the body at the fit's five simulate calls.
    K16 equal (its moved anchors within K16_ANCHOR_TOL), K17 within
    CCC_TOL, the body bit for bit."""
    import torch
    from mad_tpu_torch.engine import docking
    from mad_tpu_torch.kernels import ccc as k17, post as k16
    from mad_tpu_torch.kernels import launch_counts
    from mad_tpu_torch.ops import simulate
    from mad_tpu_torch.testing import recording
    out = {}
    with recording(docking, "post") as posts, \
            recording(k17, "batched_ccc") as cccs, \
            recording(simulate, "_simulate_batch") as sims:
        run_fit(device, None, cfg)
        torch.cuda.synchronize()
    check(posts and len(cccs) == 2 and len(sims) == len(SIMULATE_CALLS),
          f"recorded {len(posts)} K16, {len(cccs)} K17 and {len(sims)} "
          "simulate calls in the fit")

    # K16, the first round: the whole round against post_plain, then each
    # stage entry against its plain version at the round's inputs. Work
    # (float64): each lane's centroid, its anchors moved and measured
    # against every map anchor (lanes); the RMSD of each lane to every
    # earlier solution and lane (dedup); each map anchor measured against
    # every accepted atom (points); each row's binary search of the cloud
    # (3 compares a step) and, off the cloud, its own atom distances
    # (rows); the flags read and the rows written (compaction); each
    # stage's inputs read once, its outputs written.
    args = posts[0][:17]
    (rot_m, trans_m, coords_m, failed, cand_rot, cand_hi, cand_lo, x0,
     hi_cloud, lo_cloud, prev, idx, hit, dedup, lo_rows, ad, n_top) = args
    C, N = coords_m.shape[:2]
    A, B, S = hi_cloud.shape[0], lo_cloud.shape[0], prev.shape[0]
    n_idx, P = idx.shape[0], lo_rows.shape[0]
    got = k16.split_post(k16.post(*args).cpu().numpy(), C, A, n_top)
    ref = k16.split_post(k16.post_plain(*args).cpu().numpy(), C, A, n_top)
    check(all(np.array_equal(g, w) for g, w in zip(got[1:], ref[1:])),
          "K16 hits, counts, accepted, slots or rows differ from the plain "
          "version")
    err = float(np.abs(got[0] - ref[0]).max())
    check(err <= K16_ANCHOR_TOL, f"K16 moved anchors differ by {err:g} A")
    n_acc = int(got[3].sum())
    # ... and the host path's cKDTree queries on K16's own poses: the hits
    # (d <= hit_thresh) and the eligible rows (d > anchor_dist, the first
    # n_top in table order).
    from scipy.spatial import cKDTree
    lo_np, rows_np = lo_cloud.cpu().numpy(), lo_rows.cpu().numpy()
    ok = ~failed.cpu().numpy()
    d, _ = cKDTree(lo_np).query(got[0][ok], distance_upper_bound=hit)
    check(np.array_equal(got[1][ok], d <= hit),
          "K16 hits differ from cKDTree's")
    atoms = np.concatenate([prev.cpu().numpy().reshape(-1, 3),
                            coords_m.cpu().numpy()[got[3]].astype(np.float64)
                            .reshape(-1, 3)])
    d, _ = cKDTree(atoms).query(rows_np, distance_upper_bound=ad)
    check(np.array_equal(got[5], np.nonzero(d > ad)[0][:n_top]),
          "K16 eligible rows differ from cKDTree's")
    before = launch_counts()
    k16.post(*args)
    after = launch_counts()
    check(after["post_lanes_dedup"] == before["post_lanes_dedup"] + 1
          and after["post_lanes"] == before["post_lanes"]
          and after["post"] == before["post"],
          "K16's round on one device did not take the fold alone")
    whole_ms = cuda_ms(lambda: k16.post(*args))
    out.update(post_stage_checks(args, n_acc))
    say(f"  K16: {C} lanes x {A} anchors x {B} map anchors, {S} earlier "
        f"solutions, {n_idx} RMSD atoms of {N}; {int(got[2].sum())} hits, "
        f"{n_acc} accepted, {int((got[4] >= 0).sum()) - n_acc} merged; "
        f"{len(got[5])} rows taken of {P} (at most {n_top}); equal, moved "
        f"anchors within {err:g} A; hits and rows equal to cKDTree's; the "
        f"round (the fold and three entries) {whole_ms:.4f} ms")
    del posts, args

    # K17 at both call sites. Work: each in-map model voxel and its map
    # voxel read once (4 + 4 B), three float64 products and sums.
    for label, args in zip(("score", "score_models"), cccs):
        data, models, starts = args
        g, w = k17.batched_ccc(*args), k17.batched_ccc_plain(*args)
        err = float((g - w).abs().max())
        check(err <= CCC_TOL, f"K17 {label}: CCC differs by {err:g}")
        M, box = models.shape[0], tuple(models.shape[1:])
        inside = in_map_voxels(np.asarray(data.shape), box,
                               starts.cpu().numpy())
        r = measure(err, lambda: k17.batched_ccc(*args),
                    lambda: k17.batched_ccc_plain(*args),
                    inside * 8 + M * (12 + 4), inside * 6,
                    peak_ops=PEAK_F64_S)
        say(f"  K17 {label}: {M} models of {box} against "
            f"{tuple(data.shape)}, {inside} voxels in the map; CCC max diff "
            f"{err:g}; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms")
        if label == "score_models":
            out["batched_ccc"] = r
    del cccs, args

    out.update(simulate_body_checks(sims, device))
    return out


def plain_body(args):
    """The plain simulation body on the card with its scatter on the CPU
    (index_add_ on the card adds with atomics) and its blur the plain
    shift-adds."""
    import torch
    import mad_tpu_torch.ops.convolve as convolve
    from mad_tpu_torch.kernels import conv1d, scatter
    from mad_tpu_torch.ops import simulate
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in args[:6]]
    grids = scatter.scatter_atoms_plain(*cpu).to(args[0].device)
    with plain_versions([(convolve, "conv1d_along",
                          conv1d.conv1d_along_plain)]):
        return simulate.finish_plain(grids, *args[6:])


def plain_on_card(args):
    """simulate_batch_plain on the card with the plain shift-adds for its
    blur: the body's plain version throughout."""
    import mad_tpu_torch.ops.convolve as convolve
    from mad_tpu_torch.kernels import conv1d
    from mad_tpu_torch.ops import simulate
    with plain_versions([(convolve, "conv1d_along",
                          conv1d.conv1d_along_plain)]):
        return simulate.simulate_batch_plain(*args)


def peak_bytes(fn):
    """Device memory fn() holds at its peak beyond what was allocated
    before it, in bytes (its result freed)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def simulate_body_checks(sims, device):
    """The simulation body at each recorded call (SIMULATE_CALLS):
    _simulate_batch on the card bit for bit with plain_body, its time and
    peak memory beside simulate_batch_plain's on the card; then, at the
    models' call, the blur's divide (x) and max (z) passes and the
    scale-and-clamp pass against their plain versions, timed with their
    bounds. Returns the report entries blur_divide, blur_max and
    simulate_scale."""
    import torch
    from mad_tpu_torch.kernels import conv1d, maxkey, scatter
    from mad_tpu_torch.ops import simulate
    out = {}
    for label, args in zip(SIMULATE_CALLS, sims):
        got = simulate._simulate_batch(*args)
        check(same_bits(got, plain_body(args)),
              f"simulation body {label}: differs from the plain body")
        M, box = args[1].shape[0], tuple(args[3])
        del got
        ms = cuda_ms(lambda: simulate._simulate_batch(*args))
        plain = cuda_ms(lambda: plain_on_card(args))
        peak = peak_bytes(lambda: simulate._simulate_batch(*args))
        peak_plain = peak_bytes(lambda: plain_on_card(args))
        say(f"  simulation body {label}: {M} x {args[1].shape[1]} atoms into "
            f"{box}, taps {len(args[6])}, isovalue {args[7]:g}; bit for bit "
            f"with the plain body (scatter on the CPU); kernels {ms:.4f} ms, "
            f"plain body on the card {plain:.4f} ms; peak "
            f"{peak / 2**20:.1f} MiB (plain {peak_plain / 2**20:.1f} MiB)")
    # the models' call: each new pass at its inputs there
    coords, masses, vox_min, box, margin, voxsp, taps, iso = sims[-1]
    M = masses.shape[0]
    gmax = maxkey.new_keys(M, device)
    grids = scatter.scatter_atoms(coords, masses, vox_min, box, margin, voxsp,
                                  max_into=gmax)
    div = maxkey.divisors(gmax).view(-1, 1, 1, 1)
    x_in = grids
    x = conv1d.conv1d_along(grids, taps, 0, "full", divide_by=gmax)
    check(same_bits(x, conv1d.conv1d_along_plain(grids / div, taps, 0,
                                                 "full")),
          "the blur's divide pass differs from its plain version")
    k = int(np.count_nonzero(taps))
    out["blur_divide"] = measure(
        0.0, lambda: conv1d.conv1d_along(x_in, taps, 0, "full",
                                         divide_by=gmax),
        lambda: conv1d.conv1d_along_plain(x_in / div, taps, 0, "full"),
        4 * (x_in.numel() + x.numel()) + 4 * M,
        x_in.numel() + 2 * k * x.numel())
    y = conv1d.conv1d_along(x, taps, 1, "full")
    del x, grids
    dmax = maxkey.new_keys(M, device)
    z = conv1d.conv1d_along(y, taps, 2, "full", max_into=dmax)
    zp = conv1d.conv1d_along_plain(y, taps, 2, "full")
    check(same_bits(z, zp) and torch.equal(
        maxkey.values(dmax), zp.amax(dim=(1, 2, 3))),
        "the blur's max pass differs from its plain version")
    del zp

    def z_kernel():
        keys = maxkey.new_keys(M, device)
        return conv1d.conv1d_along(y, taps, 2, "full", max_into=keys)
    out["blur_max"] = measure(
        0.0, z_kernel,
        lambda: conv1d.conv1d_along_plain(y, taps, 2, "full").amax(
            dim=(1, 2, 3)),
        4 * (y.numel() + z.numel()) + 4 * M, 2 * k * z.numel() + z.numel())
    del y
    want = scatter.scale_clamp_plain(z, dmax, iso)
    got = scatter.scale_clamp(z.clone(), dmax, iso)
    check(same_bits(got, want),
          "the scale-and-clamp pass differs from its plain version")
    del got, want

    def torch_ops():
        d = z / torch.clamp(z.amax(dim=(1, 2, 3), keepdim=True), min=1e-30)
        return torch.where(d < iso, torch.zeros_like(d), d) if iso else d
    work = z.clone()
    out["simulate_scale"] = measure(
        0.0, lambda: scatter.scale_clamp(work, dmax, iso),
        lambda: scatter.scale_clamp_plain(z, dmax, iso),
        8 * z.numel() + 4 * M, 2 * z.numel(), torch_ops)
    say(f"  the models' blur ({tuple(z.shape)}): divide pass, max pass and "
        "scale-and-clamp bit for bit with their plain versions")
    return out


def match_kernel_checks(fit, cfg, device):
    """K10's head, K11, K12 and K14 against their plain versions on the
    bench's matching inputs: the cosines of the fit's descriptor sets, the
    map anchors' voxels, every pair's pose, and the first-round table's
    n_scan rows."""
    import torch
    from mad_tpu_torch.engine import match as em
    from mad_tpu_torch.engine.cluster import filter_pairs
    from mad_tpu_torch.engine.docking import (cluster_candidates,
                                              selection_args)
    from mad_tpu_torch.kernels import approx, cluster, field, pairs
    out = {}
    m, s, dmap, mc = fit["map_set"], fit["sub_set"], fit["dmap"], cfg.match

    # K10's head: equal keys. Work: the cosines read once, one compare
    # each, the head written. Library: torch.topk per row, then over the
    # flat row heads (mad_tpu's form), and the threshold.
    sim = s.desc_norm @ m.desc_norm.T
    dh, dl = sim.shape
    thr = float(mc.cc_threshold)
    args = (sim, mc.row_cap, mc.max_pairs, thr)
    k1, k2 = pairs.pair_head(*args), pairs.pair_head_plain(*args)
    check(torch.equal(k1, k2), "K10 head differs from the plain version")
    n_pairs = int((k1 != -1).sum())
    k = min(mc.row_cap, dl)

    def topk_heads():
        vals, _cols = torch.topk(sim, k, dim=1)
        gv, _gi = torch.topk(vals.reshape(-1), min(mc.max_pairs, dh * k))
        return gv > thr

    out["pair_head"] = measure(0.0, lambda: pairs.pair_head(*args),
                               lambda: pairs.pair_head_plain(*args),
                               sim.numel() * 4 + k1.numel() * 8, sim.numel(),
                               topk_heads)
    out["pair_head"]["kernel_ms"] = alone_ms(lambda: pairs.pair_head(*args))
    say(f"  K10 head: {dh} x {dl} cosines, {n_pairs} pairs (head "
        f"{k1.numel()})")
    cut = (sim, mc.row_cap, K10_CUT_PAIRS, thr)
    check(torch.equal(pairs.pair_head(*cut), pairs.pair_head_plain(*cut)),
          f"K10 head with max_pairs {K10_CUT_PAIRS} differs from the plain "
          "version")
    say(f"  K10 head, max_pairs {K10_CUT_PAIRS}: {dh * k} row-head keys, "
        f"equal; kernel alone "
        f"{alone_ms(lambda: pairs.pair_head(*cut)):.4f} ms, wrapper "
        f"{cuda_ms(lambda: pairs.pair_head(*cut)):.4f} ms")
    del sim, k1, k2, cut

    # K11: equal bytes. Work: the field written once, the anchors read.
    p = em.match_pairs(m, s, mc)
    lo_vox = torch.as_tensor(em.anchor_voxels(
        p["lo_cloud"], dmap.origin, dmap.voxsp, dmap.shape), device=device)
    r_vox = max(1, int(round(mc.anchor_dist / dmap.voxsp)))
    args = (tuple(dmap.shape), lo_vox, r_vox)
    f1, f2 = field.anchor_field(*args), field.anchor_field_plain(*args)
    check(torch.equal(f1, f2), "K11 field differs from the plain version")
    out["anchor_field"] = measure(
        0.0, lambda: field.anchor_field(*args),
        lambda: field.anchor_field_plain(*args),
        f1.numel() + lo_vox.numel() * 4,
        lo_vox.shape[0] * (2 * r_vox + 1) ** 3)
    out["anchor_field"]["kernel_ms"] = alone_ms(
        lambda: field.anchor_field(*args))
    say(f"  K11: {lo_vox.shape[0]} anchors, radius {r_vox}, field "
        f"{tuple(f1.shape)}, {int(f1.sum())} voxels set")
    del f2

    # K12: equal on every pair, those with a moved anchor within K12_EDGE
    # voxel of a .5 rounding edge counted (and those whose edge is on the
    # pair's own anchor, x = h, so y = l exactly). Work: each pair's pose,
    # the subunit cloud and the map anchors' voxels read, ~APPROX_FLOPS
    # per moved anchor, the distinct in-grid voxels it looks up read once,
    # the scores written; beside it the field reads the kernel makes (the
    # in-grid anchors in a set cell of its coarse map).
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    args = (f1, lo_vox, r_vox, f32(p["hi_cloud"]), f32(dmap.origin),
            float(np.float32(1.0 / dmap.voxsp)), f32(p["rot"]),
            f32(p["hi_coord"]), f32(p["lo_coord"]))
    r1, r2 = approx.approx_repeat(*args), approx.approx_repeat_plain(*args)
    e = approx_edges(*args)
    check(torch.equal(r1, r2),
          f"K12 differs on {int((r1 != r2).sum())} pairs from the plain "
          f"version ({int((e['edge'] & (r1 != r2)).sum())} on a .5 edge)")
    P, a_hi = args[6].shape[0], args[3].shape[0]
    out["approx_repeat"] = measure(
        0.0, lambda: approx.approx_repeat(*args),
        lambda: approx.approx_repeat_plain(*args),
        e["touched"] + a_hi * 12 + lo_vox.shape[0] * 12 + 12
        + P * (36 + 24 + 4), P * a_hi * APPROX_FLOPS)
    out["approx_repeat"]["kernel_ms"] = alone_ms(
        lambda: approx.approx_repeat(*args))
    say(f"  K12: {P} pairs x {a_hi} anchors, equal; {int(e['edge'].sum())} "
        f"pairs on a .5 edge, {int(e['own'].sum())} of them on the pair's "
        f"own anchor ({int(e['own_only'].sum())} only there); "
        f"{e['in_grid']} moved anchors in the grid, {e['gathers']} in a set "
        f"cell of edge {1 << approx.coarse_shift(f1.shape)} (the kernel's "
        f"field reads, against {P * a_hi}); kernel alone "
        f"{out['approx_repeat']['kernel_ms']:.4f} ms")
    del args, r1, r2, f1

    # K14: the first round's selection equal, and its candidates those of
    # engine/cluster.filter_pairs. Work: per scanned row its RMSD to every
    # cluster founded before it (R2_FLOPS float64 flops each); the rows
    # read, the selection written.
    n_samples = cfg.filter.n_samples * N_COPIES
    table = em.match_descriptors(m, s, dmap.shape, dmap.origin, dmap.voxsp,
                                 mc, min_exact=n_samples, device=device)
    n = min(n_samples, table.n)
    fc = cfg.filter
    args = selection_args(table, fc, n, device)
    c1, c2 = cluster.cluster_select(*args), cluster.cluster_select_plain(*args)
    check(torch.equal(c1, c2), "K14 selection differs from the plain version")
    hb, lb = s.main_bin[table.hi_idx], m.main_bin[table.lo_idx]
    got = cluster_candidates(table, hb, lb, fc, n_samples, device)
    want = filter_pairs(table, hb, lb, fc, n_samples)
    check([(c.weight, c.repeat, c.score) for c in got]
          == [(c.weight, c.repeat, c.score) for c in want]
          and all(np.array_equal(a.lo_coord, b.lo_coord)
                  for a, b in zip(got, want)),
          "K14 candidates differ from engine/cluster.filter_pairs")
    _assign, found, _w, _c, n_cands = cluster.split_selection(
        c1.cpu().numpy(), n)
    founded_before = np.searchsorted(found, np.arange(n))   # found ascends
    out["cluster_select"] = measure(
        0.0, lambda: cluster.cluster_select(*args),
        lambda: cluster.cluster_select_plain(*args),
        n * (36 + 48 + 4) + 8 * 12 + (4 * n + 2) * 4,
        int(founded_before.sum()) * R2_FLOPS, peak_ops=PEAK_F64_S)
    out["cluster_select"]["kernel_ms"] = alone_ms(
        lambda: cluster.cluster_select(*args))
    say(f"  K14: {n} rows, {len(found)} clusters, {n_cands} candidates, "
        f"equal to filter_pairs; kernel alone "
        f"{out['cluster_select']['kernel_ms']:.4f} ms")
    for label, rmsd in K14_STRESS_RMSD:
        args = k14_stress_args(device, rmsd)
        c1 = cluster.cluster_select(*args)
        check(torch.equal(c1, cluster.cluster_select_plain(*args)),
              f"K14 on the stress table ({label}) differs from the plain "
              "version")
        n = args[0].shape[0]
        _assign, found, _w, _c, n_cands = cluster.split_selection(
            c1.cpu().numpy(), n)
        say(f"  K14 stress ({label}, rmsd_cloud {rmsd:g}): {n} rows, "
            f"{len(found)} clusters, {n_cands} candidates, equal; kernel "
            f"alone {alone_ms(lambda: cluster.cluster_select(*args)):.4f} "
            f"ms, wrapper "
            f"{cuda_ms(lambda: cluster.cluster_select(*args)):.4f} ms")
    return out


def k14_stress_args(device, rmsd_cloud):
    """K14's arguments on the K14_STRESS table, all its rows scanned, at
    the bench's filter settings but ``rmsd_cloud``."""
    import dataclasses
    from mad_tpu_torch.convert import match_table_from_numpy
    from mad_tpu_torch.engine.docking import selection_args
    from mad_tpu_torch.testing import pose_table
    table = match_table_from_numpy(**pose_table(**K14_STRESS))
    fc = dataclasses.replace(bench_config().filter, rmsd_cloud=rmsd_cloud)
    return selection_args(table, fc, table.n, device)


def k13_stress_args(device):
    """K13's arguments at K13_STRESS, at the bench's 4 A radius."""
    import torch
    from mad_tpu_torch.testing import repeat_inputs
    return tuple(torch.as_tensor(a, device=device)
                 for a in repeat_inputs(**K13_STRESS)) + (
        float(bench_config().match.anchor_dist),)


def approx_edges(field, vox, r_vox, hi_cloud, origin, inv, rot, hi, lo,
                 chunk=1024):
    """K12's work and edges on its arguments: per pair, whether a moved
    anchor lies within K12_EDGE voxel of a .5 rounding edge (float64,
    ``edge``), whether such an anchor is the pair's own (x = h: y = l
    exactly; ``own``) and whether only own anchors are (``own_only``); the
    distinct in-grid voxels the pairs look up (``touched``), the moved
    anchors in the grid (``in_grid``) and those in a set cell of the
    kernel's coarse map (``gathers``: its field reads)."""
    import torch
    from mad_tpu_torch.core.geometry import rows_times
    from mad_tpu_torch.kernels import approx
    dims = torch.as_tensor(field.shape, device=field.device)
    seen = torch.zeros(field.numel(), dtype=torch.bool, device=field.device)
    cells = approx.coarse_cells(tuple(field.shape), vox, r_vox)
    s = approx.coarse_shift(tuple(field.shape))
    out = dict(edge=[], own=[], own_only=[], in_grid=0, gathers=0)
    for s0 in range(0, rot.shape[0], chunk):
        h = hi[s0:s0 + chunk]
        x = hi_cloud.double()[None] - h[:, None].double()
        y = (torch.einsum("pad,ped->pae", x, rot[s0:s0 + chunk].double())
             + lo[s0:s0 + chunk, None].double())
        v = (y - origin.double()) * inv
        near = ((v - torch.floor(v) - 0.5).abs() < K12_EDGE).any(dim=2)
        own = (hi_cloud[None] == h[:, None]).all(dim=2)
        out["edge"].append(near.any(dim=1))
        out["own"].append((near & own).any(dim=1))
        out["own_only"].append(near.any(dim=1) & ~(near & ~own).any(dim=1))
        # the voxels as K12 rounds them (float32, the plain version's sums)
        t = torch.round((rows_times(hi_cloud[None] - h[:, None],
                                    rot[s0:s0 + chunk].transpose(1, 2))
                         + lo[s0:s0 + chunk, None] - origin) * inv)
        t = t[((t >= 0) & (t < dims)).all(dim=2)].long()
        out["in_grid"] += t.shape[0]
        out["gathers"] += int(cells[t[:, 0] >> s, t[:, 1] >> s,
                                    t[:, 2] >> s].sum())
        seen[(t[:, 0] * dims[1] + t[:, 1]) * dims[2] + t[:, 2]] = True
    for k in ("edge", "own", "own_only"):
        out[k] = torch.cat(out[k])
    out["touched"] = int(seen.sum())
    return out


def orient_check(fit, cfg, device):
    """K6 against orient_plain on every anchor of the bench map's two
    octaves at the default settings: lane validity, main and secondary
    bins equal on every anchor, frames within K6_RFINAL_TOL on the valid
    lanes. Times and work are the sums over the two octaves. On the base
    octave also the other K6_SETTINGS, held to >= K6_AGREE of the anchors
    agreeing; each launched twice to show that the kernel is
    deterministic."""
    import dataclasses
    import torch
    from mad_tpu_torch.kernels import orient as k6
    from mad_tpu_torch.ops.detect import detect_anchors
    from mad_tpu_torch.ops.orient import _OrientTables
    from mad_tpu_torch.ops.scalespace import gradient, iter_octaves
    from mad_tpu_torch.testing import orient_agreement

    def compare(oc, octv, grad, coords, valid, what, every=False):
        radius = (oc.patch_size - oc.patch_size % 2) // 2
        stride = 2 if octv.upsampled else 1
        tab = _OrientTables(oc, radius, stride, device)
        args = (grad, coords, valid, octv.real_shape, tab, radius, stride,
                oc.max_main, oc.max_sec, oc.cutoff_magn)
        got = k6.orient(*args)
        again = k6.orient(*args)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"K6 {what}: two launches differ")
        ref = k6.orient_plain(*args)
        share, dmax, close = orient_agreement(got, ref, K6_RFINAL_TOL)
        K = got[3].shape[0]
        agreeing = round(share * K)
        check((agreeing == K if every else share >= K6_AGREE) and close,
              f"K6 {what}: agrees on {agreeing} of {K} anchors, frames "
              f"within {dmax:g}")
        say(f"  K6 {what}: K {K} anchors, "
            f"{int(got[3].any(dim=(1, 2)).sum())} oriented, "
            f"{int(got[3].sum())} lanes; anchors agreeing {share:.5f}, "
            f"frames max diff {dmax:g}, two launches equal")
        return args, got, tab, radius, stride, dmax

    oc = cfg.orient
    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0)
    for _org, octv in iter_octaves(fit["dmap"], cfg.scalespace):
        log_vol, gauss = octv.log_gauss()
        anch = detect_anchors(log_vol, octv.real_shape, cfg.detect)
        del log_vol
        grad = gradient(gauss, octv.grad_dtype())
        del gauss
        coords = anch.coords[anch.valid]
        valid = torch.ones(coords.shape[0], dtype=torch.bool, device=device)
        name = "upsampled" if octv.upsampled else "base"
        args, got, tab, radius, stride, dmax = compare(
            oc, octv, grad, coords, valid, f"{name} octave", every=True)
        nbytes, ops = orient_work(args, got)
        r = measure(dmax, lambda: k6.orient(*args),
                    lambda: k6.orient_plain(*args), nbytes, ops)
        say(f"    kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        for key in ("ms", "plain_ms", "bytes", "ops"):
            total[key] += r[key]
        total["max_abs_err"] = max(total["max_abs_err"], dmax)
        del args, got
        if not octv.upsampled:
            for patch, gw_sig in K6_SETTINGS:
                compare(dataclasses.replace(oc, patch_size=patch,
                                            gw_sig=gw_sig),
                        octv, grad, coords, valid,
                        f"base octave, patch {patch}, gw_sig {gw_sig}")
        del grad
    total.update(library_ms=None, **bound(total["bytes"], total["ops"]))
    return total


def orient_work(args, out, chunk=32):
    """Bytes and operations the function K6 computes needs on these
    anchors. Bytes: the distinct gradient voxels under the patches of the
    anchors inside the border, read once; the mask, the coords and the
    outputs. Operations: per sample of such a patch ~10 flops for its norm,
    direction and weight; per sample of nonzero weight in each histogram
    the anchor needs (its own, and one per main bin with a valid frame)
    ~40 for atan2 / acos, 15 to rotate it (main-bin histograms), 2
    compares per belt of zones (the phi range) and 4 per zone of the belts
    whose phi range holds it (the theta ranges)."""
    import torch
    from mad_tpu_torch.core.geometry import norm3
    grad, coords, valid, real_shape, tab, radius, stride = args[:7]
    cutoff = args[9]
    goff = args[11] if len(args) > 11 else 0      # the offset form's block
    K, M, S = out[3].shape
    P, X, Y, Z = tab.mask.numel(), *grad.shape[:3]
    belts, per_belt = torch.unique(tab.bounds[:, [1, 3]], dim=0,
                                   return_counts=True)
    rs = torch.as_tensor(real_shape, device=coords.device)
    half = radius * stride
    inside = (valid & (coords - half >= 0).all(dim=1)
              & (coords + half + 1 <= rs - 1).all(dim=1))
    main_ok = out[3].any(dim=2)                               # (K, M)
    ids, ops = [], 0
    for s0 in range(0, K, chunk):
        keep = inside[s0:s0 + chunk]
        pts = coords[s0:s0 + chunk][keep][:, None, :] + tab.offsets[None]
        pts[..., 0] -= goff
        ids.append(((pts[..., 0] * Y + pts[..., 1]) * Z
                    + pts[..., 2]).reshape(-1))
        g = grad[pts[..., 0], pts[..., 1], pts[..., 2]].to(torch.float32)
        magn = norm3(g)
        d = g / torch.clamp(magn, min=1e-30)[..., None]
        w = (tab.mask > 0) & (magn >= cutoff)                 # (n, P)
        Rm = tab.rot_to_pole[out[0][s0:s0 + chunk][keep].long()]
        z = torch.cat([d[:, None, :, 2],                      # (n, 1+M, P)
                       (d[:, None] * Rm[:, :, None, 2, :]).sum(-1)], 1)
        use = torch.cat([torch.ones_like(keep[keep])[:, None],
                         main_ok[s0:s0 + chunk][keep]], 1)    # (n, 1+M)
        sel = w[:, None, :] & use[:, :, None]
        phi = torch.arccos(torch.clamp(z, -1.0, 1.0))[..., None]
        zones = ((phi > belts[:, 0]) & (phi < belts[:, 1])).to(
            torch.float32) @ per_belt.to(torch.float32)       # (n, 1+M, P)
        ops += (10 * P * int(keep.sum())
                + int(sel.sum()) * (40 + 2 * belts.shape[0])
                + 15 * int(sel[:, 1:].sum()) + 4 * float(zones[sel].sum()))
    distinct = int(torch.unique(torch.cat(ids)).numel()) if ids else 0
    nbytes = (distinct * 3 * grad.element_size() + P * 4 + K * 13
              + K * M * 4 + K * M * S * (4 + 36 + 1))
    return nbytes, ops


def refine_check(fit, cfg, device):
    """K15 against refine_loop_plain on the bench's first-round candidates
    (the start poses that docking's first refinement takes): the same
    failed flags, final CA-RMSD to the plain version <= SMALL_POSE_TOL for
    every candidate and <= K15_MEDIAN in the median."""
    from mad_tpu_torch.engine.cluster import filter_pairs
    from mad_tpu_torch.engine.docking import start_poses
    from mad_tpu_torch.engine.match import match_descriptors
    from mad_tpu_torch.engine.refine import refine_inputs
    from mad_tpu_torch.kernels import build, refine as k15
    from mad_tpu_torch.testing import ca_rmsds
    m, s, dmap, moved = (fit["map_set"], fit["sub_set"], fit["dmap"],
                         fit["moved"])
    n_samples = cfg.filter.n_samples * N_COPIES
    table = match_descriptors(m, s, dmap.shape, dmap.origin, dmap.voxsp,
                              cfg.match, min_exact=n_samples, device=device)
    cands = filter_pairs(table, s.main_bin[table.hi_idx],
                         m.main_bin[table.lo_idx], cfg.filter, n_samples)
    args = refine_inputs(dmap, start_poses(cands, moved), device)
    rc = cfg.refine
    got = k15.refine_loop(*args, rc)
    ref = k15.refine_loop_plain(*args, rc)
    failed = ref[5].cpu().numpy()
    check(np.array_equal(got[5].cpu().numpy(), failed),
          "K15 failed flags differ")
    d = ca_rmsds(got[2].cpu().numpy(), ref[2].cpu().numpy(),
                 moved.ca_idx)[~failed]
    check(len(d) and d.max() <= SMALL_POSE_TOL
          and np.median(d) <= K15_MEDIAN,
          f"K15 final CA-RMSD to plain: max {d.max():g}, median "
          f"{np.median(d):g}")
    steps = got[4].cpu().numpy()
    C, N = args[1].shape[:2]
    touched = field_voxels(args[1], got[2], args[4], dmap.shape)
    nbytes = (touched * 12 + C * N * 12 * 2 + C * (12 + 4 + 36 + 12 + 6)
              + 28)
    r = measure(float((got[2] - ref[2]).abs().max()),
                lambda: k15.refine_loop(*args, rc),
                lambda: k15.refine_loop_plain(*args, rc), nbytes,
                int(steps.sum()) * N * REFINE_FLOPS)
    r["kernel_ms"] = alone_ms(lambda: k15.refine_loop(*args, rc))
    q = np.quantile(d, [0.0, 0.5, 0.9, 1.0])
    say(f"  K15: C {C} candidates x N {N} atoms, {int(failed.sum())} "
        f"failed, steps {int(steps.min())}-{int(steps.max())} "
        f"(sum {int(steps.sum())}); CA-RMSD to plain min/median/p90/max "
        f"{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f}/{q[3]:.4f} A, "
        f"{int((d > K15_MEDIAN).sum())} above {K15_MEDIAN}; kernel alone "
        f"{r['kernel_ms']:.4f} ms ({r['kernel_ms'] / steps.max() * 1e3:.3f}"
        f" us a step of the longest candidate; kCluster "
        f"{build.constants('refine.cu')['kCluster']}), wrapper "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms")
    return r


def field_voxels(y0, coords, bounds, shape):
    """Distinct gradient-field voxels under the 8 interpolation corners of
    every atom at its start and final pose: the field bytes K15 needs,
    counted once."""
    import torch
    ids = []
    dims = torch.as_tensor(shape, device=y0.device)
    for x in (y0, coords):
        v = (x.reshape(-1, 3) - bounds[0:3]) / bounds[6]
        p0 = torch.minimum(torch.clamp(torch.floor(v).long(), min=0),
                           dims - 2)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    ids.append(((p0[:, 0] + dx) * shape[1] + p0[:, 1] + dy)
                               * shape[2] + p0[:, 2] + dz)
    return int(torch.unique(torch.cat(ids)).numel())


def hetero_problem():
    """A seeded random upper-triangular overlap of 80 solutions in 5 groups
    of 16 (16^5 = 1,048,576 tuples), as tests/test_assemble.py:90-110."""
    n_per, n_groups = HETERO["n_per"], HETERO["n_groups"]
    rng = np.random.default_rng(HETERO["seed"])
    n_sol = n_per * n_groups
    ov = np.triu(rng.random((n_sol, n_sol)) * 0.2, k=1)
    groups = {f"s{g}": list(range(g * n_per, (g + 1) * n_per))
              for g in range(n_groups)}
    return ov, groups


def scatter_flat(coords, masses, vox_min, box, margin, voxsp):
    """K9's scatter as flat work for one library call: the flattened grids,
    and the corner indices and weights, computed here."""
    import torch
    dev = coords.device
    M = coords.shape[0]
    g = margin + (coords - vox_min[:, None, :]) / torch.tensor(
        voxsp, dtype=torch.float32, device=dev)
    g0 = torch.floor(g)
    w1 = g - g0
    w0 = 1.0 - w1
    i0 = g0.long()
    dims = torch.as_tensor(box, device=dev)
    sid = torch.arange(M, device=dev)[:, None].expand(-1, coords.shape[1])
    idx, wts = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (masses * (w1[..., 0] if dx else w0[..., 0])
                     * (w1[..., 1] if dy else w0[..., 1])
                     * (w1[..., 2] if dz else w0[..., 2]))
                c = i0 + torch.as_tensor([dx, dy, dz], device=dev)
                keep = ((c >= 0) & (c < dims)).all(dim=-1)
                flat = ((sid * box[0] + c[..., 0]) * box[1]
                        + c[..., 1]) * box[2] + c[..., 2]
                idx.append(flat[keep])
                wts.append(w[keep])
    idx, wts = torch.cat(idx), torch.cat(wts)
    grids = torch.zeros(M * box[0] * box[1] * box[2], dtype=torch.float32,
                        device=dev)
    return grids, idx, wts


def scatter_index_add(*args):
    """K9's library yardstick: one index_add_ on the flattened grids."""
    grids, idx, wts = scatter_flat(*args)
    return lambda: grids.zero_().index_add_(0, idx, wts)


def scatter_index_put(*args):
    """K9's second library yardstick: one index_put_(accumulate=True) on
    the flattened grids, which sorts its indices on the card and so adds
    in a fixed order."""
    grids, idx, wts = scatter_flat(*args)
    return lambda: grids.zero_().index_put_((idx,), wts, accumulate=True)


def assembly_kernel_checks(fit, cfg, device):
    """K9 on the bench map, the subunit, the solutions' and the models'
    batches, K18, K19 at the shapes of the fit's assembly step and K20 at
    16^5; K9 bit for bit with its plain version run on the CPU,
    K9_REPEATS launches equal and its maxima equal to amax's, the others
    equal."""
    import torch
    from mad_tpu_torch.engine import assemble as asm
    from mad_tpu_torch.kernels import enumerate as k_enum
    from mad_tpu_torch.kernels import hetero, maxkey, scatter
    from mad_tpu_torch.ops import simulate
    from mad_tpu_torch.ops.simulate import scatter_args, simulate_density
    from mad_tpu_torch.testing import recording

    out = {}
    a = fit["assembly"]
    check(a is not None and a["models"], "the warm pass built no model")
    structures = a["structures"]
    n = len(structures)
    cb, mb = asm.atom_batch([[structures[i] for i in m.components]
                             for m in a["models"]])
    sb, sm = asm.atom_batch([[s] for s in structures])
    # the map's and the subunit's scatters, as run_fit simulates them
    with recording(simulate, "_simulate_batch") as sims:
        simulate_density(np.concatenate([c.coords for c in fit["copies"]]),
                         RES, VOXSP, device=device, masses=np.concatenate(
                             [c.masses for c in fit["copies"]]))
        simulate_density(fit["moved"], RES, fit["dmap"].voxsp, device=device,
                         shape_bucket=cfg.shape_bucket)
    cases = [("map", sims[0][:6]), ("subunit", sims[1][:6]),
             ("solutions", scatter_args(sb, sm, cfg.assembly.sim_voxsp,
                                        device)),
             ("models", scatter_args(cb, mb, fit["dmap"].voxsp, device))]
    for label, args in cases:
        keys = maxkey.new_keys(args[1].shape[0], device)
        g1 = scatter.scatter_atoms(*args, max_into=keys)
        again = [scatter.scatter_atoms(*args)
                 for _ in range(K9_REPEATS - 1)]
        cpu = [x.cpu() if torch.is_tensor(x) else x for x in args]
        check(same_bits(g1.cpu(), scatter.scatter_atoms_plain(*cpu)),
              f"K9 {label}: differs from the plain version on the CPU")
        check(all(same_bits(g1, g) for g in again),
              f"K9 {label}: {K9_REPEATS} launches differ")
        check(torch.equal(maxkey.values(keys), g1.amax(dim=(1, 2, 3))),
              f"K9 {label}: its maxima differ from amax's")
        del again, cpu
        put = scatter_index_put(*args)
        put_same = same_bits(put().view(g1.shape), g1)
        # Work: each atom read (16 B) and the grids written once.
        c = args[0]
        n_atoms = c.shape[0] * c.shape[1]
        res = measure(0.0, lambda: scatter.scatter_atoms(*args),
                      lambda: scatter.scatter_atoms_plain(*args),
                      n_atoms * 16 + g1.numel() * 4, n_atoms * (6 + 8 * 5),
                      scatter_index_add(*args))
        put_ms = cuda_ms(put)
        del put
        say(f"  K9 {label}: {c.shape[0]} x {c.shape[1]} atoms into "
            f"{tuple(g1.shape[1:])}, equal to the plain version on the CPU "
            f"bit for bit, {K9_REPEATS} launches equal; kernel "
            f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
            f"index_add_ {res['library_ms']:.3f} ms, index_put_ "
            f"(accumulate) {put_ms:.3f} ms (its grid "
            + ("bit-equal to K9's" if put_same else "differs from K9's")
            + f"), bound {res['bound_ms']:.4f} ms")
        out["scatter_atoms" if label == "models"
            else f"scatter_atoms_{label}"] = res
        del g1

    out.update(k18_checks(structures, cfg, device))

    # K19 and K20 read K18's upper-triangular overlap and symmetrize it
    # as they stage it (once K20b's launch); their plain versions stage it
    # with sym_trim_plain.
    k = min(N_COPIES, n)
    ov = torch.as_tensor(a["overlap"], dtype=torch.float32, device=device)
    tab = torch.as_tensor(k_enum.comb_table(n, k), device=device)
    e1 = k_enum.enumerate_head(ov, tab, 256)
    e2 = k_enum.enumerate_head_plain(ov, tab, 256)
    check(torch.equal(e1, e2), "K19 head differs from the plain version")
    # Work: the overlap's (n, n) block read once and one add an element;
    # per rank a k-step decode and the max over k(k-1)/2 pairs.
    ranks = math.comb(n, k)
    out["enumerate_head"] = measure(
        float(np.abs(k_enum.split_keys(e1)[1]
                     - k_enum.split_keys(e2)[1]).max()),
        lambda: k_enum.enumerate_head(ov, tab, 256),
        lambda: k_enum.enumerate_head_plain(ov, tab, 256),
        n * n * 4 + tab.numel() * tab.element_size() + 256 * 8,
        n * n + ranks * (2 * k + k * (k - 1) // 2))
    out["enumerate_head"]["kernel_ms"] = alone_ms(
        lambda: k_enum.enumerate_head(ov, tab, 256))
    say(f"  K19: C({n}, {k}) ranks from K18's ({n}, {n}) overlap, head "
        f"{len(e1)} (256, enumerate_homomultimer's default, the fit's "
        f"head); kernel alone {out['enumerate_head']['kernel_ms']:.4f} ms")

    ov, groups = hetero_problem()
    ov = torch.as_tensor(ov, dtype=torch.float32, device=device)
    lists = torch.as_tensor(np.asarray(list(groups.values())),
                            dtype=torch.int32, device=device)
    sizes = [len(g) for g in groups.values()]
    h1 = hetero.hetero_head(ov, lists, sizes, 256)
    h2 = hetero.hetero_head_plain(ov, lists, sizes, 256)
    check(torch.equal(h1, h2), "K20 head differs from the plain version")
    # Work: the overlap read once and one add an element; per tuple a
    # g-digit mixed-radix decode and g(g-1)/2 adds.
    n_g, tuples = len(sizes), int(np.prod(sizes))
    out["hetero_head"] = measure(
        float(np.abs(k_enum.split_keys(h1)[1]
                     - k_enum.split_keys(h2)[1]).max()),
        lambda: hetero.hetero_head(ov, lists, sizes, 256),
        lambda: hetero.hetero_head_plain(ov, lists, sizes, 256),
        ov.numel() * 4 + lists.numel() * 4 + 256 * 8,
        ov.numel() + tuples * (2 * n_g + n_g * (n_g - 1) // 2))
    out["hetero_head"]["kernel_ms"] = alone_ms(
        lambda: hetero.hetero_head(ov, lists, sizes, 256))
    say(f"  K20: {tuples} tuples over {ov.shape[0]} solutions, head "
        f"{len(h1)}; kernel alone {out['hetero_head']['kernel_ms']:.4f} ms, "
        f"wrapper {out['hetero_head']['ms']:.4f} ms")
    return out


def k18_checks(structures, cfg, device):
    """K18 on the fit's solutions and on K18_HETERO_M solutions (the
    fit's, each again at small lattice shifts), bit for bit with the plain
    version; the kernel alone (kernel_ms) beside the wrapper's time; at
    both, torch.mm of the frame-placed float32 occupancy as the library
    yardstick, which computes the counts only (not the fractions; every
    count is below 2^24, so its float32 sums are exact and are held equal
    to the kernel's). Work: the boxes read once, one compare a voxel, and
    per pair an AND and a popcount a 32-voxel word of the frame."""
    import torch
    from mad_tpu_torch.engine import assemble as asm
    from mad_tpu_torch.kernels import overlap
    rng = np.random.default_rng(SEED)
    n = len(structures)
    shifted = [s.with_coords(s.coords + rng.integers(-3, 4, 3)
                             * cfg.assembly.sim_voxsp)
               for s in structures * (K18_HETERO_M // n)]
    out = {}
    for label, sols in (("fit", structures), ("heteromer", shifted)):
        dens, off, frame = asm.overlap_inputs(sols, cfg.assembly, device)
        m = dens.shape[0]
        o1 = overlap.pack_overlap(dens, off, frame)
        o2 = overlap.pack_overlap_plain(dens, off, frame)
        check(same_bits(o1, o2), f"K18 {label} ({m} solutions) differs "
              "from the plain version")
        counts = torch.empty(m * m + 1, dtype=torch.int32, device=device)
        ov = torch.empty((m, m), dtype=torch.float32, device=device)
        k_ms = kernel_ms(lambda: overlap.launch_overlap(dens, off, frame,
                                                        counts, ov))
        check(same_bits(ov, o1), f"K18 {label}: the bare launch differs")
        words = int(np.prod(frame)) // 32
        occ = torch.zeros((m,) + tuple(frame), device=device)
        X, Y, Z = dens.shape[1:]
        for s, (ox, oy, oz) in enumerate(off.tolist()):
            occ[s, ox:ox + X, oy:oy + Y, oz:oz + Z] = (dens[s] > 0).float()
        occ = occ.reshape(m, -1)
        mm = torch.mm(occ, occ.T)
        tri = torch.triu(torch.ones((m, m), dtype=torch.bool, device=device))
        check(torch.equal(mm.to(torch.int32)[tri],
                          counts[:m * m].view(m, m)[tri]),
              f"K18 {label}: the counts differ from torch.mm's")
        library = lambda: torch.mm(occ, occ.T)
        r = measure(0.0, lambda: overlap.pack_overlap(dens, off, frame),
                    lambda: overlap.pack_overlap_plain(dens, off, frame),
                    dens.numel() * 4 + m * 12 + m * m * 4,
                    dens.numel() + m * (m + 1) // 2 * words * 2, library)
        r["kernel_ms"] = k_ms
        say(f"  K18 {label}: {m} solutions, boxes {tuple(dens.shape[1:])}, "
            f"frame {frame}, equal; kernel alone {k_ms:.4f} ms, wrapper "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); torch.mm of the "
            f"frame-placed occupancy (the counts only) "
            f"{r['library_ms']:.4f} ms")
        out["pack_overlap" if label == "fit" else "pack_overlap_" + label] = r
        del dens, off, counts, ov, o1, o2, occ, mm, library
    return out


def _near_radius(hi_cloud, lo_cloud, rot, hi, lo, thresh, chunk=4):
    """Pairs with a moved anchor whose float64 NN distance lies within
    1e-4 A of the radius (the kernel and the plain version may split
    there)."""
    import torch
    hc, lc = hi_cloud.double(), lo_cloud.double()
    out = []
    for s in range(0, rot.shape[0], chunk):
        y = torch.einsum("cad,ced->cae", hc[None] - hi[s:s + chunk, None]
                         .double(), rot[s:s + chunk].double()) \
            + lo[s:s + chunk, None].double()
        d = ((y[:, :, None] - lc[None, None]) ** 2).sum(-1).amin(-1).sqrt()
        out.append(((d - thresh).abs() < 1e-4).any(dim=1))
    return torch.cat(out)


# -- phase 7: the MaD session -----------------------------------------------

def session_phase(device, cfg, fit, root):
    """The bench map and subunit through ``mad_tpu_torch.api.MaD`` in a
    fresh workdir under ``root``: add_map, add_subunit(n_copies=10), run
    with the decoy transform, build_assembly; then a second run() in the
    same workdir, which must load the dsc_db and pose_db caches and give
    the same solutions. Returns the inputs' paths and the first run's
    solutions."""
    import contextlib
    import glob
    import io
    import os
    import torch
    from mad_tpu_torch.api import MaD
    from mad_tpu_torch import api
    from mad_tpu_torch.core.grid import write_mrc
    from mad_tpu_torch.core import structure
    from mad_tpu_torch.core.structure import parse_pdb, write_pdb
    from mad_tpu_torch.kernels import launch_counts, reset_launches
    from mad_tpu_torch.native import get_fastio
    from mad_tpu_torch.testing import recording
    check(get_fastio() is not None, "native: the C parsers did not build")
    work = os.path.join(root, "session")
    os.makedirs(work)
    map_path = os.path.join(work, "bench_map.mrc")
    sub_path = os.path.join(work, "bench_sub.pdb")
    write_mrc(fit["dmap"], map_path)
    write_pdb(fit["copies"][0], sub_path)
    secs, logs = [], []
    with recording(api, "parse_pdb") as parses, \
            recording(structure, "_parse_pdb_native") as natives:
        for attempt in range(2):
            log = io.StringIO()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                mad = MaD(workdir=work, config=cfg, device=device)
                mad.add_map(map_path, resolution=RES)
                mad.add_subunit(sub_path, n_copies=N_COPIES)
                mad.run(transform_subunits=True)
                if attempt == 0:
                    t_run = time.perf_counter() - t0
                    mad.build_assembly()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            logs.append(log.getvalue())
            if attempt == 0:
                first, counts = mad, launch_counts()
    native_parses = len(natives)
    check(parses and native_parses == len(parses),
          f"session: {len(parses)} parse_pdb calls, {native_parses} through "
          "the native parser")
    say(f"session: {len(parses)} parse_pdb calls in the two runs, all "
        f"{native_parses} through the native parser")
    out = first.out_folder
    files = sorted(glob.glob(os.path.join(
        out, "individual_solutions", "sol_bench_sub_*.pdb")))
    sols = [parse_pdb(f) for f in files]
    rmsds = best_rmsds(sols, fit["copies"])
    found = int(np.sum(np.asarray(rmsds) < RECOVER_RMSD))
    with open(os.path.join(out, "Solutions_refined_bench_sub.csv")) as fh:
        rows = fh.read().strip().splitlines()[1:]
    models = glob.glob(os.path.join(out, "assembly_models",
                                    "Model_*.pdb"))
    say(f"session: run {t_run:.3f} s, run + build_assembly "
        f"{secs[0]:.3f} s, cached run {secs[1]:.3f} s; "
        f"{len(files)} sol_*.pdb, {found}/{N_COPIES} recovered (median "
        f"best CA-RMSD {np.median(rmsds):.3f} A), {len(rows)} CSV rows, "
        f"{len(models)} models; launches " + ", ".join(
            f"{k} {counts[k]}" for k in SESSION_KERNELS))
    check(all(counts[k] > 0 for k in SESSION_KERNELS),
          f"session: a kernel of {SESSION_KERNELS} never launched: "
          f"{counts}")
    check(found >= MIN_RECOVERED,
          f"session: only {found}/{N_COPIES} copies recovered")
    check(len(rows) == len(files) == len(first.solutions["bench_sub"]),
          "session: Solutions_refined CSV rows differ from solutions")
    check(models and os.path.exists(os.path.join(
        out, "complex_ranking.csv")), "session: no model artifacts")
    check("found in database" in logs[1]
          and "found in pose checkpoint" in logs[1]
          and "Processing map" not in logs[1],
          "session: the second run did not load both caches")
    again = mad.solutions["bench_sub"]
    check(len(again) == len(first.solutions["bench_sub"]) and all(
        np.array_equal(a.structure.coords, b.structure.coords)
        for a, b in zip(again, first.solutions["bench_sub"])),
        "session: the cached run gave other solutions")
    host_io_checks(device, fit, work, sub_path, files, sols)
    return dict(root=root, map_path=map_path, sub_path=sub_path,
                sols=first.solutions["bench_sub"], map_dsc=first.map_dsc,
                sub_dsc=first.dsc_dict["bench_sub"])


def median_run(fn, reps=HOST_IO_REPS):
    """(median seconds of ``reps`` calls of ``fn``, its last result)."""
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        secs.append(time.perf_counter() - t0)
    return float(np.median(secs)), out


def same_structure(a, b):
    return (np.array_equal(a.coords, b.coords)
            and np.array_equal(a.masses, b.masses)
            and np.array_equal(a.ca_idx, b.ca_idx)
            and np.array_equal(a.bb_idx, b.bb_idx) and a.info == b.info)


def host_io_checks(device, fit, work, sub_path, files, sols):
    """Phase 7's host I/O, each a median of HOST_IO_REPS: parse_pdb of the
    bench subunit and of the session's sol_*.pdb files through the native
    parser beside the Python one (equal Structures), write_complex of the
    solutions and write_pdb of the subunit, and the bench map's MRC write
    and read."""
    import os
    import torch
    from mad_tpu_torch.core import structure as S
    from mad_tpu_torch.core.grid import read_map, write_mrc
    from mad_tpu_torch.native import get_fastio
    native = get_fastio()
    for what, paths in (("the bench subunit", [sub_path]),
                        (f"{len(files)} sol_*.pdb", files)):
        t_nat, a = median_run(
            lambda: [S._parse_pdb_native(p, native) for p in paths])
        t_py, b = median_run(lambda: [S._parse_pdb_python(p) for p in paths])
        check(all(same_structure(x, y) for x, y in zip(a, b)),
              f"parse_pdb of {what}: native and Python Structures differ")
        say(f"parse_pdb of {what} ({sum(x.n_atoms for x in a)} atoms): "
            f"native {t_nat * 1e3:.3f} ms, Python {t_py * 1e3:.3f} ms, "
            "equal Structures")
    cpath = os.path.join(work, "complex.pdb")
    t_cx, _ = median_run(lambda: S.write_complex(sols, cpath))
    t_pdb, _ = median_run(lambda: S.write_pdb(fit["copies"][0], os.path.join(
        work, "sub_again.pdb")))
    say(f"write_complex of {len(sols)} solutions "
        f"({sum(x.n_atoms for x in sols)} atoms): {t_cx * 1e3:.3f} ms; "
        f"write_pdb of the subunit: {t_pdb * 1e3:.3f} ms")
    mrc = os.path.join(work, "map_again.mrc")
    t_w, _ = median_run(lambda: write_mrc(fit["dmap"], mrc))

    def read():
        g = read_map(mrc, 0.0, device=device)
        torch.cuda.synchronize()
        return g
    t_r, g = median_run(read)
    check(same_bits(g.data, fit["dmap"].data),
          "MRC: the map read back differs")
    say(f"MRC of the bench map {fit['dmap'].shape}: write {t_w:.4f} s, "
        f"read_map(path, 0.0) {t_r:.4f} s, bit for bit")


# -- phase 8: heteromer ranking ---------------------------------------------

def hetero_phase(device):
    """enumerate_heteromer on hetero_problem(), its counters reset just
    before (K20 must launch: it stages the overlap itself); the same call
    with the plain versions swapped in must give the same tuples. Returns
    K20's launch count."""
    import torch
    from mad_tpu_torch.engine import assemble as asm
    from mad_tpu_torch.kernels import launch_counts, reset_launches
    ov, groups = hetero_problem()
    reset_launches()
    t0 = time.perf_counter()
    got = asm.enumerate_heteromer(groups, ov, device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    count = launch_counts()["hetero_head"]
    check(count >= 1, "K20 never launched in the heteromer ranking")
    with plain_versions(assembly_swaps()):
        t0 = time.perf_counter()
        ref = asm.enumerate_heteromer(groups, ov, device=device)
        torch.cuda.synchronize()
        dt_plain = time.perf_counter() - t0
    asm.pop_enum_notes()
    check(np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1]),
          "heteromer ranking: kernel and plain tuples differ")
    n_tuples = int(np.prod([len(g) for g in groups.values()]))
    say(f"heteromer ranking: {len(got[0])} of {n_tuples} tuples, {dt:.4f} "
        f"s with K20 ({count} launch), {dt_plain:.4f} s "
        f"with the plain version; best sum {got[1][0]:.6f}")
    return count


# -- phase 9: small reference ---------------------------------------------

def small_reference(device, cfg):
    import dataclasses
    from mad_tpu_torch.testing import assemble_solutions, overlap_tolerance
    small_cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                       max_anchors=1024))
    kw = dict(n_copies=SMALL["n_copies"], n_res=SMALL["n_res"],
              seed=SMALL["seed"], spread=SMALL["spread"], res=SMALL["res"],
              voxsp=SMALL["voxsp"], shell=False)
    card = run_fit(device, None, small_cfg, **kw)
    host = run_fit("cpu", None, small_cfg, **kw)
    rc = best_rmsds([s.structure for s in card["sols"]], card["copies"])
    rh = best_rmsds([s.structure for s in host["sols"]], host["copies"])
    say(f"small reference: card {len(card['sols'])} solutions, best "
        f"CA-RMSD {np.round(rc, 3).tolist()}; CPU {len(host['sols'])}, "
        f"{np.round(rh, 3).tolist()}")
    check(all(r < RECOVER_RMSD for r in rc) and all(r < RECOVER_RMSD
                                                    for r in rh),
          "small reference: a copy was not recovered")
    check(max(abs(a - b) for a, b in zip(rc, rh)) <= SMALL_POSE_TOL,
          "small reference: card and CPU poses differ")
    a = card["assembly"]
    check(a is not None and a["models"],
          "small reference: the card built no model")
    h = assemble_solutions(a["structures"], card["dmap"].to("cpu"),
                           small_cfg, SMALL["n_copies"], device="cpu")
    tol = np.maximum(
        overlap_tolerance(a["structures"], cfg.assembly, device),
        overlap_tolerance(a["structures"], cfg.assembly, "cpu"))
    e_ov, e_ccc = compare_assemblies(a, h, tol, "small reference assembly")
    say(f"small reference assembly: {len(a['models'])} model(s) "
        f"{[m.components for m in a['models']]}, card and CPU agree "
        f"(overlap max diff {e_ov:g}, CCC max diff {e_ccc:g})")


def stage_inputs(args, blocks=None):
    """K16's five stage calls at one round's inputs (``args``, post's
    first 17): {wrapper name: its arguments}, the lane, point and row
    stages on the (start, count) ``blocks`` of the lanes, points and rows
    (all of each by default), each stage's inputs from the plain versions
    of the stages before it."""
    from mad_tpu_torch.kernels import post as k16
    (rot_m, trans_m, coords_m, failed, cand_rot, cand_hi, cand_lo, x0,
     hi_cloud, lo_cloud, prev, idx, hit, dedup, lo_rows, ad, n_top) = args
    C, B, P = coords_m.shape[0], lo_cloud.shape[0], lo_rows.shape[0]
    lanes, points, rows = blocks or ((0, C), (0, B), (0, P))
    la = (rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo, x0, hi_cloud,
          lo_cloud, hit)
    da = (coords_m, failed, k16.post_lanes_plain(*la, 0, C)[2], prev, idx,
          dedup)
    pa = (lo_cloud, prev, coords_m, k16.post_dedup_plain(*da)[0], ad)
    ra = (lo_rows, lo_cloud, k16.post_points_plain(*pa, 0, B)) + pa[1:]
    flags = k16.post_rows_plain(*ra, 0, P)
    return dict(post_lanes=la + lanes, post_dedup=da,
                post_points=pa + points, post_rows=ra + rows,
                post_compact=(flags, n_top))


def post_stage_checks(args, n_acc, blocks=None):
    """K16's stage entries against their plain versions at one round's
    inputs (``args``, post's first 17; ``n_acc`` lanes accepted), the lane,
    point and row stages on the (start, count) ``blocks`` of the lanes,
    points and rows (all of each by default); returns {name: measure(...)}
    for post_lanes, post (the dedup), post_points, post_rows and
    post_compact."""
    import torch
    from mad_tpu_torch.kernels import post as k16
    (rot_m, trans_m, coords_m, failed, cand_rot, cand_hi, cand_lo, x0,
     hi_cloud, lo_cloud, prev, idx, hit, dedup, lo_rows, ad, n_top) = args
    C, N = coords_m.shape[:2]
    A, B, S = hi_cloud.shape[0], lo_cloud.shape[0], prev.shape[0]
    n_idx, P = idx.shape[0], lo_rows.shape[0]
    st = stage_inputs(args, blocks)
    la, da, pa, ra = (st[k] for k in ("post_lanes", "post_dedup",
                                      "post_points", "post_rows"))
    nl, npt, nr = la[-1], pa[-1], ra[-1]
    r0 = ra[-2]
    out = {}
    g, w = k16.post_lanes(*la), k16.post_lanes_plain(*la)
    check(torch.equal(g[1], w[1]) and torch.equal(g[2], w[2]),
          "K16 lanes: hits or counts differ from the plain version")
    err = float((g[0] - w[0]).abs().max()) if nl else 0.0
    check(err <= K16_ANCHOR_TOL, f"K16 lanes: anchors differ by {err:g} A")
    out["post_lanes"] = measure(
        err, lambda: k16.post_lanes(*la), lambda: k16.post_lanes_plain(*la),
        nl * (36 + 12 + 1 + 72 + 48) + N * 24 + (A + B) * 24
        + nl * A * 32 + nl * 8,
        nl * N * POSE_FLOPS + nl * A * (36 + B * DIST_FLOPS),
        peak_ops=PEAK_F64_S)
    out["post_lanes"]["kernel_ms"] = (
        alone_ms(lambda: k16.post_lanes(*la)) if nl else None)
    acc, slot = k16.post_dedup(*da)
    w = k16.post_dedup_plain(*da)
    check(torch.equal(acc, w[0]) and torch.equal(slot, w[1]),
          "K16 dedup differs from the plain version")
    out["post"] = measure(
        0.0, lambda: k16.post_dedup(*da), lambda: k16.post_dedup_plain(*da),
        C * N * 12 + S * N * 24 + C * 9 + n_idx * 8 + C * 16,
        C * (S + C) * n_idx * DIST_FLOPS, peak_ops=PEAK_F64_S)
    out["post"]["kernel_ms"] = alone_ms(lambda: k16.post_dedup(*da))
    if blocks is None:
        # The fold (one device): the two stages in one launch, its outputs
        # those of the lane and dedup entries bit for bit (the dedup on the
        # kernel's counts, equal to the plain ones), and the plain stages'
        # within K16_ANCHOR_TOL for the moved anchors. Work: the two's.
        fa = (rot_m, trans_m, coords_m, failed, cand_rot, cand_hi, cand_lo,
              x0, hi_cloud, lo_cloud, prev, idx, hit, dedup)
        g = k16.post_lanes_dedup(*fa)
        two = k16.post_lanes(*la[:-2], 0, C)
        two += k16.post_dedup(coords_m, failed, two[2], prev, idx, dedup)
        w = k16.post_lanes_dedup_plain(*fa)
        check(all(same_bits(x, y) for x, y in zip(g, two)),
              "K16 fold differs from the lane and dedup entries")
        check(all(torch.equal(x, y) for x, y in zip(g[1:], w[1:])),
              "K16 fold: hits, counts, accepted or slots differ from the "
              "plain stages")
        err = float((g[0] - w[0]).abs().max())
        check(err <= K16_ANCHOR_TOL, f"K16 fold: anchors differ by {err:g} A")
        lanes_r = out["post_lanes"]
        out["post_lanes_dedup"] = measure(
            err, lambda: k16.post_lanes_dedup(*fa),
            lambda: k16.post_lanes_dedup_plain(*fa),
            lanes_r["bytes"] + out["post"]["bytes"],
            lanes_r["ops"] + out["post"]["ops"], peak_ops=PEAK_F64_S)
        out["post_lanes_dedup"]["kernel_ms"] = alone_ms(
            lambda: k16.post_lanes_dedup(*fa))
        say(f"  K16 fold: {C} lanes' blocks and the dedup's in one "
            f"launch, equal to the two entries; "
            f"alone {out['post_lanes_dedup']['kernel_ms']:.4f} ms (lanes "
            f"{out['post_lanes']['kernel_ms']:.4f} + dedup "
            f"{out['post']['kernel_ms']:.4f}), wrapper "
            f"{out['post_lanes_dedup']['ms']:.4f} ms (the two "
            f"{out['post_lanes']['ms'] + out['post']['ms']:.4f})")
    g, w = k16.post_points(*pa), k16.post_points_plain(*pa)
    check(torch.equal(g, w), "K16 points differ from the plain version")
    out["post_points"] = measure(
        0.0, lambda: k16.post_points(*pa), lambda: k16.post_points_plain(*pa),
        npt * 25 + S * N * 24 + C * N * 12 + C * 8,
        npt * (S + n_acc) * N * DIST_FLOPS, peak_ops=PEAK_F64_S)
    out["post_points"]["kernel_ms"] = (
        alone_ms(lambda: k16.post_points(*pa)) if npt else None)
    g, w = k16.post_rows(*ra), k16.post_rows_plain(*ra)
    check(torch.equal(g, w), "K16 rows differ from the plain version")
    blk = lo_rows[r0:r0 + nr]
    on = int((blk[:, None] == lo_cloud[None]).all(dim=2).any(dim=1).sum())
    out["post_rows"] = measure(
        0.0, lambda: k16.post_rows(*ra), lambda: k16.post_rows_plain(*ra),
        nr * 25 + B * 25 + (nr - on) * (S + n_acc) * N * 12,
        nr * 3 * math.ceil(math.log2(B + 1))
        + (nr - on) * (S + n_acc) * N * DIST_FLOPS,
        peak_ops=PEAK_F64_S)
    out["post_rows"]["kernel_ms"] = (
        alone_ms(lambda: k16.post_rows(*ra)) if nr else None)
    flags = st["post_compact"][0]
    g = k16.post_compact(flags, n_top)
    check(torch.equal(g, k16.post_compact_plain(flags, n_top)),
          "K16 compaction differs from the plain version")
    out["post_compact"] = measure(
        0.0, lambda: k16.post_compact(flags, n_top),
        lambda: k16.post_compact_plain(flags, n_top), P + (1 + n_top) * 8, P,
        peak_ops=PEAK_F64_S)
    out["post_compact"]["kernel_ms"] = alone_ms(
        lambda: k16.post_compact(flags, n_top))
    return out


# -- phase 10: capacity mode ---------------------------------------------

@contextlib.contextmanager
def record_first(module, name, pick):
    """Keep the arguments of the first call of ``module.name`` in the block
    for which ``pick(args)`` holds (every call still runs)."""
    got, fn = [], getattr(module, name)

    def rec(*args, **kw):
        if not got and not kw and pick(args):
            got.append(args)
        return fn(*args, **kw)

    setattr(module, name, rec)
    try:
        yield got
    finally:
        setattr(module, name, fn)


def first_input(args):
    """A kernel wrapper's first input (log_gauss is handed its volume in a
    one-element list)."""
    return args[0][0] if isinstance(args[0], list) else args[0]


@contextlib.contextmanager
def slab_spy():
    """During a capacity-mode describe_grid, the rows of every field that a
    kernel of the octave chain reads (K1, K2, K3, K4, K5, K6, K7 at their
    call sites), each with its octave's bound: the largest slab's own rows
    plus twice the octave's largest halo (its build halo in octave rows,
    the orientation's and one more row for K3's input, the detection's),
    and the octave's rows."""
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.kernels import orient as k6
    from mad_tpu_torch.ops import convolve, describe, detect, scalespace
    from mad_tpu_torch.parallel import volume
    seen, bound = [], {}
    sites = [(convolve, "conv1d_along"), (convolve, "log_gauss"),
             (scalespace, "upsample2"),
             (volume, "gradient"), (detect, "peak_topk"),
             (detect, "localize"), (k6, "orient"),
             (describe, "descriptor_hist")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in sites]
    octave = pipeline._describe_octave

    def octave_spy(octv, cfg, mesh=None):
        stride = 2 if octv.upsampled else 1
        halo = max(octv.build_halo() * stride,
                   pipeline.grad_halo(cfg, octv.upsampled) + 1,
                   2 + cfg.detect.newton_iters)
        bound.update(rows=int(max(np.diff(octv.bounds))) + 2 * halo,
                     full=octv.real_shape[0])
        return octave(octv, cfg, mesh)

    for mod, name, fn in saved:
        def spy(*args, _fn=fn, _name=name, **kw):
            seen.append((_name, int(first_input(args).shape[0]),
                         dict(bound)))
            return _fn(*args, **kw)
        setattr(mod, name, spy)
    pipeline._describe_octave = octave_spy
    try:
        yield seen
    finally:
        pipeline._describe_octave = octave
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def median_seconds(fn, reps=3):
    """Median host seconds of fn() ending in a synchronize, and its result."""
    import torch
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def same_set(a, b):
    import torch
    return (a.n == b.n and torch.equal(a.desc, b.desc)
            and torch.equal(a.desc_norm, b.desc_norm)
            and all(np.array_equal(getattr(a, k), getattr(b, k))
                    for k in SET_FIELDS))


def capacity_phase(device, cfg, dmap):
    """describe_grid of the bench map in capacity mode on 4 and on 3
    shards of the one card: the single-device DescriptorSet bit for bit,
    no field a kernel reads over its slab's rows plus twice its halo, K1-K7
    launched; seconds (median of 3) beside the single-device run's, and the
    phase's peak memory. Then each shard body's kernels at one shard's
    inputs against their plain versions (shard_checks). Returns the report
    rows of CAPACITY_ROWS."""
    import torch
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.kernels import launch_counts, reset_launches
    from mad_tpu_torch.parallel.mesh import make_mesh
    describe = lambda mesh=None: pipeline.describe_grid(
        dmap, cfg, name="bench_map",
        device=device if mesh is None else None, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    t_one, ref = median_seconds(describe)
    peak_one = torch.cuda.max_memory_allocated()
    counts = None
    for n in CAPACITY_SHARDS:
        mesh = make_mesh(n, devices=[device] * n)
        reset_launches()
        with slab_spy() as seen:
            got = describe(mesh)
            torch.cuda.synchronize()
        launches = launch_counts()
        counts = counts or launches
        check(same_set(got, ref), f"capacity mode on {n} shards: the "
              "DescriptorSet differs from the single-device one")
        over = [x for x in seen if not x[1] <= x[2]["rows"] < x[2]["full"]]
        check(not over, f"capacity mode on {n} shards: fields over their "
              f"slab's rows plus twice the halo: {over[:4]}")
        idle = [k for k in CAPACITY_KERNELS if launches[k] == 0]
        check(not idle, f"capacity mode on {n} shards: {idle} never launched")
        torch.cuda.reset_peak_memory_stats()
        t_mesh, got = median_seconds(lambda: describe(mesh))
        peak = torch.cuda.max_memory_allocated()
        check(same_set(got, ref), f"capacity mode on {n} shards: a timed "
              "run differs")
        worst = max(seen, key=lambda x: x[1] / x[2]["rows"])
        say(f"capacity mode, {n} shards on {device}: describe_grid "
            f"{t_mesh:.4f} s median of 3 (single device {t_one:.4f} s), "
            f"peak {peak / 2**30:.3f} GiB (single device "
            f"{peak_one / 2**30:.3f} GiB); {got.n} rows, the same "
            f"DescriptorSet; {len(seen)} kernel inputs, the largest share "
            f"of its bound {worst[0]} {worst[1]} of {worst[2]['rows']} rows "
            f"(octave {worst[2]['full']}); launches " + ", ".join(
                f"{k} {launches[k]}" for k in CAPACITY_KERNELS))
    rows = shard_checks(device, cfg, dmap)
    for name, (kernels, _src, _rep) in CAPACITY_ROWS.items():
        rows[name]["launches"] = sum(counts[k] for k in kernels)
        say_measure(name, rows[name])
    return rows


def shard_checks(device, cfg, dmap):
    """The capacity bodies' kernels at shard 1's inputs on the upsampled
    octave (4 shards), recorded during one describe_grid, against their
    plain versions and timed: the octave build (K2, K1, the LoG epilogue,
    K3) on the shard's halo block, equal; K4 and K5's offset forms, equal;
    K6's (the anchors agreeing as in orient_check); K7's (rows as in
    kernel_checks)."""
    import torch
    from mad_tpu_torch.engine import pipeline
    from mad_tpu_torch.kernels import conv1d, describe as k7, gradient as k3
    from mad_tpu_torch.kernels import localize as k5, orient as k6
    from mad_tpu_torch.kernels import peaks as k4, upsample as k2
    from mad_tpu_torch.ops import convolve, describe, detect, scalespace
    from mad_tpu_torch.ops.scalespace import iter_octaves, octave_volume
    from mad_tpu_torch.parallel.mesh import make_mesh
    from mad_tpu_torch.parallel.volume import halo_block
    from mad_tpu_torch.testing import orient_agreement
    out = {}
    mesh = make_mesh(4, devices=[device] * 4)
    offset = lambda i: lambda a: len(a) > i and a[i] > 0
    with record_first(detect, "peak_topk", offset(7)) as c4, \
            record_first(detect, "localize", offset(5)) as c5, \
            record_first(k6, "orient", offset(11)) as c6, \
            record_first(describe, "descriptor_hist", offset(11)) as c7:
        pipeline.describe_grid(dmap, cfg, name="bench_map", mesh=mesh)
        torch.cuda.synchronize()

    # The octave build on shard 1's block. Bytes: the function's own, the
    # block read once, the LoG and the gradient field written once (the
    # launches' own inputs and outputs, the unfused chain's traffic, are
    # printed beside); operations: 2 flops a nonzero tap of each K1
    # convolution (nine in the fused LoG), 7 a half sample of K2, 6 a
    # voxel of K3.
    octv = next(o for _org, o in iter_octaves(dmap, cfg.scalespace, mesh)
                if o.upsampled)
    c = cfg.scalespace
    blk, _lo = halo_block(octv.base, 1, octv.build_halo(), mesh)
    work = dict(bytes=0, ops=0)

    def build(grad=k3.gradient):
        log, gauss = convolve.log_filter3d(octave_volume(blk, True, c),
                                           c.detect_sigma, c.truncate)
        return log, grad(gauss, torch.float32)

    def plain_build():
        with plain_versions([(convolve, "conv1d_along",
                              conv1d.conv1d_along_plain),
                             (convolve, "log_gauss", conv1d.log_gauss_plain),
                             (scalespace, "upsample2",
                              k2.upsample2_plain)]):
            return build(k3.gradient_plain)

    def counted(fn, name):
        def run(*args, **kw):
            n_in = first_input(args).numel()
            res = fn(*args, **kw)
            outs = res if isinstance(res, tuple) else (res,)
            n_out = outs[0].numel()
            work["bytes"] += 4 * n_in + sum(r.element_size() * r.numel()
                                            for r in outs)
            nnz = lambda k: int(np.count_nonzero(k))
            if name == "conv1d_along":
                work["ops"] += 2 * nnz(args[1]) * n_out
            elif name == "log_gauss":
                work["ops"] += 2 * (6 * nnz(args[1]) + 3 * nnz(args[2])) \
                    * n_in
            elif name == "upsample2":
                work["ops"] += upsample_ops(first_input(args).shape)
            else:
                work["ops"] += 6 * n_in
            return res
        return run

    with plain_versions([(mod, n, counted(getattr(mod, n), n))
                         for mod, n in ((convolve, "conv1d_along"),
                                        (convolve, "log_gauss"),
                                        (scalespace, "upsample2"))]):
        got = build(counted(k3.gradient, "gradient"))
    ref = plain_build()
    check(all(torch.equal(x, y) for x, y in zip(got, ref)),
          "the shard's octave build differs from the plain versions")
    own_bytes = 4 * blk.numel() + sum(x.numel() * x.element_size()
                                      for x in got)
    out["sharded_scalespace"] = measure(0.0, build, plain_build, own_bytes,
                                        work["ops"])
    say(f"  sharded_scalespace: shard 1's block {tuple(blk.shape)} -> "
        f"{tuple(got[0].shape)} octave rows (LoG, gradient field), equal "
        f"to the plain versions; bytes in and out {own_bytes:.4g} B, the "
        f"launches' own {work['bytes']:.4g} B (bound "
        f"{work['bytes'] / PEAK_BYTES_S * 1e3:.4f} ms unfused)")
    del got, ref, blk

    # detect_shard: K4 and K5's offset forms, equal. Work as in
    # kernel_checks (K4: the block read, 27 compares an own voxel, the
    # peaks written) and describe_checks (K5: newton_work).
    check(c4 and c5 and c6 and c7, "an offset form was not recorded")
    a4, a5 = c4[0], c5[0]
    v1, i1 = k4.peak_topk(*a4)
    v2, i2 = k4.peak_topk_plain(*a4)
    check(torch.equal(v1, v2) and torch.equal(i1, i2),
          "K4's offset form differs from the plain version")
    got, ref = k5.localize(*a5), k5.localize_plain(*a5)
    check(all(torch.equal(x, y) for x, y in zip(got, ref)),
          "K5's offset form differs from the plain version")
    own = a4[6] * a4[0].shape[1] * a4[0].shape[2]
    r4 = measure(0.0, lambda: k4.peak_topk(*a4),
                 lambda: k4.peak_topk_plain(*a4),
                 4 * a4[0].numel() + 12 * len(v1), 27 * own)
    K = a5[1].shape[0]
    steps, voxels, _most = newton_work(*a5)
    r5 = measure(0.0, lambda: k5.localize(*a5),
                 lambda: k5.localize_plain(*a5),
                 4 * voxels + K * (24 + 24 + 12 + 1),
                 steps * NEWTON_FLOPS + K * SADDLE_FLOPS)
    out["detect_shard"] = dict(
        max_abs_err=0.0, library_ms=None, ms=r4["ms"] + r5["ms"],
        plain_ms=r4["plain_ms"] + r5["plain_ms"],
        **bound(r4["bytes"] + r5["bytes"], r4["ops"] + r5["ops"]))
    say(f"  detect_shard: K4 on a block of {tuple(a4[0].shape)} (own rows "
        f"{a4[5]}-{a4[5] + a4[6]}, x0 {a4[7]}), {len(v1)} peaks; K5 on "
        f"{K} seeds (goff {a5[5]}); both equal; K4 {r4['ms']:.4f} ms, K5 "
        f"{r5['ms']:.4f} ms")

    # orient_shard: K6's offset form, the anchors agreeing as in
    # orient_check; work as orient_work counts it.
    a6 = c6[0]
    got = k6.orient(*a6)
    share, dmax, close = orient_agreement(got, k6.orient_plain(*a6),
                                          K6_RFINAL_TOL)
    check(share >= K6_AGREE and close, f"K6's offset form agrees on "
          f"{share:.5f} of the anchors, frames within {dmax:g}")
    nbytes, ops = orient_work(a6, got)
    out["orient_shard"] = measure(dmax, lambda: k6.orient(*a6),
                                  lambda: k6.orient_plain(*a6), nbytes, ops)
    say(f"  orient_shard: K6 on {a6[1].shape[0]} anchors, block "
        f"{tuple(a6[0].shape[:3])} (goff {a6[11]}), "
        f"{int(got[3].sum())} lanes; agreeing {share:.5f}, frames max diff "
        f"{dmax:g}")

    # describe_shard: K7's offset form, rows as in kernel_checks; work as
    # there.
    a7 = c7[0]
    d1, ok1 = k7.descriptor_hist(*a7)
    d2, ok2 = k7.descriptor_hist_plain(*a7)
    diff = (d1.long() - d2.long()).abs()
    same = float((diff.sum(dim=1) == 0).float().mean())
    check(torch.equal(ok1, ok2) and same >= 0.99
          and int(diff.sum(dim=1).max()) <= 8,
          f"K7's offset form: rows equal {same:.4f}")
    L, P, nz = len(ok1), len(a7[5]), len(a7[7])
    out["describe_shard"] = measure(
        float(diff.max()), lambda: k7.descriptor_hist(*a7),
        lambda: k7.descriptor_hist_plain(*a7),
        L * P * 12 + L * (12 + 36 + 1) + d1.numel() * 2 + L,
        L * P * (15 + 8 + 15 + 40 + 6 * nz))
    say(f"  describe_shard: K7 on {L} lanes, block {tuple(a7[0].shape[:3])} "
        f"(goff {a7[11]}); rows equal {same:.5f}")
    return out


# -- phase 11: the dock on a mesh -------------------------------------------

def solution_diff(a, b):
    """The first difference between two solution lists, bit for bit in
    coords, weight, repeat, CCC and matched anchors ("" when none)."""
    if len(a) != len(b):
        return f"{len(a)} against {len(b)} solutions"
    for i, (x, y) in enumerate(zip(a, b)):
        dx = np.abs(x.structure.coords - y.structure.coords).max()
        if dx != 0:
            return f"solution {i}: coords differ by {dx:g}"
        for k in ("weight", "repeat", "ccc"):
            if getattr(x, k) != getattr(y, k):
                return (f"solution {i}: {k} {getattr(x, k)!r} against "
                        f"{getattr(y, k)!r}")
        if not np.array_equal(x.corresp_anchors, y.corresp_anchors):
            return f"solution {i}: the matched anchors differ"
    return ""


def same_solutions(a, b):
    """Bit for bit: coords, weight, repeat, CCC and matched anchors."""
    return not solution_diff(a, b)


def dock_mesh_phase(device, cfg, bench, session):
    """dock_structure on the bench fit's single-device DescriptorSets on a
    mesh of 4 and of 3 shards that share the card, the launch counters
    reset just before the first run of each: the single-device solutions
    bit for bit, every kernel of DOCK_KERNELS launched; seconds (median of
    3) and peak memory beside the single-device dock's. Then the rescue
    case (rescue_phase), the shard bodies at shard 1's inputs
    (dock_shard_checks), MaD(mesh=) on the session's inputs (phase 7's
    solutions) and multichip_step(4). Returns the report rows of
    DOCK_ROWS and of the merge entry (pair_merge), and the launches of the
    4-shard run."""
    import torch
    from mad_tpu_torch.engine.docking import dock_structure
    from mad_tpu_torch.kernels import launch_counts, reset_launches
    from mad_tpu_torch.parallel.mesh import make_mesh
    from mad_tpu_torch.parallel.step import multichip_step
    dock = lambda mesh=None: dock_structure(
        bench["map_set"], bench["sub_set"], bench["moved"], bench["dmap"],
        RES, cfg, verbose=False,
        n_copies=N_COPIES, device=device if mesh is None else None,
        mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    t_one, ref = median_seconds(dock)
    peak_one = torch.cuda.max_memory_allocated()
    counts = None
    for n in DOCK_SHARDS:
        mesh = make_mesh(n, devices=[device] * n)
        reset_launches()
        got = dock(mesh)
        torch.cuda.synchronize()
        launches = launch_counts()
        counts = counts or launches
        diff = solution_diff(got, ref)
        check(not diff, f"dock on {n} shards: the solutions differ from the "
              f"single-device ones: {diff}")
        idle = [k for k in DOCK_KERNELS if launches[k] == 0]
        check(not idle, f"dock on {n} shards: {idle} never launched")
        torch.cuda.reset_peak_memory_stats()
        t_mesh, got = median_seconds(lambda: dock(mesh))
        peak = torch.cuda.max_memory_allocated()
        check(same_solutions(got, ref), f"dock on {n} shards: a timed run "
              "differs")
        say(f"dock on a mesh, {n} shards on {device}: dock_structure "
            f"{t_mesh:.4f} s median of 3 (single device {t_one:.4f} s), "
            f"peak {peak / 2**30:.3f} GiB (single device "
            f"{peak_one / 2**30:.3f} GiB); {len(got)} solutions, the same "
            "bit for bit; launches " + ", ".join(
                f"{k} {launches[k]}" for k in DOCK_KERNELS))
    rescue_phase(device, cfg)
    rows = dock_shard_checks(device, cfg, bench)
    for name, (kernels, _src, _rep) in DOCK_ROWS.items():
        rows[name]["launches"] = sum(counts[k] for k in kernels)
        say_measure(name, rows[name])
    say_measure("pair_merge", rows["pair_merge"])
    mesh_session(device, cfg, session)
    t0 = time.perf_counter()
    n_sols = multichip_step(4, devices=[device] * 4)
    torch.cuda.synchronize()
    check(n_sols >= 1, "multichip_step(4) found no solution")
    say(f"multichip_step(4) on {device}: {n_sols} solutions, "
        f"{time.perf_counter() - t0:.3f} s")
    return rows, counts


def rescue_args(device, cfg):
    """The SMALL dimer with RESCUE's settings, described once on the card:
    dock_structure's positional arguments (call it with n_copies=
    RESCUE["n_copies"]) and the copies."""
    import dataclasses
    from mad_tpu_torch.engine.pipeline import (describe_grid,
                                               describe_structure)
    from mad_tpu_torch.ops.simulate import simulate_density
    from mad_tpu_torch.testing import decoy_transform, make_assembly
    rc = cfg.replace(
        detect=dataclasses.replace(cfg.detect, max_anchors=1024),
        filter=dataclasses.replace(cfg.filter,
                                   n_samples=RESCUE["n_samples"]))
    sub, copies = make_assembly(n_copies=SMALL["n_copies"],
                                n_res=SMALL["n_res"], seed=SMALL["seed"],
                                spread=SMALL["spread"])
    dmap = simulate_density(
        np.concatenate([c.coords for c in copies]), SMALL["res"],
        SMALL["voxsp"], device=device,
        masses=np.concatenate([c.masses for c in copies])).reduce_void()
    moved = decoy_transform(sub)
    m = describe_grid(dmap, rc, name="map", device=device)
    s = describe_structure(moved, SMALL["res"], dmap.voxsp, rc, name="sub",
                           device=device)
    return (m, s, moved, dmap, SMALL["res"], rc), copies


def rescue_phase(device, cfg):
    """The rescue case (rescue_args): on 4 and 3 shards the single-device
    solutions bit for bit, with the rescue round's exact re-score (K13)
    and clustering on the mesh and K16's row stage launched."""
    import torch
    from mad_tpu_torch.engine import docking
    from mad_tpu_torch.kernels import launch_counts, reset_launches
    from mad_tpu_torch.parallel.mesh import make_mesh
    from mad_tpu_torch.testing import recording
    args, copies = rescue_args(device, cfg)
    ref = docking.dock_structure(*args, verbose=False,
                                 n_copies=RESCUE["n_copies"],
                                 device=device)
    for n in DOCK_SHARDS:
        mesh = make_mesh(n, devices=[device] * n)
        reset_launches()
        with recording(docking, "exact_rescore") as rescue, \
                recording(docking, "cluster_select") as rounds:
            got = docking.dock_structure(*args, verbose=False,
                                         n_copies=RESCUE["n_copies"],
                                         mesh=mesh)
        torch.cuda.synchronize()
        launches = launch_counts()
        check(len(rescue) == 1 and rescue[0][4] is mesh and len(rounds) == 2,
              f"rescue case on {n} shards: the rescue round did not "
              f"cluster on the mesh ({len(rescue)} re-scores, {len(rounds)} "
              "clusterings)")
        check(launches["exact_repeat"] > n and launches["post_rows"] > 0,
              f"rescue case on {n} shards: K13 {launches['exact_repeat']}, "
              f"K16 rows {launches['post_rows']} launches")
        diff = solution_diff(got, ref)
        check(not diff, f"rescue case on {n} shards: the solutions differ "
              f"from the single-device ones: {diff}")
        found = best_rmsds([x.structure for x in got], copies)
        say(f"rescue case, {n} shards: {len(got)} solutions (weights "
            f"{[x.weight for x in got]}, best CA-RMSD per copy "
            f"{np.round(found, 3).tolist()}), the same bit for bit; the "
            f"rescue round re-scored {len(rescue[0][1])} rows on the mesh "
            f"and clustered; launches K13 {launches['exact_repeat']}, K16 "
            f"rows {launches['post_rows']}, K14 {launches['cluster_select']}")


def dock_shard_checks(device, cfg, bench):
    """The shard bodies at shard 1's inputs of a 4-shard bench dock,
    recorded at their call sites, against their plain versions and timed:
    D1 K10's head on the shard's rows and the merge of the four heads
    (equal keys; the merge also as its own row, pair_merge, beside
    torch.sort of the keys); D2 K12 on its pairs and K13 on its exactly
    scored rows (equal except pairs on a .5 edge or at the 4 A radius);
    D3 K16's lane, point and row stages on its blocks of the first round
    (post_stage_checks' gates); D4 K15 on its candidates (refine_check's
    gates)."""
    import torch
    from mad_tpu_torch.engine import match as em
    from mad_tpu_torch.engine.docking import dock_structure
    from mad_tpu_torch.kernels import approx, post as k16, refine as k15
    from mad_tpu_torch.kernels import pairs, repeat
    from mad_tpu_torch.parallel.mesh import make_mesh
    from mad_tpu_torch.testing import ca_rmsds, recording
    out = {}
    mesh = make_mesh(4, devices=[device] * 4)
    with recording(em, "pair_head") as heads, \
            recording(em, "pair_merge") as merges, \
            recording(em, "approx_repeat") as c12, \
            recording(em, "exact_repeat") as c13, \
            recording(k15, "refine_loop") as c15, \
            recording(k16, "post_lanes") as lanes, \
            recording(k16, "post_points") as points, \
            recording(k16, "post_rows") as rows, \
            recording(k16, "post_dedup") as dedups:
        dock_structure(bench["map_set"], bench["sub_set"], bench["moved"],
                       bench["dmap"], RES, cfg, verbose=False,
                       n_copies=N_COPIES, mesh=mesh)
        torch.cuda.synchronize()

    # D1: equal keys. Bytes: the shard's cosines read, its head written,
    # the heads read and the global head written; operations: a compare a
    # cosine and a key. Library: torch.topk per row then flat on the
    # shard's cosines, and torch.sort of the heads.
    a, mg = heads[1], merges[0]
    check(torch.equal(pairs.pair_head(*a), pairs.pair_head_plain(*a)),
          "D1: K10's head on shard 1 differs from the plain version")
    g = pairs.pair_merge(*mg)
    check(torch.equal(g, pairs.pair_merge_plain(*mg)),
          "D1: the merge differs from the plain version")
    sim, keys, L = a[0], mg[0], mg[1]
    k = min(a[1], sim.shape[1])
    L1 = pairs.head_length(sim.shape[0], sim.shape[1], a[1], a[2])
    flip = -(1 << 63)

    def topk_head():
        vals, _ = torch.topk(sim, k, dim=1)
        return torch.topk(vals.reshape(-1), L1)

    sort = lambda: torch.sort(keys ^ flip)
    out["match_pairs_shard"] = measure(
        0.0, lambda: (pairs.pair_head(*a), pairs.pair_merge(*mg)),
        lambda: (pairs.pair_head_plain(*a), pairs.pair_merge_plain(*mg)),
        sim.numel() * 4 + L1 * 8 + keys.numel() * 8 + L * 8,
        sim.numel() + keys.numel(), lambda: (topk_head(), sort()))
    out["pair_merge"] = measure(
        0.0, lambda: pairs.pair_merge(*mg),
        lambda: pairs.pair_merge_plain(*mg), keys.numel() * 8 + L * 8,
        keys.numel(), sort)
    say(f"  match_pairs_shard: K10's head on rows {a[4]}-"
        f"{a[4] + sim.shape[0]} of {a[5]} x {sim.shape[1]} (head {L1}), "
        f"the merge of {len(heads)} heads ({keys.numel()} keys) into "
        f"{L}; equal")

    # D2: K12 and K13 on shard 1's blocks. Work as in match_kernel_checks
    # and kernel_checks.
    a12, a13 = c12[1], c13[1]
    r1, r2 = approx.approx_repeat(*a12), approx.approx_repeat_plain(*a12)
    e12 = approx_edges(*a12)
    edge, touched = e12["edge"], e12["touched"]
    check(torch.equal(r1, r2), "D2: K12 on shard 1 differs from the plain "
          "version")
    e1, e2 = repeat.exact_repeat(*a13), repeat.exact_repeat_plain(*a13)
    near = _near_radius(*a13)
    check(not bool(((e1 != e2) & ~near).any()),
          "D2: K13 on shard 1 differs off the radius")
    P, a_hi, a_lo = a12[6].shape[0], a12[3].shape[0], a13[1].shape[0]
    n13 = a13[2].shape[0]
    out["repeat_shard"] = measure(
        max(float((r1 - r2).abs().max()), float((e1 - e2).abs().max())),
        lambda: (approx.approx_repeat(*a12), repeat.exact_repeat(*a13)),
        lambda: (approx.approx_repeat_plain(*a12),
                 repeat.exact_repeat_plain(*a13)),
        touched + a_hi * 12 + a12[1].shape[0] * 12 + 12 + P * (36 + 24 + 4)
        + (a_hi + a_lo) * 12 + n13 * (36 + 24 + 4),
        P * a_hi * APPROX_FLOPS + n13 * a_hi * (15 + 9 * a_lo))
    say(f"  repeat_shard: K12 on {P} pairs ({int(edge.sum())} on a .5 "
        f"edge; {e12['gathers']} field reads), K13 on {n13} rows "
        f"({int(near.sum())} at the radius); K12 alone "
        f"{alone_ms(lambda: approx.approx_repeat(*a12)):.4f} ms")

    # D3: K16's lane, point and row stages on shard 1's blocks of the
    # first round.
    la, pa, ra, da = lanes[1], points[1], rows[1], dedups[0]
    C = la[0].shape[0]
    stage_args = (la[0], la[1], da[0], la[2], la[3], la[4], la[5], la[6],
                  la[7], la[8], da[3], da[4], la[9], da[5], ra[0], pa[4],
                  cfg.filter.n_samples * N_COPIES)
    st = post_stage_checks(stage_args, int((pa[3] != 0).sum()),
                           ((la[10], la[11]), (pa[5], pa[6]),
                            (ra[7], ra[8])))
    parts = [st[k] for k in ("post_lanes", "post_points", "post_rows")]
    out["dock_post_shard"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in parts),
        ms=sum(r["ms"] for r in parts),
        plain_ms=sum(r["plain_ms"] for r in parts), library_ms=None,
        **bound(sum(r["bytes"] for r in parts),
                sum(r["ops"] for r in parts), PEAK_F64_S))
    say(f"  dock_post_shard: K16 lanes {la[10]}-{la[10] + la[11]} of {C}, "
        f"points {pa[5]}-{pa[5] + pa[6]} of {pa[0].shape[0]}, rows "
        f"{ra[7]}-{ra[7] + ra[8]} of {ra[0].shape[0]}; equal (ms "
        + ", ".join(f"{k} {st[k]['ms']:.4f}" for k in
                    ("post_lanes", "post_points", "post_rows")) + ")")

    # D4: K15 on shard 1's candidates, refine_check's gates and work.
    a15 = c15[1]
    got, ref = k15.refine_loop(*a15), k15.refine_loop_plain(*a15)
    failed = ref[5].cpu().numpy()
    check(np.array_equal(got[5].cpu().numpy(), failed),
          "D4: K15 failed flags differ")
    d = ca_rmsds(got[2].cpu().numpy(), ref[2].cpu().numpy(),
                 bench["moved"].ca_idx)[~failed]
    check(len(d) and d.max() <= SMALL_POSE_TOL
          and np.median(d) <= K15_MEDIAN,
          f"D4: K15 final CA-RMSD to plain: max {d.max():g}")
    Cs, N = a15[1].shape[:2]
    steps = got[4].cpu().numpy()
    touched = field_voxels(a15[1], got[2], a15[4], bench["dmap"].shape)
    out["refine_shard"] = measure(
        float((got[2] - ref[2]).abs().max()),
        lambda: k15.refine_loop(*a15), lambda: k15.refine_loop_plain(*a15),
        touched * 12 + Cs * N * 12 * 2 + Cs * (12 + 4 + 36 + 12 + 6) + 28,
        int(steps.sum()) * N * REFINE_FLOPS)
    say(f"  refine_shard: K15 on {Cs} candidates (steps {int(steps.sum())}"
        f"); CA-RMSD to plain max {d.max():.4f} A")
    return out


def mesh_session(device, cfg, session):
    """MaD(mesh=make_mesh(2, devices=[device] * 2)) through run on the
    session phase's inputs, in a fresh workdir: the map and the subunit
    (its density simulated afresh by K9, which gives the same grid in
    every run) described in capacity mode equal to phase 7's
    DescriptorSets, and phase 7's solutions bit for bit."""
    import contextlib
    import io
    import os
    import torch
    from mad_tpu_torch.api import MaD
    from mad_tpu_torch.kernels import launch_counts, reset_launches
    from mad_tpu_torch.parallel.mesh import make_mesh
    work = os.path.join(session["root"], "mesh")
    os.makedirs(work)
    mesh = make_mesh(2, devices=[device] * 2)
    reset_launches()
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        mad = MaD(workdir=work, config=cfg, mesh=mesh)
        mad.add_map(session["map_path"], resolution=RES)
        mad.add_subunit(session["sub_path"], n_copies=N_COPIES)
        mad.run(transform_subunits=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    got = mad.solutions["bench_sub"]
    for name, x, y in (("map", mad.map_dsc, session["map_dsc"]),
                       ("subunit", mad.dsc_dict["bench_sub"],
                        session["sub_dsc"])):
        check(same_set(x, y), f"MaD(mesh=): the {name}'s DescriptorSet "
              "differs from the session phase's")
    diff = solution_diff(got, session["sols"])
    check(not diff, "MaD(mesh=) gave other solutions than the session "
          f"phase: {diff}")
    idle = [k for k in DOCK_KERNELS + CAPACITY_KERNELS if counts[k] == 0]
    check(not idle, f"MaD(mesh=): {idle} never launched")
    check("Processing map" in log.getvalue()
          and "Processing subunit bench_sub" in log.getvalue(),
          "MaD(mesh=): the map or the subunit was not described")
    say(f"MaD(mesh=2 shards on {device}): run {dt:.3f} s, the map and the "
        f"subunit described afresh, their DescriptorSets and {len(got)} "
        "solutions phase 7's bit for bit")


# -- main -----------------------------------------------------------------


# -- phase 12: the public surface and the regimes ---------------------------

# mad_tpu/__init__.py's __all__ (the card's machine has no JAX to read it)
MAD_TPU_ALL = [
    "MaD", "MadConfig", "DensityGrid", "Structure", "DescriptorSet",
    "Solution", "read_map", "write_mrc", "write_sit", "parse_pdb",
    "write_pdb", "describe_grid", "describe_structure", "dock_structure",
    "simulate_density"]
SIT_TOL = 6e-7          # "%6.6f" rounds to 5e-7, then float32
FORWARD_KERNELS = ("log_gauss", "gradient", "peak_mask_compact", "localize",
                   "orient", "descriptor_hist")
NAN_MAP = dict(n=48, voxel=(20, 20, 20), seed=0, voxsp=2.0)
NAN_STAGES = r"detect\[o0\].*scalespace\.grad"
# the stages the port names on the CPU and mad_tpu names there
# (tests/test_torch_regimes_slow.py)
NAN_STAGE_LIST = "detect[o0], scalespace.grad[o0], scalespace.grad[o1]"
# PARITY.md section 10's recovered copies of 3 (mad_tpu) for each rung
LADDER_PARITY = {"noise_2pct": 3, "noise_5pct": 3, "noise_10pct": 3,
                 "noise_15pct": 3, "noise_20pct": 3,
                 "bfactor_blur_1vox": 3, "bfactor_blur_2vox": 3,
                 "bfactor_blur_3vox": 3, "bfactor_blur_4vox": 1,
                 "aniso_z_1.5vox": 3, "aniso_z_3vox": 3,
                 "aniso_z_4.5vox": 2}


@contextlib.contextmanager
def env(name, value):
    """``os.environ[name]`` set to ``value`` (None: unset) in the block."""
    import os
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def surface_phase(device, cfg, bench, root):
    """Phase 12 (the module docstring); returns its seconds."""
    import os
    t_phase = time.perf_counter()
    work = os.path.join(root, "surface")
    os.makedirs(work)
    surface_checks(device, cfg, bench, work)
    sanitizer_checks(device, cfg)
    profiling_check(device, cfg)
    regime_checks(device)
    return time.perf_counter() - t_phase


def surface_checks(device, cfg, bench, work):
    """Exports, map files, grid scoring, build_scale_space, forward and
    functional on the bench fit's map."""
    import dataclasses
    import inspect
    import os
    import torch
    import mad_tpu_torch as M
    from mad_tpu_torch import functional
    from mad_tpu_torch.core.grid import (ccc_maps_scaled, overlap_fraction,
                                         write_sit)
    from mad_tpu_torch.core.structure import write_pdb
    from mad_tpu_torch.engine.forward import build_forward
    from mad_tpu_torch.kernels import launch_counts, reset_launches
    from mad_tpu_torch.ops.scalespace import (build_scale_space,
                                              iter_octaves, prepare)
    from mad_tpu_torch.kernels.gradient import gradient
    from mad_tpu_torch.native import FastIO
    from mad_tpu_torch.testing import recording

    check(M.__all__ == MAD_TPU_ALL, f"__all__ is {M.__all__}")
    for fn in (M.read_map, M.simulate_density, M.describe_grid,
               M.describe_structure, M.dock_structure, M.MaD.__init__):
        p = inspect.signature(fn).parameters["device"]
        check(p.kind == p.KEYWORD_ONLY and p.default is None,
              f"{fn.__qualname__}: device is not keyword-only")
    say(f"exports: mad_tpu_torch.__all__ is mad_tpu's {len(M.__all__)} "
        f"names, version {M.__version__}; device keyword-only")

    # mad_tpu's positional calls, on the card by default: the fit's map and
    # the subunit's rows again, bit for bit
    dmap = bench["dmap"]
    coords = np.concatenate([c.coords for c in bench["copies"]])
    masses = np.concatenate([c.masses for c in bench["copies"]])
    again = M.simulate_density(coords, RES, VOXSP, 0.0, 0,
                               masses).reduce_void()
    sub_set = M.describe_structure(bench["moved"], RES, dmap.voxsp, cfg,
                                   0.0, "bench_sub")
    check(again.device.type == "cuda" and same_bits(again.data, dmap.data)
          and sub_set.desc.device.type == "cuda"
          and same_bits(sub_set.desc, bench["sub_set"].desc),
          "simulate_density / describe_structure with mad_tpu's positions "
          "and the default device differ from the fit's")
    say("simulate_density(c, r, v, 0.0, 0, masses) and describe_structure("
        "s, r, v, cfg, 0.0, name) on the default device: the fit's map and "
        "subunit rows bit for bit")
    del again, sub_set
    t0 = time.perf_counter()
    paths = {ext: os.path.join(work, f"bench_map{ext}")
             for ext in (".mrc", ".sit")}
    M.write_mrc(dmap, paths[".mrc"])
    t_mrc = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_sit(dmap, paths[".sit"])
    t_sit = time.perf_counter() - t0
    for ext, path in paths.items():
        with recording(FastIO, "parse_floats") as floats:
            t0 = time.perf_counter()
            g = M.read_map(path, 0.0)
            t_read = time.perf_counter() - t0
        check(len(floats) == (ext == ".sit"),
              f"read_map({ext}): {len(floats)} native float parses")
        check(g.device.type == "cuda", f"read_map({ext}) on {g.device}")
        check(g.shape == dmap.shape and np.allclose(g.origin, dmap.origin,
                                                    atol=1e-6),
              f"read_map({ext}): {g.shape}, origin {g.origin}")
        err = float((g.data - dmap.data).abs().max())
        check(err == 0.0 if ext == ".mrc" else err <= SIT_TOL,
              f"read_map({ext}) differs from the map by {err:g}")
        say(f"read_map({ext}, 0.0): {g.shape} on {g.device}, max diff "
            f"{err:g}; written in {t_mrc if ext == '.mrc' else t_sit:.2f} "
            f"s, read in {t_read:.2f} s")
    situs_check(paths[".sit"])

    shifted = dataclasses.replace(dmap, origin=dmap.origin
                                  + np.array([3.0, -2.0, 1.0]) * dmap.voxsp)
    scores = dict(ccc_with=dmap.ccc_with(shifted),
                  ccc_maps_scaled=ccc_maps_scaled(dmap, shifted),
                  overlap_fraction=overlap_fraction(
                      dmap.data, dmap.origin, shifted.data, shifted.origin,
                      dmap.voxsp))
    check(all(np.isfinite(v) and 0.0 < v <= 1.0 for v in scores.values())
          and dmap.ccc_with(dmap) == 1.0,
          f"grid scores of the map against its shifted copy: {scores}")
    say("grid scores against a copy shifted by (3, -2, 1) voxels: "
        + ", ".join(f"{k} {v:.6f}" for k, v in scores.items()))

    t0 = time.perf_counter()
    ss = build_scale_space(dmap, cfg.scalespace)
    torch.cuda.synchronize()
    t_ss = time.perf_counter() - t0
    octs = list(iter_octaves(dmap, cfg.scalespace))
    check(len(ss.octaves) == len(octs), "build_scale_space octave count")
    for f, (origin, octv) in zip(ss.octaves, octs):
        log_vol, gauss = octv.log_gauss()
        check(f.voxsp == octv.voxsp and f.real_shape == octv.real_shape
              and np.array_equal(ss.origin, origin)
              and same_bits(f.log, log_vol)
              and same_bits(f.grad, gradient(gauss, octv.grad_dtype())),
              f"build_scale_space octave {f.real_shape} differs from "
              "iter_octaves'")
        del log_vol, gauss
    say(f"build_scale_space: {[f.real_shape for f in ss.octaves]} bit for "
        f"bit with iter_octaves' fields, {t_ss:.3f} s")
    del ss, octs
    torch.cuda.empty_cache()

    base, _origin = prepare(dmap, cfg.scalespace)
    map_set = bench["map_set"]
    rows = map_set.octave == 1
    fn = build_forward(tuple(base.shape), cfg, cfg.detect.max_anchors,
                       cfg.describe.max_descriptors)
    reset_launches()
    desc, valid, coords, rfinal = fn(base)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(all(counts[k] > 0 for k in FORWARD_KERNELS),
          f"forward: a kernel did not launch: {counts}")
    v = valid.cpu().numpy()
    check(int(v.sum()) == int(rows.sum())
          and same_bits(desc[valid], map_set.desc[torch.as_tensor(
              rows, device=map_set.desc.device)])
          and np.array_equal(coords[valid].cpu().numpy().astype(np.float32),
                             map_set.coords[rows])
          and np.array_equal(rfinal[valid].cpu().numpy(),
                             map_set.rfinal[rows]),
          "forward's valid rows differ from describe_grid's base octave")
    say(f"forward on the prepared base {tuple(base.shape)}: {int(v.sum())} "
        f"valid of {v.size} lanes, rows, coords and frames bit for bit with "
        "describe_grid's base octave; launches "
        + ", ".join(f"{k} {counts[k]}" for k in FORWARD_KERNELS))
    del base, desc, valid, coords, rfinal

    sub_path = os.path.join(work, "bench_sub.pdb")
    write_pdb(bench["moved"], sub_path)
    t0 = time.perf_counter()
    grid, fcfg = functional.setup(paths[".mrc"], RES, config=cfg)
    m_set = functional.get_descriptors(grid, RES, grid.voxsp, fcfg,
                                       name="map")
    s_set = functional.get_descriptors(sub_path, RES, grid.voxsp, fcfg,
                                       name="sub")
    sols = functional.match_and_dock(m_set, s_set, bench["moved"], grid,
                                     RES, fcfg, n_copies=N_COPIES)
    torch.cuda.synchronize()
    t_fn = time.perf_counter() - t0
    table = functional.benchmark_solutions(sols, bench["copies"])
    best = table.min(axis=0) if len(sols) else np.full(N_COPIES, np.inf)
    found = int(np.sum(best < RECOVER_RMSD))
    rep = functional.get_repeatability(m_set, map_set)
    check(found >= MIN_RECOVERED,
          f"functional: {found}/{N_COPIES} copies recovered")
    say(f"functional setup -> get_descriptors -> match_and_dock: "
        f"{len(sols)} solutions, {found}/{N_COPIES} recovered, median best "
        f"CA-RMSD {np.median(best):.3f} A, {t_fn:.2f} s; repeatability of "
        f"its map anchors against the fit's: {rep}")


def situs_check(path):
    """The Situs file's voxel text through the native parse_floats and
    through np.fromiter (read_map's Python path): the same float64 values
    bit for bit, each parse's seconds."""
    from mad_tpu_torch.native import get_fastio
    with open(path, "rb") as fh:
        fh.readline()
        fh.readline()
        body = fh.read()
    t0 = time.perf_counter()
    nat = get_fastio().parse_floats(body)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = np.fromiter((float(t) for t in body.split()), dtype=np.float64)
    t_py = time.perf_counter() - t0
    check(nat.tobytes() == py.tobytes(),
          "Situs: parse_floats differs from np.fromiter")
    say(f"Situs voxel text ({len(body) / 1e6:.1f} MB, {nat.size} values): "
        f"native parse_floats {t_nat:.3f} s, np.fromiter {t_py:.3f} s, "
        "the same float64 values bit for bit")


def nan_map(device):
    """The 48^3 map with one NaN voxel of
    tests/test_misc_components.py:197-223."""
    import torch
    from mad_tpu_torch.core.grid import DensityGrid
    n = NAN_MAP["n"]
    data = np.random.default_rng(NAN_MAP["seed"]).random(
        (n, n, n)).astype(np.float32)
    data[NAN_MAP["voxel"]] = np.nan
    return DensityGrid(torch.as_tensor(data, device=device), np.zeros(3),
                       NAN_MAP["voxsp"])


def sanitizer_checks(device, cfg):
    """Stage mode silent on a clean bench fit and naming the stages on the
    NaN map; global mode naming the kernel."""
    import re
    from mad_tpu_torch.core.config import MadConfig
    from mad_tpu_torch.engine.pipeline import describe_grid
    from mad_tpu_torch.utils import sanitize
    with env("MAD_TPU_NANCHECK", "1"):
        sanitize.clear()
        t0 = time.perf_counter()
        fit = run_fit(device, None, cfg)
        sanitize.flush()
        t_fit = time.perf_counter() - t0
        check(fit["sols"], "stage mode: the clean fit gave no solution")
        try:
            describe_grid(nan_map(device), MadConfig(), name="bad")
            msg = None
        except FloatingPointError as e:
            msg = str(e)
        finally:
            sanitize.clear()
    check(msg is not None and re.search(NAN_STAGES, msg)
          and f"stage(s): {NAN_STAGE_LIST} (" in msg,
          f"stage mode on the NaN map: {msg}")
    say(f"sanitizer stage mode: the clean bench fit silent ({t_fit:.2f} s); "
        f"the NaN map: {msg}")
    sanitize.set_nan_checks(True)
    try:
        describe_grid(nan_map(device), MadConfig(), name="bad")
        msg = None
    except FloatingPointError as e:
        msg = str(e)
    finally:
        sanitize.set_nan_checks(False)
    check(msg is not None and "after kernel mad_" in msg,
          f"global mode on the NaN map: {msg}")
    say(f"sanitizer global mode, the NaN map: {msg}")


def profiling_check(device, cfg):
    """One fit's stage table with per-stage peaks (MAD_TPU_HBM=1)."""
    from mad_tpu_torch.utils import profiling
    profiling.show_timing(reset=True)
    timings = {}
    with env("MAD_TPU_HBM", "1"):
        run_fit(device, timings, cfg)
    table = profiling.show_timing(reset=False)
    peaks = profiling.hbm_peaks()
    check(set(table) == set(timings) and all(
        table[k] == timings[k] for k in timings),
        f"profiling and timing.stage disagree: {table} / {timings}")
    check(set(peaks) == set(timings) and all(v > 0 for v in peaks.values()),
          f"MAD_TPU_HBM=1 kept no peak for a stage: {peaks}")
    profiling.show_timing(reset=True)


def regime_line(kind, r, dt, parity=None):
    good = [x for x in r["rmsds"] if np.isfinite(x)]
    med = float(np.median(good)) if good else float("inf")
    distinct = r.get("distinct_claimed", "-")
    say(f"  {kind} {r['name']}: recovered {r['recovered']}/{r['n_copies']}, "
        f"distinct {distinct}, {r['n_solutions']} solutions, median best "
        f"CA-RMSD {med:.3f} A, map {r['map_shape']}, {dt:.2f} s"
        + (f" (PARITY.md: {parity}/3)" if parity is not None else ""))


def regime_checks(device):
    """mad_tpu's 20 documented regimes through the port on the card, at
    mad_tpu's own test gates."""
    import torch
    from mad_tpu_torch import testing as T
    misses = []
    t_all = time.perf_counter()
    for reg in T.TOPOLOGY_REGIMES:
        t0 = time.perf_counter()
        r = T.run_topology(reg, device=device)
        torch.cuda.synchronize()
        regime_line("topology", r, time.perf_counter() - t0)
        good = [x for x in r["rmsds"] if x < r["threshold"]]
        check(r["recovered"] == r["n_copies"] == r["distinct_claimed"]
              and np.median(good) < r["threshold"] / 2.0,
              f"topology {r['name']} misses mad_tpu's gate: {r}")
    for reg in T.KNOB_REGIMES:
        t0 = time.perf_counter()
        r = T.run_knob_regime(reg, device=device)
        torch.cuda.synchronize()
        regime_line("knobs", r, time.perf_counter() - t0)
        good = [x for x in r["rmsds"] if x < r["threshold"]]
        check(r["n_solutions"] >= r["n_copies"] // 2
              and r["recovered"] == r["n_copies"]
              and np.median(good) < r["threshold"] / 2.0,
              f"knob regime {r['name']} misses mad_tpu's gate: {r}")
    for point in T.DEGRADATION_LADDER:
        t0 = time.perf_counter()
        r = T.run_degraded(point, device=device)
        torch.cuda.synchronize()
        parity = LADDER_PARITY[point["name"]]
        regime_line("ladder", r, time.perf_counter() - t0, parity)
        if point["name"] == "noise_10pct":
            good = [x for x in r["rmsds"] if x < 5.0]
            check(r["recovered"] == 3 and np.median(good) < 2.5,
                  f"noise_10pct misses mad_tpu's gate: {r}")
        elif r["recovered"] < parity:
            misses.append(point["name"])
    n = (len(T.TOPOLOGY_REGIMES) + len(T.KNOB_REGIMES)
         + len(T.DEGRADATION_LADDER))
    say(f"regimes: {n} in {time.perf_counter() - t_all:.2f} s; rungs below "
        f"PARITY.md's recovery: {misses or 'none'}")


# -- phase 13: the scale stress -------------------------------------------

# mad_tpu's scripts/stress_large.py and its documented result (README.md:
# 16 subunits in a 370x353x336 map, 16/16 recovered, 0.11 A median best
# CA-RMSD); the port must recover at least STRESS_MIN of 16, the main
# path's 90 % gate (MIN_RECOVERED of N_COPIES)
STRESS = dict(n_copies=16, n_res=260, spread=165.0, seed=1)
STRESS_MAD_TPU = dict(shape=(370, 353, 336), recovered=16, median=0.11)
STRESS_MIN = 15
# the main path's kernels the stress's timed pass need not launch: K22
# (reduce_void runs in the map's build, before the passes)
STRESS_SKIP = ("axis_flags",)


@contextlib.contextmanager
def octave_spy():
    """Record (upsampled, real shape, gradient field dtype) of every
    octave the describes in the block take through
    engine.pipeline.octave_lanes."""
    from mad_tpu_torch.engine import pipeline
    seen, fn = [], pipeline.octave_lanes

    def spy(octv, *a, **k):
        lanes = fn(octv, *a, **k)
        seen.append((octv.upsampled, tuple(octv.real_shape),
                     lanes.grad.dtype))
        return lanes

    pipeline.octave_lanes = spy
    try:
        yield seen
    finally:
        pipeline.octave_lanes = fn


@contextlib.contextmanager
def stress_inputs():
    """Record the arguments of K3 (engine.pipeline's gradient: volume and
    dtype), K6, K7 (ops.describe's descriptor_hist), K19 and
    match_pairs in the block, by name."""
    from mad_tpu_torch.engine import match, pipeline
    from mad_tpu_torch.kernels import enumerate as k_enum, orient as k6
    from mad_tpu_torch.ops import describe
    from mad_tpu_torch.testing import recording
    with recording(pipeline, "gradient") as k3, \
            recording(k6, "orient") as k6_calls, \
            recording(describe, "descriptor_hist") as k7, \
            recording(k_enum, "enumerate_head") as k19, \
            recording(match, "match_pairs") as pairs:
        yield dict(gradient=k3, orient=k6_calls, descriptor_hist=k7,
                   enumerate_head=k19, match_pairs=pairs)


def stress_kernel_checks(rec):
    """K3, K6, K7 and K19 against their plain versions on the card at the
    inputs a stress pass gave them (``rec``, stress_inputs'; one K3, K6
    and K7 call an octave, the map's two octaves then the subunit's, in
    K4_SHAPES' order): the field each K3 launch wrote, the one K6 and K7
    then read, bit for bit with gradient_plain of the recorded volume;
    K6 agreeing on every anchor with frames within K6_RFINAL_TOL, as
    orient_check holds it at the bench; K7 by k7_checks (flags, rows,
    times); each K19 head equal to enumerate_head_plain's."""
    import torch
    from mad_tpu_torch.kernels import (enumerate as k_enum, gradient as k3,
                                       orient as k6)
    from mad_tpu_torch.testing import orient_agreement
    grads, orients = rec["gradient"], rec["orient"]
    check(len(grads) == len(orients) == len(K4_SHAPES),
          f"stress: {len(grads)} K3 and {len(orients)} K6 calls in a pass, "
          f"not {len(K4_SHAPES)}")
    for label, (vol, dtype), args in zip(K4_SHAPES, grads, orients):
        field = args[0]
        check(field.dtype == dtype and same_bits(
            field, k3.gradient_plain(vol, dtype)),
            f"stress K3 {label}: the {dtype} field on {tuple(vol.shape)} "
            f"differs from the plain version")
        got, ref = k6.orient(*args), k6.orient_plain(*args)
        share, dmax, close = orient_agreement(got, ref, K6_RFINAL_TOL)
        K = got[3].shape[0]
        check(share == 1.0 and close,
              f"stress K6 {label}: agrees on {round(share * K)} of {K} "
              f"anchors, frames within {dmax:g}")
        say(f"  stress K3 {label}: field {tuple(field.shape)} {field.dtype}"
            f" bit for bit with the plain version; K6: {K} anchors, "
            f"{int(got[3].sum())} lanes, all agreeing, frames max diff "
            f"{dmax:g}")
    k7_checks(rec["descriptor_hist"], "stress ")
    heads = rec["enumerate_head"]
    check(heads, "stress: the assembly ranked no tuple with K19")
    for ov, tab, head in heads:
        n, k = tab.shape
        check(torch.equal(k_enum.enumerate_head(ov, tab, head),
                          k_enum.enumerate_head_plain(ov, tab, head)),
              f"stress K19: C({n}, {k}) head {head} differs from the plain "
              f"version")
        say(f"  stress K19: C({n}, {k}) = {math.comb(n, k):,} ranks, head "
            f"{head}, equal to the plain version")


def unique_times(label, args):
    """match_pairs at ``args`` (its arguments) and, on its pairs, its two
    host np.unique(..., axis=0) calls alone: the median seconds of
    HOST_IO_REPS calls of each, printed."""
    from mad_tpu_torch.engine import match
    map_set, sub_set = args[0], args[1]
    t_all, pairs = median_run(lambda: match.match_pairs(*args))
    check(pairs is not None, f"match_pairs {label}: no pair")
    hi = sub_set.subv_coords[pairs["rows"]]
    lo = map_set.subv_coords[pairs["cols"]]
    t_hi, hi_cloud = median_run(lambda: np.unique(hi, axis=0))
    t_lo, lo_cloud = median_run(lambda: np.unique(lo, axis=0))
    say(f"  match_pairs {label}: {len(hi)} pairs, {t_all * 1e3:.1f} ms; "
        f"np.unique of the subunit anchors ({len(hi)} rows -> "
        f"{len(hi_cloud)}) {t_hi * 1e3:.1f} ms, of the map anchors "
        f"({len(lo)} rows -> {len(lo_cloud)}) {t_lo * 1e3:.1f} ms")


def stress_line(what, r):
    say(f"stress {what}: {r['seconds']:.3f} s, peak "
        f"{r['peak'] / 2 ** 30:.3f} GiB, {len(r['sols'])} solutions, "
        f"{len(r['models'])} models, {r['recovered']}/{STRESS['n_copies']} "
        f"recovered, median best CA-RMSD {np.median(r['rmsds']):.3f} A "
        f"(mad_tpu: {STRESS_MAD_TPU['recovered']}/{STRESS['n_copies']}, "
        f"{STRESS_MAD_TPU['median']} A)")


def stress_phase(device):
    """Phase 13 (the module docstring) after the bench's match_pairs
    times; returns its seconds."""
    import torch
    from mad_tpu_torch import testing as T
    from mad_tpu_torch.kernels import (KERNELS, bf16_counts, launch_counts,
                                       reset_launches)
    from mad_tpu_torch.ops import scalespace
    t_phase = time.perf_counter()
    cfg = bench_config()
    t0 = time.perf_counter()
    sub, copies, dmap = T.build_system(**STRESS, resolution=RES, voxsp=VOXSP,
                                       device=device)
    torch.cuda.synchronize()
    say(f"stress map {dmap.shape} ({int(np.prod(dmap.shape))} voxels; "
        f"mad_tpu's {STRESS_MAD_TPU['shape']}) built in "
        f"{time.perf_counter() - t0:.3f} s")
    with octave_spy() as seen, stress_inputs() as rec:
        warm = T.timed_pass(sub, copies, dmap, RES, cfg, device=device)
    stress_line("warm pass (the kernels' inputs recorded)", warm)
    (up, up_shape, up_dtype), base = seen[:2]
    say(f"stress map octaves: {up_shape} ({int(np.prod(up_shape))} voxels) "
        f"{up_dtype}, {base[1]} ({int(np.prod(base[1]))} voxels) {base[2]}")
    check(up and up_dtype == torch.bfloat16,
          f"stress: the upsampled octave {up_shape} keeps a {up_dtype} field")
    stress_kernel_checks(rec)
    for i, args in enumerate(rec["match_pairs"]):
        unique_times(f"stress call {i}", args)
    del rec
    torch.cuda.empty_cache()
    # Warm again: the plain versions leave the allocator holding other
    # block sizes than the pass's.
    T.timed_pass(sub, copies, dmap, RES, cfg, device=device)
    reset_launches()
    with octave_spy() as seen:
        timed = T.timed_pass(sub, copies, dmap, RES, cfg, device=device)
    counts, bf16 = launch_counts(), bf16_counts()
    stress_line("timed pass (bfloat16 field)", timed)
    say(f"stress launches: {counts}; with a bfloat16 field: {bf16}; "
        f"octaves described: {seen}")
    diff = solution_diff(warm["sols"], timed["sols"])
    check(not diff, f"stress: the timed pass differs from the warm pass, "
          f"whose inputs the kernels were held at: {diff}")
    need = [n for n in KERNELS
            if n not in MESH_ONLY + ("hetero_head",) + STRESS_SKIP]
    check(all(counts[n] > 0 for n in need),
          f"stress: a kernel of the path never launched: {counts}")
    check(all(v > 0 for v in bf16.values()),
          f"stress: K3, K6 or K7 made no launch on a bfloat16 field: {bf16}")
    check((True, up_shape, torch.bfloat16) in seen,
          f"stress: the map's upsampled octave's field was not bfloat16: "
          f"{seen}")
    sols = timed["sols"]
    check(sols and all(np.isfinite(s.structure.coords).all()
                       and np.isfinite(s.ccc) for s in sols),
          "stress: no solution, or a non-finite one")
    check(timed["recovered"] >= STRESS_MIN,
          f"stress: {timed['recovered']}/{STRESS['n_copies']} recovered")
    check(timed["models"] and all(np.isfinite(m.ccc)
                                  for m in timed["models"]),
          "stress: no model, or a non-finite model CCC")
    old = scalespace.BF16_VOXELS
    scalespace.BF16_VOXELS = int(np.prod(up_shape)) + 1
    try:
        reset_launches()
        with octave_spy() as seen32:
            f32 = T.timed_pass(sub, copies, dmap, RES, cfg, device=device)
        bf16_32 = bf16_counts()
    finally:
        scalespace.BF16_VOXELS = old
    stress_line("pass with a float32 field", f32)
    check((True, up_shape, torch.float32) in seen32
          and not any(bf16_32.values()),
          f"stress: the float32 pass read a bfloat16 field: {seen32}")
    same = [np.asarray(r["rmsds"]) < RECOVER_RMSD for r in (timed, f32)]
    check(np.array_equal(*same),
          f"stress: the float32 field recovered other copies: "
          f"{np.flatnonzero(same[0])} / {np.flatnonzero(same[1])}")
    say(f"stress: bfloat16 field {timed['seconds']:.3f} s, peak "
        f"{timed['peak'] / 2 ** 30:.3f} GiB; float32 field "
        f"{f32['seconds']:.3f} s, peak {f32['peak'] / 2 ** 30:.3f} GiB; the "
        f"same {int(same[0].sum())} copies recovered")
    del sub, copies, dmap, warm, timed, f32
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


# -- phase 14: the ensemble at bench scale ----------------------------------

# PARITY.md (c): mad_tpu ranks conf_0 first by RWmCC (its pass condition),
# mCC and Repeatability; Weight narrowly prefers the 5 A decoy
ENSEMBLE_PARITY = dict(RWmCC="conf_0", mCC="conf_0", Repeatability="conf_0",
                       Weight="conf_2")


def ensemble_phase(device, root):
    """Phase 14 (the module docstring); returns its seconds."""
    import contextlib
    import io
    import os
    import torch
    from mad_tpu_torch import testing as T
    from mad_tpu_torch.kernels import launch_counts, reset_launches
    t_phase = time.perf_counter()
    work = os.path.join(root, "ensemble")
    os.makedirs(work)
    lines = []
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        r = T.run_ensemble_bench(work, device=device, log=lines.append)
    torch.cuda.synchronize()
    counts = launch_counts()
    for line in lines:
        say(line)
    say("ensemble: top by each score " + ", ".join(
        f"{k} {r['top'][k]} (mad_tpu, PARITY.md (c): {ENSEMBLE_PARITY[k]})"
        for k in T.ENSEMBLE_SCORES) + "; launches " + ", ".join(
            f"{k} {counts[k]}" for k in SESSION_KERNELS))
    check(all(counts[k] > 0 for k in SESSION_KERNELS),
          f"ensemble: a kernel of {SESSION_KERNELS} never launched: {counts}")
    check(len(r["rows"]) == 1 + len(T.DECOY_SCALES),
          f"ensemble: {len(r['rows'])} conformers ranked")
    check(r["ok"], f"ensemble: {r['top']['RWmCC']} first by RWmCC, not "
          f"conf_0: {r['rows']}")
    return time.perf_counter() - t_phase


def main():
    global T_START
    import tempfile
    T_START = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mad_smoke_") as work:
        phases(work)


def phases(work):
    """Phases 1-14 (the module docstring); ``work`` is a scratch directory
    for the sessions' workdirs."""
    import torch
    import mad_tpu_torch  # noqa: F401  (the port must be beside the script)
    device, smi = device_phase()
    build_phase()
    from mad_tpu_torch.kernels import KERNELS, launch_counts, reset_launches
    from mad_tpu_torch.testing import assemble_solutions, overlap_tolerance

    cfg = bench_config()
    t0 = time.perf_counter()
    fit = run_fit(device, {}, cfg)
    torch.cuda.synchronize()
    say(f"warm pass: {time.perf_counter() - t0:.2f} s, map "
        f"{fit['dmap'].shape}, {fit['map_set'].n} map / "
        f"{fit['sub_set'].n} subunit descriptors, {len(fit['sols'])} "
        f"solutions")
    check(fit["dmap"].shape == BENCH_MAP_SHAPE,
          f"bench map {fit['dmap'].shape}, expected {BENCH_MAP_SHAPE}")

    checks = kernel_checks(fit, cfg, device)
    for name, r in checks.items():
        say_measure(name, r)
    del fit
    torch.cuda.empty_cache()
    # Warm again: the plain versions of the checks leave the allocator
    # holding other block sizes than the fit's.
    run_fit(device, None, cfg)

    timings = {}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with cuda_pads() as pads:
        t0 = time.perf_counter()
        fit = run_fit(device, timings, cfg)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    sols = fit["sols"]
    rmsds = best_rmsds([s.structure for s in sols], fit["copies"])
    found = int(np.sum(np.asarray(rmsds) < RECOVER_RMSD))
    say(f"timed pass: {total:.3f} s; stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in timings.items()))
    say(f"peak device memory: {peak / 2**30:.3f} GiB")
    say(f"launches: {counts}")
    say(f"{len(sols)} solutions, {found}/{N_COPIES} subunits recovered, "
        f"median best CA-RMSD {np.median(rmsds):.3f} A")
    main_path = [n for n in KERNELS if n not in MESH_ONLY + ("hetero_head",)]
    check(all(counts[n] > 0 for n in main_path),
          f"a kernel of the main path never launched: {counts}")
    check(all(counts[n] == 0 for n in MESH_ONLY),
          f"a mesh entry launched on one device: {counts}")
    check(not pads, f"F.pad called on a CUDA tensor in the fit: {pads}")
    k1 = counts["conv1d"] + counts["log_gauss"]
    check(k1 <= K1_FIT_LAUNCHES, f"K1 launched {k1} times in the fit")
    check(counts["upsample2"] == K2_FIT_LAUNCHES,
          f"K2 launched {counts['upsample2']} times in the fit")
    check(len(sols) > 0 and all(
        np.isfinite(s.structure.coords).all() and np.isfinite(s.ccc)
        and s.structure.coords.shape == fit["moved"].coords.shape
        for s in sols), "non-finite or misshapen solutions")
    check(found >= MIN_RECOVERED,
          f"only {found}/{N_COPIES} copies recovered")
    a = fit["assembly"]
    check(a is not None and a["models"], "the timed pass built no model")
    models = a["models"]
    check(all(np.isfinite(m.ccc) for m in models), "a model CCC is not finite")
    check(len(set(models[0].components)) == N_COPIES,
          f"the first model is {models[0].components}, not {N_COPIES} "
          "distinct solutions")
    say(f"{len(models)} model(s); first {models[0].components}, CCC "
        f"{models[0].ccc:.6f}, max overlap {models[0].max_overlap:.6f}")

    # The fit once more with the plain versions of K1's LoG, K2, K3, K5, K6,
    # K8, K15 and the matching front swapped in.
    plain_fit_t = {}
    before = launch_counts()
    swapped = swapped_kernels(fit_swaps())
    with plain_versions(fit_swaps()):
        t0 = time.perf_counter()
        pf = run_fit(device, plain_fit_t, cfg)
        torch.cuda.synchronize()
        plain_total = time.perf_counter() - t0
    after = launch_counts()
    check(all(after[k] == before[k] for k in swapped),
          "a swapped kernel launched with its plain version swapped in")
    p_found = int(np.sum(np.asarray(best_rmsds(
        [s.structure for s in pf["sols"]], pf["copies"])) < RECOVER_RMSD))
    check(p_found >= MIN_RECOVERED,
          f"with the plain versions only {p_found}/{N_COPIES} recovered")
    say(f"fit with the kernels {total:.3f} s, with the plain versions of "
        f"{', '.join(swapped)} {plain_total:.3f} s ({p_found}/{N_COPIES} "
        "recovered); stages (s) kernel / plain: " + ", ".join(
            f"{k} {timings[k]:.4f} / {plain_fit_t.get(k, 0.0):.4f}"
            for k in timings))
    del pf
    # K21, K22 and K23 are bit for bit with their plain versions, so the
    # fit with only those swapped in gives the timed fit's bits.
    before = launch_counts()
    with plain_versions(select_pad_swaps()):
        pf = run_fit(device, None, cfg)
    after = launch_counts()
    check(all(after[k] == before[k]
              for k in ("select_exact", "axis_flags", "crop_pad")),
          "K21-K23 launched with their plain versions swapped in")
    diff = solution_diff(fit["sols"], pf["sols"])
    check(not diff and same_bits(fit["dmap"].data, pf["dmap"].data)
          and same_bits(fit["map_set"].desc, pf["map_set"].desc),
          f"the fit with K21-K23's plain versions differs: {diff}")
    say("fit with K21-K23's plain versions: the map, the map's descriptors "
        f"and the {len(pf['sols'])} solutions bit for bit")
    del pf

    # Phase 6: the same assembly with the plain versions on the card.
    plain_t = {}
    before = launch_counts()
    with plain_versions(assembly_swaps()):
        p = assemble_solutions(a["structures"], fit["dmap"], cfg, N_COPIES,
                               device=device, timings=plain_t)
    check(launch_counts() == before,
          "a kernel launched with the plain versions swapped in")
    tol = overlap_tolerance(a["structures"], cfg.assembly, device)
    e_ov, e_ccc = compare_assemblies(a, p, tol, "kernels vs plain")
    say("assembly with the kernels " + ", ".join(
        f"{k} {timings[k]:.4f}" for k in ASSEMBLY_STAGES) + " s; plain "
        + ", ".join(f"{k} {plain_t[k]:.4f}" for k in ASSEMBLY_STAGES)
        + f" s; same tuples and models (overlap max diff {e_ov:g}, CCC "
        f"max diff {e_ccc:g})")
    del a, p
    session = session_phase(device, cfg, fit, work)
    bench = {k: fit[k] for k in ("map_set", "sub_set", "moved", "dmap",
                                 "copies")}
    dmap = fit["dmap"]
    del fit
    torch.cuda.empty_cache()

    counts["hetero_head"] = hetero_phase(device)
    small_reference(device, cfg)
    capacity = capacity_phase(device, cfg, dmap)
    dock, mesh_counts = dock_mesh_phase(device, cfg, bench, session)
    counts.update({k: mesh_counts[k] for k in MESH_ONLY})
    checks["pair_merge"] = dock.pop("pair_merge")
    before = time.perf_counter() - T_START
    t12 = surface_phase(device, cfg, bench, work)
    say(f"phases 1-11: {before:.2f} s; phase 12 (public surface and "
        f"regimes): {t12:.2f} s; the script so far "
        f"{time.perf_counter() - T_START:.2f} s")
    del session, dmap
    # phase 13 starts with match_pairs' times on the bench fit's sets,
    # which are then freed so that the stress's peaks are its own
    t13 = time.perf_counter()
    unique_times("bench", (bench["map_set"], bench["sub_set"], cfg.match,
                           None))
    del bench
    torch.cuda.empty_cache()
    t13 = time.perf_counter() - t13 + stress_phase(device)
    t14 = ensemble_phase(device, work)
    say(f"phase 13 (the stress): {t13:.2f} s; phase 14 (the ensemble): "
        f"{t14:.2f} s; the script so far "
        f"{time.perf_counter() - T_START:.2f} s")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    report = [dict({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": counts[name]},
                   **{k: checks[name][k] for k in keys},
                   kernel_ms=checks[name].get("kernel_ms"))
              for name, (_mod, src, rep) in KERNELS.items()]
    report += [dict({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": rows[name]["launches"]},
                    **{k: rows[name][k] for k in keys},
                    kernel_ms=rows[name].get("kernel_ms"))
               for table, rows in ((CAPACITY_ROWS, capacity),
                                   (DOCK_ROWS, dock))
               for name, (_k, src, rep) in table.items()]
    say(json.dumps({"kernels": report}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
