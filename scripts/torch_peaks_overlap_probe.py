#!/usr/bin/env python3
"""K4 (the LoG peak stream) and K18 (the occupancy overlap) at the bench
fit's inputs on one NVIDIA card, beside what bounds them.

    python3 scripts/torch_peaks_overlap_probe.py [--tree DIR]

Runs chip_smoke.py's bench fit once, records K4's four LoG volumes (one
describe_grid of the bench map, one describe_structure of the subunit)
and K18's inputs (engine/assemble.overlap_inputs of the fit's solutions,
and of 80: each solution again at five small lattice shifts, as
chip_smoke.k18_checks' heteromer set), then times with CUDA events
(chip_smoke.kernel_ms for a bare launch: mean of 20, the stream held
while the host enqueues them; chip_smoke.cuda_ms for a whole call, mean
of ten):
  * K4 at each volume: the voxels above threshold and the candidates
    that its stream passes to the neighbourhood test; the kernel alone at
    the fit's threshold, and at +inf (no voxel above it: the threshold
    stream alone); torch.amax of the volume (one PyTorch pass reading the
    same bytes); the wrapper (kernels/peaks.peak_topk); and the wrapper's
    steps after the count as they were before the kernel's own order pass
    (pass 3): torch.sort of the keys, their decode and the values' gather
    (topk_from_keys), held equal to pass 3's top-k;
  * K18 at both sets: the kernel alone and the wrapper
    (kernels/overlap.pack_overlap);
each beside its bound (bytes over 3.35 TB/s: K4 the volume read once,
K18 the boxes read once). ``--tree DIR`` times another checkout's
mad_tpu_torch and chip_smoke (an older one: the parent of a change)
through the calls every checkout has: the wrappers alone, on the same
inputs. Prints the card's name and power limit first. Needs a card.
"""

import argparse
import os
import sys

import numpy as np

K4_SHAPES = ("map upsampled", "map base", "subunit upsampled",
             "subunit base")
HETERO_M = 80           # the heteromer phase's solution count


def inputs(cs, device):
    """K4's recorded calls and K18's two input sets, from one bench fit."""
    from mad_tpu_torch.engine import assemble as asm, pipeline
    from mad_tpu_torch.ops import detect
    from mad_tpu_torch.testing import recording
    cfg = cs.bench_config()
    fit = cs.run_fit(device, {}, cfg)
    with recording(detect, "peak_topk") as calls:
        pipeline.describe_grid(fit["dmap"], cfg, device=device)
        pipeline.describe_structure(fit["moved"], cs.RES, fit["dmap"].voxsp,
                                    cfg, device=device)
    structures = [s.structure for s in fit["sols"]]
    rng = np.random.default_rng(cs.SEED)
    shifted = [s.with_coords(s.coords + rng.integers(-3, 4, 3)
                             * cfg.assembly.sim_voxsp)
               for s in structures * (HETERO_M // len(structures))]
    sets = [(label, asm.overlap_inputs(sols, cfg.assembly, device))
            for label, sols in (("fit", structures), ("heteromer", shifted))]
    return calls, sets


def wrappers(cs, calls, sets):
    """The wrappers alone, as every checkout has them."""
    from mad_tpu_torch.kernels import overlap, peaks
    for label, args in zip(K4_SHAPES, calls):
        ms = cs.cuda_ms(lambda: peaks.peak_topk(*args), reps=10)
        cs.say(f"K4 {label} {tuple(args[0].shape)}: wrapper {ms:.4f} ms")
    for label, (dens, off, frame) in sets:
        ms = cs.cuda_ms(lambda: overlap.pack_overlap(dens, off, frame),
                        reps=10)
        cs.say(f"K18 {label}: {dens.shape[0]} solutions, wrapper {ms:.4f} "
               "ms")


def kernels(cs, device, calls, sets):
    import torch
    from mad_tpu_torch.kernels import overlap, peaks
    counter = torch.empty(3, dtype=torch.int32, device=device)
    keys = torch.empty(peaks._FIRST_CAPACITY, dtype=torch.int64,
                       device=device)
    cand = torch.empty(peaks._FIRST_CANDIDATES, dtype=torch.int32,
                       device=device)
    for label, args in zip(K4_SHAPES, calls):
        vol, real, thr, border = args[:4]
        X = vol.shape[0]
        top = (torch.empty(args[4], device=device),
               torch.empty(args[4], dtype=torch.int64, device=device))

        def launch(t):
            peaks.compact(vol, real, t, border, 0, X, 0, keys, cand, counter,
                          *top)
        alone = cs.kernel_ms(lambda: launch(thr))
        n, most, warps = counter.tolist()
        above = int((vol > thr).sum())
        stream = cs.kernel_ms(lambda: launch(float("inf")))
        amax = cs.cuda_ms(lambda: torch.amax(vol), reps=10)
        wrapper = cs.cuda_ms(lambda: peaks.peak_topk(*args), reps=10)
        launch(thr)
        survivors = int(cand[:warps].sum())
        tail = cs.cuda_ms(lambda: peaks.topk_from_keys(
            vol, keys[:n], args[4], 0, X, 0), reps=10)
        want = peaks.topk_from_keys(vol, keys[:n], args[4], 0, X, 0)
        k = min(n, args[4])
        cs.check(torch.equal(top[1][:k], want[1])
                 and torch.equal(top[0][:k], want[0]),
                 f"K4 {label}: the order pass differs from torch.sort's")
        bound = 4 * vol.numel() / cs.PEAK_BYTES_S * 1e3
        cs.say(f"K4 {label} {tuple(vol.shape)}: {above} voxels above "
               f"threshold, {survivors} candidates past the stream's z "
               f"test ({warps} warps, at most {most} a warp), {n} peaks; "
               f"kernel alone {alone:.4f} ms, threshold stream alone (+inf) "
               f"{stream:.4f} ms, torch.amax {amax:.4f} ms, wrapper "
               f"{wrapper:.4f} ms, torch.sort + decode + gather after the "
               f"count {tail:.4f} ms; bound {bound:.4f} ms "
               f"({bound / alone:.1%} of the kernel alone, "
               f"{bound / stream:.1%} of the stream alone)")
    for label, (dens, off, frame) in sets:
        m = dens.shape[0]
        counts = torch.empty(m * m + 1, dtype=torch.int32, device=device)
        ov = torch.empty((m, m), dtype=torch.float32, device=device)
        alone = cs.kernel_ms(lambda: overlap.launch_overlap(
            dens, off, frame, counts, ov))
        wrapper = cs.cuda_ms(lambda: overlap.pack_overlap(dens, off, frame),
                             reps=10)
        bound = 4 * dens.numel() / cs.PEAK_BYTES_S * 1e3
        cs.say(f"K18 {label}: {m} solutions, boxes {tuple(dens.shape[1:])}, "
               f"frame {frame}; kernel alone {alone:.4f} ms, wrapper "
               f"{wrapper:.4f} ms; bound {bound:.4f} ms "
               f"({bound / alone:.1%} of the kernel alone)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    root = args.tree or os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    sys.path.insert(0, os.path.abspath(root))
    os.chdir(root)
    import chip_smoke as cs
    device, _smi = cs.device_phase()
    cs.build_phase()
    calls, sets = inputs(cs, device)
    if args.tree:
        wrappers(cs, calls, sets)
    else:
        kernels(cs, device, calls, sets)


if __name__ == "__main__":
    main()
