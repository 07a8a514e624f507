#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (mad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) when it fails:
  1. device: needs torch.cuda.is_available() (there is no CPU path);
     prints the card's name and power limit, the torch and CUDA versions;
     TF32 off for matmul and cuDNN;
  2. build: the hand-written kernels from mad_tpu_torch/csrc;
  3. warm pass of the main path: the fit of bench.py without its assembly
     step -- a 10-copy assembly map (make_assembly(10, 260, seed 0,
     spread 115, shell), 10 A at 1.4 A, reduce_void), the map and a decoy
     subunit described, 10 copies docked with one rescue round, solutions
     CC-scored;
  4. each kernel against its plain PyTorch version on the same CUDA
     tensors at the main path's shapes, with the tolerance of its tests,
     and both timed with CUDA events;
  5. timed pass of the main path with every launch counter reset first;
     fails unless every kernel launched, the solutions are finite and at
     least 9 of 10 copies are recovered (best CA-RMSD < 10 A);
  6. a small two-copy fit through the card and through the CPU (plain
     versions) must recover the same copies at the same poses.
The last three lines are the kernel report (JSON), the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np

RES, VOXSP, N_COPIES, N_RES, SPREAD, SEED = 10.0, 1.4, 10, 260, 115.0, 0
BENCH_MAP_SHAPE = (273, 276, 262)
RECOVER_RMSD, MIN_RECOVERED = 10.0, 9
SMALL = dict(n_copies=2, n_res=40, seed=3, spread=14.0, res=8.0, voxsp=2.0)
SMALL_POSE_TOL = 0.5            # A, best CA-RMSD per copy, card vs CPU


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
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    return torch.device("cuda:0"), smi


# -- phase 2 --------------------------------------------------------------

def build_phase():
    from mad_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    say(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line:
            say("  ptxas:" + line.split(":", 1)[-1])


# -- main path ------------------------------------------------------------

def bench_config():
    import dataclasses
    from mad_tpu_torch.core.config import MadConfig
    cfg = MadConfig()
    return cfg.replace(filter=dataclasses.replace(cfg.filter,
                                                  rescue_rounds=1))


def run_fit(device, timings, cfg, n_copies=N_COPIES, n_res=N_RES,
            seed=SEED, spread=SPREAD, res=RES, voxsp=VOXSP, shell=True):
    """bench.py's run_fit without the assembly step, through the port."""
    from mad_tpu_torch.engine.docking import dock_structure
    from mad_tpu_torch.engine.pipeline import (describe_grid,
                                               describe_structure)
    from mad_tpu_torch.ops.simulate import simulate_density
    from mad_tpu_torch.testing import decoy_transform, make_assembly
    from mad_tpu_torch.timing import stage

    sub, copies = make_assembly(n_copies=n_copies, n_res=n_res, seed=seed,
                                spread=spread, shell=shell)
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    with stage(timings, "simulate", device):
        dmap = simulate_density(coords, res, voxsp, device,
                                masses=masses).reduce_void()
    moved = decoy_transform(sub)
    with stage(timings, "describe_map", device):
        map_set = describe_grid(dmap, cfg, name="bench_map", device=device)
    with stage(timings, "describe_subunit", device):
        sub_set = describe_structure(moved, res, dmap.voxsp, cfg,
                                     name="bench_sub", device=device)
    sols = dock_structure(map_set, sub_set, moved, dmap, res, cfg,
                          n_copies=n_copies, device=device, timings=timings)
    return dict(copies=copies, dmap=dmap, moved=moved, map_set=map_set,
                sub_set=sub_set, sols=sols)


def best_rmsds(sols, copies):
    return [min((s.structure.rmsd_ca_with(c) for s in sols), default=np.inf)
            for c in copies]


# -- phase 4: kernels against their plain versions -------------------------

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


def kernel_checks(fit, cfg, device):
    """Each kernel vs its plain version at main-path shapes; returns
    {name: (max_abs_err, ms, plain_ms)}."""
    import torch
    from mad_tpu_torch.core.eqsp import get_eqsp
    from mad_tpu_torch.engine.match import match_descriptors
    from mad_tpu_torch.engine.pipeline import octave_lanes
    from mad_tpu_torch.kernels import conv1d, describe, peaks, repeat
    from mad_tpu_torch.ops.convolve import gaussian_kernel1d, log_filter3d
    from mad_tpu_torch.ops.describe import descriptor_lattice, region_ids
    from mad_tpu_torch.ops.orient import ref_zone_bounds
    from mad_tpu_torch.ops.scalespace import iter_octaves

    out = {}
    ss = cfg.scalespace
    up_octave = next(o for _org, o in iter_octaves(fit["dmap"], ss)
                     if o.upsampled)
    vol = up_octave.volume()
    say(f"kernels at the upsampled octave {tuple(vol.shape)}")

    # K1: the LoG's second-derivative taps along each axis. Tolerance
    # 1e-5 * max|ref| (the kernel rounds as the shift-add does).
    g2 = gaussian_kernel1d(ss.detect_sigma, 2, ss.truncate)
    err, scale = 0.0, 0.0
    for axis in range(3):
        a = conv1d.conv1d_along(vol, g2, axis)
        b = conv1d.conv1d_along_plain(vol, g2, axis)
        err = max(err, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
        del a, b
    check(err <= 1e-5 * scale, f"K1 max error {err} > 1e-5 * {scale}")
    three = lambda f: [f(vol, g2, axis) for axis in range(3)]
    out["conv1d"] = (err, cuda_ms(lambda: three(conv1d.conv1d_along)),
                     cuda_ms(lambda: three(conv1d.conv1d_along_plain)))

    # K4: the octave's LoG; integer-exact (same peaks, values, order).
    log_vol, _gauss = log_filter3d(vol, ss.detect_sigma, ss.truncate)
    del _gauss
    dc = cfg.detect
    args = (log_vol, up_octave.real_shape, float(dc.threshold_abs),
            int(dc.exclude_border), int(dc.max_anchors))
    v1, i1 = peaks.peak_topk(*args)
    v2, i2 = peaks.peak_topk_plain(*args)
    check(torch.equal(i1, i2) and torch.equal(v1, v2),
          f"K4 peaks differ ({len(i1)} vs {len(i2)})")
    out["peak_mask_compact"] = (
        float((v1 - v2).abs().max()) if len(v1) else 0.0,
        cuda_ms(lambda: peaks.peak_topk(*args)),
        cuda_ms(lambda: peaks.peak_topk_plain(*args)))
    say(f"  K4: {len(i1)} peaks")
    del log_vol, vol

    # K7: the octave's lanes. Rows equal in >= 99 %, the rest within an L1
    # of 8 counts (zone-bound ulps of atan2f / acosf).
    lanes = octave_lanes(up_octave, cfg)
    dcfg = cfg.describe
    radius = (dcfg.patch_size - dcfg.patch_size % 2) // 2
    valid = torch.ones(lanes.coords.shape[0], dtype=torch.bool,
                       device=device)
    args = (lanes.grad, lanes.coords, lanes.rfinal, valid,
            up_octave.real_shape, descriptor_lattice(radius, True),
            region_ids(radius, dcfg.subregions),
            ref_zone_bounds(get_eqsp(dcfg.subeqsp_size)), dcfg.subregions,
            float(dcfg.cutoff_magn), float(dcfg.zero_magn))
    d1, ok1 = describe.descriptor_hist(*args)
    d2, ok2 = describe.descriptor_hist_plain(*args)
    diff = (d1.long() - d2.long()).abs()
    same = float((diff.sum(dim=1) == 0).float().mean())
    check(torch.equal(ok1, ok2), "K7 in-bounds flags differ")
    check(same >= 0.99 and int(diff.sum(dim=1).max()) <= 8,
          f"K7 rows equal {same:.4f}, max row L1 {int(diff.sum(1).max())}")
    out["descriptor_hist"] = (float(diff.max()),
                              cuda_ms(lambda: describe.descriptor_hist(*args)),
                              cuda_ms(lambda: describe.descriptor_hist_plain(
                                  *args)))
    say(f"  K7: {len(ok1)} lanes, rows equal {same:.5f}")
    del lanes, args, d1, d2

    # K13: the head pairs that the match stage scores exactly. Equal except
    # pairs with an anchor within 1e-4 A of the 4 A radius.
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
    out["exact_repeat"] = (float((r1 - r2).abs().max()),
                           cuda_ms(lambda: repeat.exact_repeat(*args)),
                           cuda_ms(lambda: repeat.exact_repeat_plain(*args)))
    say(f"  K13: {n_head} pairs x {table.hi_cloud.shape[0]} x "
        f"{table.lo_cloud.shape[0]} anchors, {int(edge.sum())} on the edge")
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


# -- phase 6: small reference ---------------------------------------------

def small_reference(device, cfg):
    import dataclasses
    small_cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                       max_anchors=1024))
    kw = dict(n_copies=SMALL["n_copies"], n_res=SMALL["n_res"],
              seed=SMALL["seed"], spread=SMALL["spread"], res=SMALL["res"],
              voxsp=SMALL["voxsp"], shell=False)
    card = run_fit(device, None, small_cfg, **kw)
    host = run_fit("cpu", None, small_cfg, **kw)
    rc = best_rmsds(card["sols"], card["copies"])
    rh = best_rmsds(host["sols"], host["copies"])
    say(f"small reference: card {len(card['sols'])} solutions, best "
        f"CA-RMSD {np.round(rc, 3).tolist()}; CPU {len(host['sols'])}, "
        f"{np.round(rh, 3).tolist()}")
    check(all(r < RECOVER_RMSD for r in rc) and all(r < RECOVER_RMSD
                                                    for r in rh),
          "small reference: a copy was not recovered")
    check(max(abs(a - b) for a, b in zip(rc, rh)) <= SMALL_POSE_TOL,
          "small reference: card and CPU poses differ")


# -- main -----------------------------------------------------------------

def main():
    import torch
    import mad_tpu_torch  # noqa: F401  (the port must be beside the script)
    device, smi = device_phase()
    build_phase()
    from mad_tpu_torch.kernels import KERNELS, launch_counts, reset_launches

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
    for name, (err, ms, pms) in checks.items():
        say(f"  {name}: max abs err {err:g}, kernel {ms:.3f} ms, "
            f"plain {pms:.3f} ms")
    del fit
    torch.cuda.empty_cache()

    timings = {}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = run_fit(device, timings, cfg)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    sols = fit["sols"]
    rmsds = best_rmsds(sols, fit["copies"])
    found = int(np.sum(np.asarray(rmsds) < RECOVER_RMSD))
    say(f"timed pass: {total:.3f} s; stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()))
    say(f"peak device memory: {peak / 2**30:.3f} GiB")
    say(f"launches: {counts}")
    say(f"{len(sols)} solutions, {found}/{N_COPIES} subunits recovered, "
        f"median best CA-RMSD {np.median(rmsds):.3f} A")
    check(all(n > 0 for n in counts.values()),
          f"a kernel of the main path never launched: {counts}")
    check(len(sols) > 0 and all(
        np.isfinite(s.structure.coords).all() and np.isfinite(s.ccc)
        and s.structure.coords.shape == fit["moved"].coords.shape
        for s in sols), "non-finite or misshapen solutions")
    check(found >= MIN_RECOVERED,
          f"only {found}/{N_COPIES} copies recovered")
    del fit

    small_reference(device, cfg)

    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": checks[name][0],
         "ms": checks[name][1], "plain_ms": checks[name][2]}
        for name, (_mod, src, rep) in KERNELS.items()]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
