#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (mad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) when it fails:
  1. device: needs torch.cuda.is_available() (there is no CPU path);
     prints the card's name and power limit, the torch and CUDA versions;
     TF32 off for matmul and cuDNN;
  2. build: the hand-written kernels from mad_tpu_torch/csrc (one nvcc per
     source, all at once, then one link);
  3. warm pass of the main path, the whole of bench.py's run_fit: a
     10-copy assembly map (make_assembly(10, 260, seed 0, spread 115,
     shell), 10 A at 1.4 A, reduce_void), the map and a decoy subunit
     described, 10 copies docked with one rescue round, solutions
     CC-scored, then the assembly step: solution overlap, the C(n, 10)
     homomultimer ranking, up to 10 models CC-scored at 4 A;
  4. each kernel against its plain PyTorch version on the same CUDA
     tensors at the main path's shapes, with the tolerance of its tests,
     and both timed with CUDA events;
  5. timed pass of the main path (after one more warm pass) with every
     launch counter reset first;
     fails unless every kernel of the path launched, the solutions are
     finite, at least 9 of 10 copies are recovered (best CA-RMSD < 10 A)
     and at least one model comes back, with a finite CCC, its first
     model made of 10 distinct solutions;
  6. the same assembly on the same solutions with the plain versions
     swapped in on the card: the same tuples and model components, model
     CCCs within 1e-5, the overlap within its tolerance (K9's atomics
     round in another order: testing.overlap_tolerance);
  7. a heteromer ranking (16^5 tuples over 80 solutions, seeded random
     overlap) with the counters reset first: K20 must launch, and the
     plain version on the card must give the same tuples;
  8. a small two-copy fit through the card and through the CPU (plain
     versions) must recover the same copies at the same poses, and the
     assembly of the card's solutions on the card and on the CPU must
     agree as in phase 6.
The last three lines are the kernel report (JSON), the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import contextlib
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
MAX_MODELS, MAX_OVERLAP = 10, 0.1   # bench.py's score_models arguments
CCC_TOL = 1e-5                  # model CCC, kernels vs plain / card vs CPU
K9_REL = 1e-5                   # K9 vs plain, of the grid's max
HETERO = dict(n_per=16, n_groups=5, seed=12)
ASSEMBLY_STAGES = ("overlap", "enumerate", "score_models")


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
    """bench.py's run_fit through the port: describe, dock, and the
    assembly step when there are two solutions or more."""
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
    assembly = None
    if len(sols) >= 2:
        assembly = run_assembly(device, timings, cfg,
                                [s.structure for s in sols], dmap, n_copies)
    return dict(copies=copies, dmap=dmap, moved=moved, map_set=map_set,
                sub_set=sub_set, sols=sols, assembly=assembly)


def run_assembly(device, timings, cfg, structures, dmap, n_copies):
    """bench.py:69-83: overlap, homomultimer ranking, model scores."""
    from mad_tpu_torch.engine import assemble as asm
    from mad_tpu_torch.timing import stage
    with stage(timings, "overlap", device):
        overlap = asm.solution_overlap(structures, cfg.assembly, device)
    with stage(timings, "enumerate", device):
        tuples, sums, stds, maxs = asm.enumerate_homomultimer(
            len(structures), min(n_copies, len(structures)), overlap,
            device=device)
    with stage(timings, "score_models", device):
        models = asm.score_models(tuples, sums, stds, maxs, structures,
                                  dmap, cfg.assembly, MAX_MODELS,
                                  MAX_OVERLAP)
    asm.pop_enum_notes()
    return dict(structures=structures, overlap=overlap, tuples=tuples,
                models=models)


@contextlib.contextmanager
def plain_versions():
    """Swap the plain PyTorch versions in for the kernels the assembly
    step launches (K1 blur, K9, K18, K19, K20), on whatever device."""
    import mad_tpu_torch.ops.convolve as convolve
    from mad_tpu_torch.kernels import (conv1d, enumerate as k_enum, hetero,
                                       overlap, scatter)
    swaps = [(convolve, "conv1d_along", conv1d.conv1d_along_plain),
             (scatter, "scatter_atoms", scatter.scatter_atoms_plain),
             (overlap, "pack_overlap", overlap.pack_overlap_plain),
             (k_enum, "enumerate_head", k_enum.enumerate_head_plain),
             (hetero, "hetero_head", hetero.hetero_head_plain)]
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
    out.update(assembly_kernel_checks(fit, cfg, device))
    return out


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


def assembly_kernel_checks(fit, cfg, device):
    """K9, K18, K19 at the shapes of the fit's assembly step and K20 at
    16^5; K9 within K9_REL of the grid's max, the others equal."""
    import torch
    from mad_tpu_torch.engine import assemble as asm
    from mad_tpu_torch.kernels import enumerate as k_enum
    from mad_tpu_torch.kernels import hetero, overlap, scatter
    from mad_tpu_torch.ops.simulate import scatter_args

    out = {}
    a = fit["assembly"]
    check(a is not None and a["models"], "the warm pass built no model")
    structures = a["structures"]
    n = len(structures)
    cb, mb = asm.atom_batch([[structures[i] for i in m.components]
                             for m in a["models"]])
    sb, sm = asm.atom_batch([[s] for s in structures])
    for label, (c, w, voxsp) in (("models", (cb, mb, fit["dmap"].voxsp)),
                                 ("solutions", (sb, sm,
                                                cfg.assembly.sim_voxsp))):
        args = scatter_args(c, w, voxsp, device)
        g1 = scatter.scatter_atoms(*args)
        g2 = scatter.scatter_atoms_plain(*args)
        err, scale = float((g1 - g2).abs().max()), float(g2.abs().max())
        check(err <= K9_REL * scale, f"K9 {label}: max error {err} > "
              f"{K9_REL} * {scale}")
        res = (err, cuda_ms(lambda: scatter.scatter_atoms(*args)),
               cuda_ms(lambda: scatter.scatter_atoms_plain(*args)))
        say(f"  K9 {label}: {c.shape[0]} x {c.shape[1]} atoms into "
            f"{tuple(g1.shape[1:])}, max abs err {err:g} of {scale:g}, "
            f"kernel {res[1]:.3f} ms, plain {res[2]:.3f} ms")
        if label == "models":
            out["scatter_atoms"] = res
        del g1, g2

    dens, off, frame = asm.overlap_inputs(structures, cfg.assembly, device)
    o1 = overlap.pack_overlap(dens, off, frame)
    o2 = overlap.pack_overlap_plain(dens, off, frame)
    check(torch.equal(o1, o2), "K18 overlap differs from the plain version")
    out["pack_overlap"] = (float((o1 - o2).abs().max()),
                           cuda_ms(lambda: overlap.pack_overlap(
                               dens, off, frame)),
                           cuda_ms(lambda: overlap.pack_overlap_plain(
                               dens, off, frame)))
    say(f"  K18: {n} solutions, boxes {tuple(dens.shape[1:])}, frame "
        f"{frame}")

    k = min(N_COPIES, n)
    sym = asm._sym(a["overlap"], n, device)
    tab = torch.as_tensor(k_enum.comb_table(n, k), device=device)
    e1 = k_enum.enumerate_head(sym, tab, 256)
    e2 = k_enum.enumerate_head_plain(sym, tab, 256)
    check(torch.equal(e1, e2), "K19 head differs from the plain version")
    out["enumerate_head"] = (
        float(np.abs(k_enum.split_keys(e1)[1]
                     - k_enum.split_keys(e2)[1]).max()),
        cuda_ms(lambda: k_enum.enumerate_head(sym, tab, 256)),
        cuda_ms(lambda: k_enum.enumerate_head_plain(sym, tab, 256)))
    say(f"  K19: C({n}, {k}) ranks, head {len(e1)}")

    ov, groups = hetero_problem()
    sym = asm._sym(ov, ov.shape[0], device)
    lists = torch.as_tensor(np.asarray(list(groups.values())),
                            dtype=torch.int32, device=device)
    sizes = [len(g) for g in groups.values()]
    h1 = hetero.hetero_head(sym, lists, sizes, 256)
    h2 = hetero.hetero_head_plain(sym, lists, sizes, 256)
    check(torch.equal(h1, h2), "K20 head differs from the plain version")
    out["hetero_head"] = (
        float(np.abs(k_enum.split_keys(h1)[1]
                     - k_enum.split_keys(h2)[1]).max()),
        cuda_ms(lambda: hetero.hetero_head(sym, lists, sizes, 256)),
        cuda_ms(lambda: hetero.hetero_head_plain(sym, lists, sizes, 256)))
    say(f"  K20: {int(np.prod(sizes))} tuples over {ov.shape[0]} "
        f"solutions, head {len(h1)}")
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


# -- phase 7: heteromer ranking ---------------------------------------------

def hetero_phase(device):
    """enumerate_heteromer on hetero_problem(), its counters reset just
    before; the same call with the plain versions swapped in must give the
    same tuples. Returns K20's launch count."""
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
    with plain_versions():
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


# -- phase 8: small reference ---------------------------------------------

def small_reference(device, cfg):
    import dataclasses
    from mad_tpu_torch.testing import overlap_tolerance
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
    a = card["assembly"]
    check(a is not None and a["models"],
          "small reference: the card built no model")
    h = run_assembly("cpu", None, small_cfg, a["structures"],
                     card["dmap"].to("cpu"), SMALL["n_copies"])
    tol = np.maximum(
        overlap_tolerance(a["structures"], cfg.assembly, device),
        overlap_tolerance(a["structures"], cfg.assembly, "cpu"))
    e_ov, e_ccc = compare_assemblies(a, h, tol, "small reference assembly")
    say(f"small reference assembly: {len(a['models'])} model(s) "
        f"{[m.components for m in a['models']]}, card and CPU agree "
        f"(overlap max diff {e_ov:g}, CCC max diff {e_ccc:g})")


# -- main -----------------------------------------------------------------


def main():
    import torch
    import mad_tpu_torch  # noqa: F401  (the port must be beside the script)
    device, smi = device_phase()
    build_phase()
    from mad_tpu_torch.kernels import KERNELS, launch_counts, reset_launches
    from mad_tpu_torch.testing import overlap_tolerance

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
    # Warm again: the plain versions of the checks leave the allocator
    # holding other block sizes than the fit's.
    run_fit(device, None, cfg)

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
        f"{k} {v:.4f}" for k, v in timings.items()))
    say(f"peak device memory: {peak / 2**30:.3f} GiB")
    say(f"launches: {counts}")
    say(f"{len(sols)} solutions, {found}/{N_COPIES} subunits recovered, "
        f"median best CA-RMSD {np.median(rmsds):.3f} A")
    main_path = [n for n in KERNELS if n != "hetero_head"]
    check(all(counts[n] > 0 for n in main_path),
          f"a kernel of the main path never launched: {counts}")
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

    # Phase 6: the same assembly with the plain versions on the card.
    plain_t = {}
    before = launch_counts()
    with plain_versions():
        p = run_assembly(device, plain_t, cfg, a["structures"], fit["dmap"],
                         N_COPIES)
    check(launch_counts() == before,
          "a kernel launched with the plain versions swapped in")
    tol = overlap_tolerance(a["structures"], cfg.assembly, device)
    e_ov, e_ccc = compare_assemblies(a, p, tol, "kernels vs plain")
    say("assembly with the kernels " + ", ".join(
        f"{k} {timings[k]:.4f}" for k in ASSEMBLY_STAGES) + " s; plain "
        + ", ".join(f"{k} {plain_t[k]:.4f}" for k in ASSEMBLY_STAGES)
        + f" s; same tuples and models (overlap max diff {e_ov:g}, CCC "
        f"max diff {e_ccc:g})")
    del fit, a, p
    torch.cuda.empty_cache()

    counts["hetero_head"] = hetero_phase(device)
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
