#!/usr/bin/env python3
"""Interleaved timing of the port's fit on one NVIDIA card, with the
kernels against their plain PyTorch versions, plus a profiled pass, a
host profile of the MaD session and a per-op breakdown of the match stage.

    python3 scripts/torch_passes.py [--pairs 5] [--match-breakdown]

Runs chip_smoke.py's bench fit (the whole of bench.py:run_fit through
mad_tpu_torch): one warm pass, then ``--pairs`` pairs of timed passes in
ABBA order (kernels, plain, plain, kernels, ...), where "plain" swaps the
plain versions of ``chip_smoke.fit_swaps()`` in (the describe stage's K2,
K3, K5, K8, then K6, K15, the matching front: K10's head, K11, K12, K14,
and K16, K17); prints each pass's stage seconds (the docking's ``post``
stage included) and the per-stage median and
minimum of each side. Then one pass under torch.profiler (device time,
kernel launches, idle share of the pass) and the session phase's two runs
under cProfile (the top functions of each by cumulative host time).
``--match-breakdown`` instead profiles one warm dock_structure with the
match stage cut into spans (``SPANS``), with the kernels and then with the
matching front's plain versions. Needs a card; prints the card's name and
power limit first.
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def timed_pass(device, cfg, plain):
    import torch
    t = {}
    swaps = cs.fit_swaps() if plain else []
    with cs.plain_versions(swaps):
        t0 = time.perf_counter()
        fit = cs.run_fit(device, t, cfg)
        torch.cuda.synchronize()
        t["fit"] = time.perf_counter() - t0
    found = int(np.sum(np.asarray(cs.best_rmsds(
        [s.structure for s in fit["sols"]], fit["copies"])) < cs.RECOVER_RMSD))
    cs.check(found >= cs.MIN_RECOVERED, f"only {found} copies recovered")
    return t


def profiled_pass(device, cfg):
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.run_fit(device, None, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(getattr(e, "device_time", 0.0) for e in events)
    cs.say(f"profiled pass: {wall:.3f} s wall, {dev_us / 1e3:.1f} ms device "
           f"time, {len(events)} device events, idle "
           f"{1 - dev_us / 1e6 / wall:.1%} of the pass")
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=16)
    cs.say(table)


def session_profile(device, cfg):
    """The session phase's runs under cProfile."""
    import tempfile
    prof = cProfile.Profile()
    fit = cs.run_fit(device, None, cfg)
    with tempfile.TemporaryDirectory(prefix="mad_passes_") as root:
        prof.enable()
        cs.session_phase(device, cfg, fit, root)
        prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(30)
    cs.say(out.getvalue())


SPANS = ("match.1_product", "match.2_head", "match.3_pose",
         "match.4_field", "match.5_approx", "match.6_exact", "match.7_order")


def _spanned_match(times):
    """engine.match.match_descriptors step by step, each sub-step in a
    torch.profiler span that ends in a synchronize (so its host wall time
    is its own), the wall seconds collected in ``times``. The kernels are
    looked up on engine.match, so that swapped-in plain versions run."""
    import contextlib
    import torch
    from torch.profiler import record_function
    from mad_tpu_torch.core.config import bucket
    from mad_tpu_torch.engine import match as em

    @contextlib.contextmanager
    def span(name, device):
        t0 = time.perf_counter()
        with record_function(name):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0

    def run(map_set, sub_set, grid_shape, grid_origin, voxsp, cfg,
            min_exact=0, device=None):
        device = torch.device(device)
        with span(SPANS[0], device):
            sim = sub_set.desc_norm @ map_set.desc_norm.T
        with span(SPANS[1], device):
            keys = em.pair_head(sim, cfg.row_cap, cfg.max_pairs,
                                float(cfg.cc_threshold))
            ccs, rows, cols = em.split_pair_keys(keys.cpu().numpy(),
                                                 sim.shape[1])
        with span(SPANS[2], device):
            hi_cloud = np.unique(sub_set.subv_coords[rows], axis=0)
            lo_cloud = np.unique(map_set.subv_coords[cols], axis=0)
            rot = np.einsum("pji,pjk->pik", map_set.rfinal[cols],
                            sub_set.rfinal[rows])
            hi_coord = sub_set.subv_coords[rows]
            lo_coord = map_set.subv_coords[cols]
            lo_vox_d = torch.as_tensor(em.anchor_voxels(
                lo_cloud, grid_origin, voxsp, grid_shape), device=device)
            hi_cloud_d = em._f32(hi_cloud, device)
            lo_cloud_d = em._f32(lo_cloud, device)
            rot_d, hc_d, lc_d = (em._f32(rot, device),
                                 em._f32(hi_coord, device),
                                 em._f32(lo_coord, device))
        r_vox = max(1, int(round(cfg.anchor_dist / voxsp)))
        with span(SPANS[3], device):
            field = em.anchor_field(tuple(grid_shape), lo_vox_d, r_vox)
        with span(SPANS[4], device):
            rep = em.approx_repeat(
                field, lo_vox_d, r_vox, hi_cloud_d,
                em._f32(grid_origin, device),
                float(np.float32(1.0 / voxsp)), rot_d, hc_d,
                lc_d).cpu().numpy()
        with span(SPANS[5], device):
            want = max(cfg.exact_top, min_exact)
            n_use = min(bucket(want, 64), len(rows))
            top = np.argsort(-rep, kind="stable")[:n_use]
            top_d = torch.as_tensor(top, device=device)
            rep[top] = em.exact_repeat(
                hi_cloud_d, lo_cloud_d, rot_d[top_d], hc_d[top_d],
                lc_d[top_d], float(cfg.anchor_dist)).cpu().numpy()
        with span(SPANS[6], device):
            order = np.argsort(-rep, kind="stable")
            table = em.MatchTable(
                cc=ccs[order], repeat=rep[order], hi_idx=rows[order],
                lo_idx=cols[order], rot=rot[order],
                hi_coord=hi_coord[order], lo_coord=lo_coord[order],
                hi_cloud=hi_cloud, lo_cloud=lo_cloud)
        times["counts"] = dict(dh=int(sim.shape[0]), dl=int(sim.shape[1]),
                               P=int(len(rows)),
                               A_hi=int(hi_cloud.shape[0]),
                               A_lo=int(lo_cloud.shape[0]), n_exact=n_use)
        return table

    return run


def match_breakdown(device, cfg):
    """One warm dock_structure of the bench fit under torch.profiler, its
    match stage split into the SPANS sub-steps: per span the host wall
    seconds (each span ends in a synchronize), the device time of the
    kernels launched inside it and its extent on the device's timeline;
    the bench's counts. First with the kernels, then with the matching
    front's plain versions swapped in."""
    fit = cs.run_fit(device, None, cfg)
    for label, swaps in (("kernels", []), ("plain versions of K10's head, "
                                           "K11, K12, K14", cs.match_swaps())):
        with cs.plain_versions(swaps):
            _breakdown(device, cfg, fit, label)


def _breakdown(device, cfg, fit, label):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mad_tpu_torch.engine import docking
    n_samples = cfg.filter.n_samples * cs.N_COPIES
    saved = docking.match_descriptors

    def dock(times, timings):
        docking.match_descriptors = _spanned_match(times)
        try:
            return docking.dock_structure(
                fit["map_set"], fit["sub_set"], fit["moved"], fit["dmap"],
                cs.RES, cfg, verbose=False,
                n_copies=cs.N_COPIES, device=device,
                timings=timings)
        finally:
            docking.match_descriptors = saved

    dock({}, {})                                  # warm
    times, timings = {}, {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sols = dock(times, timings)
    # A span has two rows: the host-side one, whose device time is that of
    # the kernels launched inside it, and the device-side annotation, whose
    # own time is the span's extent on the device's timeline.
    busy, extent = {}, {}
    for e in prof.key_averages():
        if e.key not in SPANS:
            continue
        if e.device_type == torch.autograd.DeviceType.CPU:
            busy[e.key] = e.device_time_total / 1e3
        else:
            extent[e.key] = e.self_device_time_total / 1e3
    cs.say(f"match breakdown with the {label}: counts {times['counts']}, "
           f"n_scan {min(n_samples, times['counts']['P'])}; {len(sols)} "
           "solutions")
    cs.say("  span: host wall ms (sync at its end) | kernel ms | extent on "
           "the device ms")
    for name in SPANS:
        cs.say(f"  {name}: {times.get(name, 0.0) * 1e3:.3f} | "
               f"{busy.get(name, 0.0):.3f} | {extent.get(name, 0.0):.3f}")
    cs.say("  stages (s, under the profiler): " + ", ".join(
        f"{k} {v:.4f}" for k, v in timings.items()))
    cs.say(prof.key_averages().table(sort_by="device_time_total",
                                     row_limit=15))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--match-breakdown", action="store_true",
                    help="only the per-op breakdown of the match stage")
    args = ap.parse_args()
    device, _smi = cs.device_phase()
    cs.build_phase()
    cfg = cs.bench_config()
    if args.match_breakdown:
        cs.say(f"numpy {np.__version__}")
        match_breakdown(device, cfg)
        return
    timed_pass(device, cfg, False)
    timed_pass(device, cfg, True)
    runs = {False: [], True: []}
    for i in range(args.pairs):
        for plain in ((False, True) if i % 2 == 0 else (True, False)):
            t = timed_pass(device, cfg, plain)
            runs[plain].append(t)
            cs.say(("plain " if plain else "kernel ") + ", ".join(
                f"{k} {v:.4f}" for k, v in t.items()))
    cs.say("stage: kernels median (min) | plain versions median (min), s")
    for k in runs[False][0]:
        a = [t[k] for t in runs[False]]
        b = [t.get(k, 0.0) for t in runs[True]]
        cs.say(f"  {k}: {np.median(a):.4f} ({min(a):.4f}) | "
               f"{np.median(b):.4f} ({min(b):.4f})")
    profiled_pass(device, cfg)
    session_profile(device, cfg)


if __name__ == "__main__":
    main()
