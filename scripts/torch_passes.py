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
``--match-breakdown`` instead profiles one warm dock_structure and reads
the program's own spans of the match stage, with the kernels and then
with the matching front's plain versions. Needs a card; prints the card's
name and power limit first.
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


def match_breakdown(device, cfg):
    """One warm dock_structure of the bench fit under torch.profiler, per
    span of its match stage (the program's own ``match.*`` spans,
    ``mad_tpu_torch.utils.profiling``): the host wall ms (the pulls in a
    span wait for the card; the rest is enqueue and host work) and the
    device ms of the kernels launched inside it; the span's counts. First
    with the kernels, then with the matching front's plain versions
    swapped in."""
    fit = cs.run_fit(device, None, cfg)
    for label, swaps in (("kernels", []), ("plain versions of K10's head, "
                                           "K11, K12, K14", cs.match_swaps())):
        with cs.plain_versions(swaps):
            _breakdown(device, cfg, fit, label)


def _breakdown(device, cfg, fit, label):
    from torch.profiler import ProfilerActivity, profile
    from mad_tpu_torch.engine import docking
    from mad_tpu_torch.utils import profiling

    def dock():
        return docking.dock_structure(
            fit["map_set"], fit["sub_set"], fit["moved"], fit["dmap"],
            cs.RES, cfg, verbose=False, n_copies=cs.N_COPIES, device=device)

    dock()                                        # warm
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sols = dock()
    kernel = {e.key[len("mad."):]: e.device_time_total / 1e3
              for e in prof.key_averages() if e.key.startswith("mad.")}
    wall, counts = {}, {}
    for r in profiling.spans():
        if r.name.startswith("match"):
            wall[r.name] = wall.get(r.name, 0.0) + (r.end_ns
                                                    - r.start_ns) / 1e6
            counts.setdefault(r.name, r.counts)
    profiling.clear_spans()
    cs.say(f"match breakdown with the {label}: {len(sols)} solutions")
    cs.say("  span: host wall ms | kernel ms | counts (the first round's)")
    for name in wall:
        cs.say(f"  {name}: {wall[name]:.3f} | {kernel.get(name, 0.0):.3f} "
               f"| {counts[name]}")
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
