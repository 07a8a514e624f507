#!/usr/bin/env python3
"""Interleaved timing of the port's fit on one NVIDIA card, with K6 and
K15 against their plain PyTorch versions, plus a profiled pass and a
host profile of the MaD session.

    python3 scripts/torch_passes.py [--pairs 5]

Runs chip_smoke.py's bench fit (the whole of bench.py:run_fit through
mad_tpu_torch): one warm pass, then ``--pairs`` pairs of timed passes in
ABBA order (kernels, plain, plain, kernels, ...), where "plain" swaps K6
and K15's plain versions in; prints each pass's stage seconds and the
per-stage median and minimum of each side. Then one pass under
torch.profiler (device time, kernel launches, idle share of the pass)
and the session phase's two runs under cProfile (the top functions of
each by cumulative host time). Needs a card; prints the card's name and
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
    swaps = cs.orient_refine_swaps() if plain else []
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
                                      row_limit=12)
    cs.say(table)


def session_profile(device, cfg):
    """The session phase's runs under cProfile."""
    prof = cProfile.Profile()
    fit = cs.run_fit(device, None, cfg)
    prof.enable()
    cs.session_phase(device, cfg, fit)
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(30)
    cs.say(out.getvalue())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()
    device, _smi = cs.device_phase()
    cs.build_phase()
    cfg = cs.bench_config()
    timed_pass(device, cfg, False)
    timed_pass(device, cfg, True)
    runs = {False: [], True: []}
    for i in range(args.pairs):
        for plain in ((False, True) if i % 2 == 0 else (True, False)):
            t = timed_pass(device, cfg, plain)
            runs[plain].append(t)
            cs.say(("plain " if plain else "kernel ") + ", ".join(
                f"{k} {v:.4f}" for k, v in t.items()))
    cs.say("stage: kernels median (min) | plain K6/K15 median (min), s")
    for k in runs[False][0]:
        a = [t[k] for t in runs[False]]
        b = [t.get(k, 0.0) for t in runs[True]]
        cs.say(f"  {k}: {np.median(a):.4f} ({min(a):.4f}) | "
               f"{np.median(b):.4f} ({min(b):.4f})")
    profiled_pass(device, cfg)
    session_profile(device, cfg)


if __name__ == "__main__":
    main()
