#!/usr/bin/env python3
"""Write the port's witness of the bench on one NVIDIA card.

    python3 scripts/torch_witness.py [--out PATH] [--commit TEXT]

bench.py's fit through mad_tpu_torch on cuda:0 (``testing.build_system``
and ``fit_pass`` at ``MadConfig()`` with one rescue round), the fit's
sets docked once more with a matching cache to keep the match table
(``dock_structure(match_cache=)``; the dock must give the fit's solutions
bit for bit), K12 over every pair of that table, and mad_tpu's ensemble
bench (``testing.run_ensemble_bench``). Their record
(``mad_tpu_torch.witness``) goes to PATH as JSON (by default
tests/torch_witness/bench_h100.json, which chip_smoke.py and
tests/test_torch_bench_parity_slow.py read), with the card's name and
power limit as nvidia-smi prints them and ``--commit`` (the tree the run
came from; a copy of the repository without git cannot tell).
"""

import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_COPIES, RES = 10, 10.0


def record(device, n_copies=N_COPIES, n_res=260, spread=115.0) -> dict:
    """The fit's and the ensemble's records on ``device`` (the module
    docstring); smaller systems than the bench's for a rehearsal."""
    import dataclasses
    import torch
    from mad_tpu_torch import cache
    from mad_tpu_torch import witness as W
    from mad_tpu_torch.core.config import MadConfig
    from mad_tpu_torch.engine.docking import dock_structure
    from mad_tpu_torch.testing import build_system, fit_pass, \
        run_ensemble_bench
    cfg = MadConfig()
    cfg = cfg.replace(filter=dataclasses.replace(cfg.filter,
                                                 rescue_rounds=1))
    n_rows = cfg.filter.n_samples * n_copies
    t0 = time.perf_counter()
    sub, copies, dmap = build_system(n_copies, n_res, spread=spread,
                                     device=device)
    fit = fit_pass(sub, copies, dmap, RES, cfg, device=device)
    with tempfile.TemporaryDirectory(prefix="witness_") as work:
        path = cache.matching_filename(work, "bench_sub",
                                       cfg.match.cc_threshold,
                                       cfg.filter.weight_threshold, n_rows)
        sols = dock_structure(fit["map_set"], fit["sub_set"], fit["moved"],
                              dmap, RES, cfg, n_copies, False, path,
                              device=device)
        table = cache.load_matching(path)
    if len(sols) != len(fit["sols"]) or not all(
            np.array_equal(a.structure.coords, b.structure.coords)
            for a, b in zip(sols, fit["sols"])):
        raise SystemExit("torch_witness: the dock with a matching cache "
                         "gave other solutions than the fit")
    approx = W.approx_all(table, dmap, cfg.match, device)
    fit_rec = W.fit_record(dmap, fit["map_set"], fit["sub_set"], table,
                           n_rows, fit["sols"], fit["moved"], copies,
                           fit["models"], approx)
    print(f"fit: {time.perf_counter() - t0:.2f} s, {table.n} pairs, "
          f"{len(fit['sols'])} solutions, {fit_rec['recovered']}/"
          f"{n_copies} recovered, {len(fit['models'])} models", flush=True)
    del fit, sols, table, dmap
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="witness_ens_") as work, \
            contextlib.redirect_stdout(io.StringIO()):
        r = run_ensemble_bench(work, n_copies, n_res, spread, device=device,
                               log=lambda line: None)
    ens = W.ensemble_record(r["rows"], r["mad"].solutions)
    print(f"ensemble: {time.perf_counter() - t0:.2f} s; "
          + ", ".join(f"{x[0]} RWmCC {x[4]:.4f} Weight {x[2]:.4f}"
                      for x in ens["rows"]), flush=True)
    return dict(fit=fit_rec, ensemble=ens)


def main():
    from mad_tpu_torch import witness as W
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=W.WITNESS)
    ap.add_argument("--commit", default="unknown")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_witness: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rec = record(torch.device("cuda:0"))
    W.dump(dict(card=smi, commit=args.commit,
                script="scripts/torch_witness.py", **rec), args.out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes", flush=True)


if __name__ == "__main__":
    main()
