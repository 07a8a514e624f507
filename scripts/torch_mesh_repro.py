#!/usr/bin/env python3
"""Two reproducibility facts behind the port's checks of its mesh runs, on
one NVIDIA card.

    python3 scripts/torch_mesh_repro.py

1. Row blocks of the similarity product, at the bench's shapes (366
   subunit rows, 4,588 map rows, 1,024 bins; unit rows from a numpy
   seed): each block of 2, 3, 4 and 8 shards multiplied alone
   (``torch.matmul``, TF32 off) against the same rows of the whole
   product, and the block in a zero frame of all the rows, as
   ``engine.match.match_pairs(mesh=)`` takes it.
2. K9's determinism: the bench subunit (copy 0 of chip_smoke.py's
   ``make_assembly``, decoy-transformed) simulated eight times at 10 A
   and 1.4 A: how many of the seven re-simulations differ from the first,
   and by how much (K9 adds in a fixed order, so none should);
   ``describe_grid`` of the first and of one that differs from it (the
   second when none does), equal or not; and of the first in capacity
   mode on 2, 3 and 4 shards of the card against its single-device
   ``DescriptorSet``.
Prints the card's name and power limit first.
"""

import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def row_blocks(device, dh=366, dl=4588, bins=1024, seed=0):
    import torch
    from mad_tpu_torch.parallel.mesh import shard_bounds
    rng = np.random.default_rng(seed)
    hi, lo = (rng.random((n, bins)).astype(np.float32) for n in (dh, dl))
    hi /= np.linalg.norm(hi, axis=1, keepdims=True)
    lo /= np.linalg.norm(lo, axis=1, keepdims=True)
    h, lo_t = (torch.as_tensor(a, device=device) for a in (hi, lo))
    whole = h @ lo_t.T
    for n in (2, 3, 4, 8):
        b = shard_bounds(dh, n)
        alone, framed = [], []
        for s in range(n):
            rows = slice(b[s], b[s + 1])
            alone.append(float((h[rows] @ lo_t.T - whole[rows]).abs().max()))
            frame = torch.zeros_like(h)
            frame[rows] = h[rows]
            framed.append(torch.equal((frame @ lo_t.T)[rows], whole[rows]))
        print(f"{dh} x {dl} x {bins}, {n} blocks: alone, largest difference "
              f"from the whole product's rows {max(alone):g} (blocks "
              f"{[f'{x:g}' for x in alone]}); in a zero frame equal "
              f"{all(framed)}", flush=True)


def k9_runs(device):
    import torch
    from mad_tpu_torch.engine.pipeline import describe_grid
    from mad_tpu_torch.ops.simulate import simulate_density
    from mad_tpu_torch.parallel.mesh import make_mesh
    from mad_tpu_torch.testing import decoy_transform, make_assembly
    cfg = cs.bench_config()
    _sub, copies = make_assembly(n_copies=cs.N_COPIES, n_res=cs.N_RES,
                                 seed=cs.SEED, spread=cs.SPREAD, shell=True)
    moved = decoy_transform(copies[0])
    grids = [simulate_density(moved, cs.RES, cs.VOXSP, device=device,
                              shape_bucket=cfg.shape_bucket)
             for _ in range(8)]
    diff = max(float((grids[0].data - g.data).abs().max())
               for g in grids[1:])
    equal = [torch.equal(grids[0].data.view(torch.int32),
                         g.data.view(torch.int32)) for g in grids[1:]]
    print(f"subunit density {tuple(grids[0].data.shape)}, 8 simulations: "
          f"{equal.count(False)} of {len(equal)} re-simulations differ from "
          f"the first (bit for bit: {equal}), largest difference {diff:g} "
          f"(of a max of {float(grids[0].data.max()):g})", flush=True)
    second = next((g for g in grids[1:]
                   if not torch.equal(g.data, grids[0].data)), grids[1])
    one = describe_grid(grids[0], cfg, name="s", device=device)
    other = describe_grid(second, cfg, name="s", device=device)
    print(f"describe_grid of the first and of a "
          f"{'differing' if second is not grids[1] or diff else 'second'} "
          f"simulation: {one.n} / {other.n} rows, equal "
          f"{cs.same_set(one, other)}", flush=True)
    for n in (2, 3, 4):
        got = describe_grid(grids[0], cfg, name="s",
                            mesh=make_mesh(n, devices=[device] * n))
        print(f"describe_grid of one simulation on {n} shards: equal to "
              f"the single-device set {cs.same_set(got, one)}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_repro: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    device = torch.device("cuda:0")
    row_blocks(device)
    k9_runs(device)


if __name__ == "__main__":
    main()
