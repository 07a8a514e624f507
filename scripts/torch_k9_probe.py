#!/usr/bin/env python3
"""Where the simulation body's time goes at the bench models' batch, on
one NVIDIA card.

    python3 scripts/torch_k9_probe.py

Runs chip_smoke.py's bench fit once, takes score_models' batch (10 models
of 10,400 atoms into 288x256x288) and times, with CUDA events (mean of
ten after a warm call):
  * K9 on the batch, on the same atoms with every mass zero (every tile
    empty: the zeros alone), and a memset of the same grids (zero_());
  * K9's launches by name under torch.profiler (device time);
  * K1's three 'full' blur passes of the batch without and with their
    epilogues (the x pass dividing by the grids' maxima, the z pass
    taking the blurred maxima) and the closing scale-and-clamp pass.
Prints the card's name and power limit first. Needs a card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def tiles_with_atoms(coords, masses, vox_min, box, margin, voxsp):
    """(tiles whose own or upper neighbours' bins hold an atom, tiles):
    the tiles K9 gathers, sorts and sums rather than zeroes."""
    import itertools
    import torch
    from mad_tpu_torch.kernels import scatter
    dev = coords.device
    dims = torch.as_tensor(box, device=dev)
    tile = torch.as_tensor(scatter.TILE, device=dev)
    g = margin + (coords - vox_min[:, None, :]) / torch.tensor(
        voxsp, dtype=torch.float32, device=dev)
    f = torch.floor(g)
    keep = (masses != 0) & ((f >= -1) & (f <= dims - 1)).all(dim=-1)
    s = torch.arange(masses.shape[0], device=dev)[:, None].expand_as(
        masses)[keep]
    b = (f[keep].long() + 1) // tile
    n_tiles = [-(-int(d) // t) for d, t in zip(box, scatter.TILE)]
    held = torch.zeros([masses.shape[0]] + [n + 1 for n in n_tiles],
                       dtype=torch.bool, device=dev)
    held[s, b[:, 0], b[:, 1], b[:, 2]] = True
    busy = torch.zeros_like(held[:, :-1, :-1, :-1])
    for i, j, k in itertools.product((0, 1), repeat=3):
        busy |= held[:, i:i + n_tiles[0], j:j + n_tiles[1],
                     k:k + n_tiles[2]]
    return f"{int(busy.sum())} of {busy.numel()}"


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mad_tpu_torch.kernels import conv1d, maxkey, scatter
    from mad_tpu_torch.ops import simulate
    from mad_tpu_torch.testing import recording

    device, _smi = cs.device_phase()
    cs.build_phase()
    cfg = cs.bench_config()
    with recording(simulate, "_simulate_batch") as sims:
        cs.run_fit(device, None, cfg)
    # score_models' call: the scatter's arguments and the blur's taps
    args, taps = sims[-1][:6], sims[-1][6]
    del sims
    ms = lambda fn: cs.cuda_ms(fn, reps=10)
    M, N = args[1].shape
    gmax = maxkey.new_keys(M, device)
    grids = scatter.scatter_atoms(*args, max_into=gmax)
    cs.say(f"K9 on {M} x {N} atoms into {tuple(args[3])}: "
           f"{int((grids != 0).sum())} voxels not zero; "
           f"{tiles_with_atoms(*args)} of its voxel tiles hold atoms")
    empty = list(args)
    empty[1] = torch.zeros_like(args[1])
    buf = torch.empty_like(grids)
    k9 = ms(lambda: scatter.scatter_atoms(*args))
    k9_empty = ms(lambda: scatter.scatter_atoms(*empty))
    cs.say(f"  K9 {k9:.4f} ms, every mass zero {k9_empty:.4f} ms, zero_() "
           f"of the grids {ms(buf.zero_):.4f} ms")
    del buf
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            scatter.scatter_atoms(*args)
        torch.cuda.synchronize()
    cs.say(prof.key_averages().table(sort_by="device_time_total",
                                     row_limit=8))
    conv = conv1d.conv1d_along
    x = conv(grids, taps, 0, "full", divide_by=gmax)
    y = conv(x, taps, 1, "full")
    dmax = maxkey.new_keys(M, device)
    z = conv(y, taps, 2, "full", max_into=dmax)
    times = [("x pass", lambda: conv(grids, taps, 0, "full")),
             ("x pass dividing", lambda: conv(grids, taps, 0, "full",
                                             divide_by=gmax)),
             ("y pass", lambda: conv(x, taps, 1, "full")),
             ("z pass", lambda: conv(y, taps, 2, "full")),
             ("z pass with its max", lambda: conv(y, taps, 2, "full",
                                                 max_into=dmax)),
             ("scale-and-clamp", lambda: scatter.scale_clamp(z, dmax, 0.0))]
    cs.say(f"  K1's blur ({len(taps)} taps) and the closing pass: "
           + ", ".join(f"{name} {ms(fn):.4f} ms" for name, fn in times))


if __name__ == "__main__":
    main()
