"""Copied from mad_tpu/testing.py (``make_protein``, ``make_assembly``) and
mad_tpu/api.py (``_decoy_transform``, ``_np_axis_angle_mat``), numpy only.

Synthetic pseudo-proteins (ideal alpha-helix backbones bent by a random
walk) and homomultimer assemblies for tests and the chip smoke run, plus
the self-fit decoy transform. ``near_isovalue``, ``overlap_slack`` and
``overlap_tolerance`` are the port's own: the bound that two computations
of one solution set's overlap matrix are held to; so is ``pose_table``, a
synthetic match table for the pose clustering; ``post_scenario`` and
``post_round``, two docking rounds of refined lanes for the post-refine
merge; and ``recording``, which collects the inputs a call site on the
path gives a kernel.

The scenario helpers (``deform_structure``, ``make_symmetric_assembly``,
``degrade_map`` and the regime tables) are copied from
mad_tpu/testing.py:115-426; the runners ``run_degraded``, ``run_topology``
and ``run_knob_regime`` take mad_tpu's parameters and a keyword-only
``device`` and run the port's pipeline there. ``run_stress`` and
``run_ensemble_bench`` run mad_tpu's two large documented workloads
(scripts/stress_large.py, scripts/ensemble_bench.py) through the port,
over ``build_system`` (bench.py's) and ``fit_pass`` (its ``run_fit``,
whose assembly step is ``assemble_solutions``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .core.config import MadConfig
from .core.structure import ATOMIC_MASS, Structure
from .device import resolve

# Ideal helix parameters: rise 1.5 A / residue, 100 deg twist, radius 2.3 A.
_HELIX_RISE = 1.5
_HELIX_TWIST = np.deg2rad(100.0)
_HELIX_RADIUS = 2.3


def make_protein(n_res: int = 120, seed: int = 0, n_segments: int = 4
                 ) -> Structure:
    """Pseudo-protein: n_segments helical segments with random orientations.

    Backbone atoms (N, CA, C, O) per residue -> 4*n_res atoms.
    """
    rng = np.random.default_rng(seed)
    res_per_seg = max(4, n_res // n_segments)
    coords = []
    origin = np.zeros(3)
    for s in range(n_segments):
        # Random segment direction, mild continuation bias.
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        # Build helix along +z then rotate onto d.
        t = np.arange(res_per_seg) * _HELIX_TWIST
        z = np.arange(res_per_seg) * _HELIX_RISE
        ca = np.stack([_HELIX_RADIUS * np.cos(t),
                       _HELIX_RADIUS * np.sin(t), z], axis=-1)
        axis = np.cross([0.0, 0.0, 1.0], d)
        na = np.linalg.norm(axis)
        if na > 1e-8:
            axis = axis / na
            ang = np.arccos(np.clip(d[2], -1, 1))
            K = np.array([[0, -axis[2], axis[1]],
                          [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
        else:
            R = np.eye(3)
        ca = ca @ R.T + origin
        origin = ca[-1] + d * 3.0
        for c in ca:
            jitter = rng.normal(scale=0.3, size=(3, 3))
            coords.append(("N", c + np.array([-1.3, 0.2, -0.6]) + jitter[0]))
            coords.append(("CA", c))
            coords.append(("C", c + np.array([1.2, 0.4, 0.5]) + jitter[1]))
            coords.append(("O", c + np.array([1.6, 1.4, 0.3]) + jitter[2]))

    names = [n for n, _ in coords]
    xyz = np.array([p for _, p in coords], dtype=np.float64)
    elems = [n[0] for n in names]
    masses = np.array([ATOMIC_MASS[e] for e in elems], dtype=np.float32)
    ca_idx = np.array([i for i, n in enumerate(names) if n == "CA"])
    bb_idx = np.arange(len(names))
    info = [[i + 1, n, "ALA", "A", i // 4 + 1, n[0], "ATOM"]
            for i, n in enumerate(names)]
    return Structure(coords=xyz, masses=masses, ca_idx=ca_idx, bb_idx=bb_idx,
                     info=info, source=f"synthetic_seed{seed}")


def make_assembly(n_copies: int = 3, n_res: int = 100, seed: int = 0,
                  spread: float = 28.0, shell: bool = False):
    """One subunit replicated at n_copies random poses -> (subunit, copies).

    Poses sit on a ring (default) or a Fibonacci spherical shell
    (shell=True, fills a 3D volume) so copies touch but do not overlap,
    mimicking a homomultimer assembly.
    """
    rng = np.random.default_rng(seed)
    sub = make_protein(n_res=n_res, seed=seed)
    sub = sub.with_coords(sub.coords - sub.center())
    copies = []
    golden = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(n_copies):
        # Rotate each copy by a distinct random rotation.
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        if shell:
            zc = 1.0 - 2.0 * (i + 0.5) / n_copies
            r = np.sqrt(max(0.0, 1.0 - zc * zc))
            ang = golden * i
            t = spread * np.array([r * np.cos(ang), r * np.sin(ang), zc])
        else:
            ang = 2 * np.pi * i / n_copies
            t = spread * np.array([np.cos(ang), np.sin(ang),
                                   0.1 * rng.normal()])
        copies.append(sub.transformed(R, t))
    return sub, copies


def _np_axis_angle_mat(axis, angle):
    """Host-side Euler-Rodrigues matrix, same sign convention as
    core.geometry.axis_angle_mat."""
    axis = np.asarray(axis, dtype=np.float64)
    a = np.cos(angle / 2.0)
    b, c, d = -axis * np.sin(angle / 2.0)
    return np.array([
        [a*a + b*b - c*c - d*d, 2*(b*c + a*d), 2*(b*d - a*c)],
        [2*(b*c - a*d), a*a + c*c - b*b - d*d, 2*(c*d + a*b)],
        [2*(b*d + a*c), 2*(c*d - a*b), a*a + d*d - b*b - c*c]])


def decoy_transform(struct: Structure, t=(150.0, 0.0, 0.0), a=0.375,
                    b=1.735, c=2.452) -> Structure:
    """Move a pre-fitted subunit away from its deposited pose
    (parity: structure_utils.move_copy_structure, mad/structure_utils.py:30-56)."""
    coords = struct.coords @ _np_axis_angle_mat([1.0, 0, 0], a)
    coords = coords @ _np_axis_angle_mat([0.0, 1, 0], b)
    coords = coords @ _np_axis_angle_mat([0.0, 0, 1], c)
    coords = coords - coords.mean(axis=0) + np.asarray(t)
    return struct.with_coords(coords)


# -- scenario helpers (copied from mad_tpu/testing.py:115-426; the runners
# run the port's pipeline on ``device``) -------------------------------------

def deform_structure(struct, scale: float, seed: int):
    """Smooth low-frequency deformation (bend-like), magnitude ~scale A —
    the decoy-conformer model for ensemble tests/benches (the analog of
    the reference's GroEL conformer ladder, mad_utils.py:297)."""
    rng = np.random.default_rng(seed)
    c = struct.coords - struct.center()
    ext = np.abs(c).max()
    phase = rng.uniform(0, 2 * np.pi, 3)
    disp = np.stack([
        np.sin(c[:, 1] / ext * np.pi + phase[0]),
        np.sin(c[:, 2] / ext * np.pi + phase[1]),
        np.sin(c[:, 0] / ext * np.pi + phase[2]),
    ], axis=1) * scale
    return struct.with_coords(struct.coords + disp)


def _rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


_ROT_X_PI = np.diag([1.0, -1.0, -1.0])


def make_symmetric_assembly(kind: str, n: int, n_res: int = 120,
                            seed: int = 0, radius: float = 26.0,
                            ring_dz: float = 20.0, rise: float = 28.0,
                            twist: float = np.deg2rad(166.0)):
    """Assembly with TRUE symmetry-related copy orientations.

    Unlike make_assembly (random per-copy rotations), every copy here is a
    symmetry operation applied to the same placed subunit, so the local
    density environments of symmetry-related copies are near-identical:
    descriptor matches are degenerate across copies and pose clustering
    must disambiguate aliased poses — the reference's flagship regime
    (VAT C6 hexamer, the reference's run_MaD.py:24-27, GroEL D7 double ring
    notebook cells 24-27, actin:tropomyosin helical filament x5
    run_MaD.py:29-33).

    kind: 'cn'    — n copies on a Cn ring about z (copy_i = Rz(2*pi*i/n));
          'dn'    — 2n copies, Dn: a Cn ring at z=+ring_dz/2 plus its
                    image under the perpendicular C2 (Rx(pi));
          'helix' — n copies along a helical lattice
                    (copy_i = Rz(i*twist) + [0, 0, i*rise]).
    Returns (subunit, copies); the subunit is centered at the origin.
    """
    sub = make_protein(n_res=n_res, seed=seed)
    sub = sub.with_coords(sub.coords - sub.center())
    off = np.array([radius, 0.0, 0.0])
    copies = []
    if kind == "cn":
        for i in range(n):
            M = _rot_z(2.0 * np.pi * i / n)
            copies.append(sub.transformed(M.T, M @ off))
    elif kind == "dn":
        up = np.array([0.0, 0.0, ring_dz / 2.0])
        for i in range(n):
            M = _rot_z(2.0 * np.pi * i / n)
            copies.append(sub.transformed(M.T, M @ (off + up)))
        for i in range(n):
            # Bottom ring = perpendicular C2 image of the top ring.
            M = _ROT_X_PI @ _rot_z(2.0 * np.pi * i / n)
            copies.append(sub.transformed(M.T, M @ (off + up)))
    elif kind == "helix":
        for i in range(n):
            M = _rot_z(i * twist)
            copies.append(sub.transformed(M.T, M @ off
                                          + np.array([0.0, 0.0, i * rise])))
    else:
        raise ValueError(f"unknown symmetry kind {kind!r}")
    return sub, copies


# Symmetric/helical topology matrix (round-4 verdict item 2): each row
# mirrors one of the reference's flagship symmetric systems at its
# documented resolution/knobs, rebuilt synthetically.
TOPOLOGY_REGIMES = [
    dict(name="C6_ring_7A",
         cite="run_MaD.py:24-27 (VAT hexamer, EMD-3436, 7 A, C6)",
         kind="cn", n=6, n_res=120, radius=27.0, resolution=7.0,
         voxsp=1.75, seed=21, run_kwargs={}),
    dict(name="D7_double_ring_7A",
         cite="notebook cells 24-27 (GroEL, EMD-5338, 7 A, D7 x14)",
         kind="dn", n=7, n_res=110, radius=30.0, ring_dz=34.0,
         resolution=7.0, voxsp=1.75, seed=22, run_kwargs={}),
    dict(name="helix_x5_8A",
         cite="run_MaD.py:29-33 (actin:tropomyosin, EMD-5751, 8 A, x5)",
         kind="helix", n=5, n_res=120, radius=14.0, rise=27.5,
         twist=np.deg2rad(-166.7), resolution=8.0, voxsp=2.0, seed=23,
         run_kwargs={}),
]


def degrade_map(grid, noise_sigma: float = 0.0, background: float = 0.0,
                blur_vox=0.0, seed: int = 0, isovalue: float = None):
    """Experimental-style degradation of a clean simulated map.

    Mimics what real EMDB maps carry on top of the signal
    (mad/Dmap.py:50-67 isovalue semantics; run_MaD.py:6-60 system matrix):
      * ``blur_vox``   — extra Gaussian blur in voxels; scalar = isotropic
                         B-factor-style resolution loss, 3-tuple =
                         anisotropic (e.g. preferred-orientation z-smear);
      * ``background`` — constant plateau, fraction of map max;
      * ``noise_sigma``— additive white Gaussian noise, fraction of max;
      * isovalue clamp at ``background + 2*noise_sigma`` by default (the
        user-supplied contour level on a real map), then max-normalize.
    Returns a DensityGrid on the input grid's device (same lattice).
    """
    from dataclasses import replace as _replace

    from scipy.ndimage import gaussian_filter

    data = np.asarray(grid.host(), dtype=np.float64)
    data = data / max(data.max(), 1e-30)
    sig = ((blur_vox,) * 3 if np.isscalar(blur_vox) else tuple(blur_vox))
    if any(s > 0 for s in sig):
        data = gaussian_filter(data, sigma=sig)
        data = data / max(data.max(), 1e-30)
    rng = np.random.default_rng(seed)
    data = data + background + rng.normal(scale=max(noise_sigma, 1e-30),
                                          size=data.shape)
    if isovalue is None:
        isovalue = background + 2.0 * noise_sigma
    data = np.where(data < isovalue, 0.0, data)
    data = (data / max(data.max(), 1e-30)).astype(np.float32)
    return _replace(grid, data=torch.as_tensor(data, device=grid.device))


# Degradation ladder (round-4 verdict item 3): each rung is one knob of
# experimental realism swept to failure on a 3-copy assembly at 10 A.
# scripts/degradation_ladder.py runs the full ladder (PARITY.md table);
# tests/test_degradation.py pins the mid-ladder point as a regression.
DEGRADATION_LADDER = (
    [dict(name=f"noise_{int(s*100)}pct", noise_sigma=s, background=0.05)
     for s in (0.02, 0.05, 0.10, 0.15, 0.20)]
    + [dict(name=f"bfactor_blur_{b:g}vox", noise_sigma=0.05,
            background=0.05, blur_vox=b) for b in (1.0, 2.0, 3.0, 4.0)]
    + [dict(name=f"aniso_z_{b:g}vox", noise_sigma=0.05, background=0.05,
            blur_vox=(0.0, 0.0, b)) for b in (1.5, 3.0, 4.5)]
)


# Reference knob matrix (mad run_MaD.py:35-60 + BASELINE.json config 5).
# Each entry: (name, reference citation, system params, run() kwargs).
# System params pick a synthetic assembly whose subunit size / map scale
# matches the documented regime's resolution class; voxel spacing scales
# with resolution (the information content per voxel is what the knobs
# respond to, not absolute Angstroms).
KNOB_REGIMES = [
    dict(name="9A_cc05_ns80",
         cite="run_MaD.py:35-41 (microtubule+kinesin, EMD-1340, 9 A)",
         resolution=9.0, voxsp=2.25, n_copies=3, n_res=140, spread=26.0,
         seed=11, run_kwargs=dict(cc_threshold=0.5, n_samples=80)),
    dict(name="10A_cc05_ns100_x6",
         cite="run_MaD.py:43-47 (MecA-ClpC, EMD-5609, 10 A, x6)",
         resolution=10.0, voxsp=2.5, n_copies=6, n_res=150, spread=40.0,
         seed=12, run_kwargs=dict(cc_threshold=0.5, n_samples=100)),
    dict(name="11.6A_patch24",
         cite="run_MaD.py:49-54 (GluK2, EMD-8290, 11.6 A, 2x2)",
         resolution=11.6, voxsp=2.9, n_copies=4, n_res=220, spread=34.0,
         seed=13, run_kwargs=dict(patch_size=24)),
    dict(name="13A_ns120_patch12",
         cite="run_MaD.py:56-60 (beta-galactosidase, EMD-2548, 13 A, x4)",
         resolution=13.0, voxsp=3.0, n_copies=4, n_res=260, spread=36.0,
         seed=14, run_kwargs=dict(n_samples=120, patch_size=12)),
    dict(name="18A_dense_sweep",
         cite="BASELINE.json config 5 (low-res 15-20 A dense sweep)",
         # spread must exceed the subunit diameter at this blur level or
         # neighboring copies' densities merge (tuned: 40 -> 1/3, 62 -> 3/3)
         resolution=18.0, voxsp=3.6, n_copies=3, n_res=340, spread=62.0,
         seed=15, run_kwargs=dict(cc_threshold=0.5, n_samples=120)),
]


def _fit_inputs(copies, resolution: float, voxsp: float, device):
    """The assembly map of ``copies`` simulated on ``device``."""
    from .ops.simulate import simulate_density
    coords = np.concatenate([c.coords for c in copies])
    masses = np.concatenate([c.masses for c in copies])
    return simulate_density(coords, resolution, voxsp, masses=masses,
                            device=device)


def _dock(dmap, moved, resolution: float, cfg, n_copies: int, tag: str,
          device, timings=None):
    """Describe the map and the decoy (stages ``describe_map`` and
    ``describe_subunit`` of ``timings``), dock ``n_copies`` (the runners'
    common tail); returns (map set, decoy set, solutions)."""
    from .engine.docking import dock_structure
    from .engine.pipeline import describe_grid, describe_structure
    from .timing import stage
    with stage(timings, "describe_map", device):
        map_set = describe_grid(dmap, cfg, name=f"{tag}_map", device=device)
    with stage(timings, "describe_subunit", device):
        sub_set = describe_structure(moved, resolution, dmap.voxsp, cfg,
                                     name=f"{tag}_sub", device=device)
    return map_set, sub_set, dock_structure(
        map_set, sub_set, moved, dmap, resolution, cfg, n_copies=n_copies,
        verbose=False, device=device, timings=timings)


def run_degraded(point: dict, n_copies: int = 3, n_res: int = 110,
                 seed: int = 7, spread: float = 26.0, resolution: float = 10.0,
                 voxsp: float = 2.5, max_anchors: int = 2048, *,
                 device=None):
    """Dock a 3-copy self-fit system on a degraded map (one ladder rung),
    on ``device`` (mad_tpu's ``run_degraded``).

    The docking knobs are the reference's noisy-system regime
    (run_MaD.py:43-47: cc_threshold=0.5, n_samples=100). Returns per-copy
    best CA-RMSDs and the recovery count at the 5 A bar used by
    tests/test_experimental_map.py."""
    device = resolve(device)
    cfg = MadConfig.from_run_kwargs(cc_threshold=0.5, n_samples=100)
    cfg = cfg.replace(
        detect=dataclasses.replace(cfg.detect, max_anchors=max_anchors))
    sub, copies = make_assembly(n_copies=n_copies, n_res=n_res, seed=seed,
                                spread=spread)
    clean = _fit_inputs(copies, resolution, voxsp, device)
    kw = {k: point[k] for k in ("noise_sigma", "background", "blur_vox",
                                "isovalue") if k in point}
    dmap = degrade_map(clean, seed=seed + 100, **kw).reduce_void()
    moved = decoy_transform(sub)
    sols = _dock(dmap, moved, resolution, cfg, n_copies,
                 f"degr_{point['name']}", device)[2]
    rmsds = [min((s.structure.rmsd_ca_with(c) for s in sols),
                 default=np.inf) for c in copies]
    return dict(name=point["name"], map_shape=tuple(dmap.shape),
                n_solutions=len(sols), rmsds=rmsds,
                recovered=int(np.sum(np.asarray(rmsds) < 5.0)),
                n_copies=n_copies)


def run_topology(regime: dict, rescue_rounds: int = 1,
                 max_anchors: int = 2048, *, device=None):
    """Dock one TOPOLOGY_REGIMES entry e2e (self-fit rotation+translation
    decoy) on ``device`` (mad_tpu's ``run_topology``). Returns per-copy
    best CA-RMSDs, recovery count, and the number of DISTINCT solutions
    claimed as nearest-by-RMSD by the recovered copies (aliasing
    diagnostic: symmetry-degenerate poses must resolve to one solution per
    copy, not all copies collapsing onto one pose)."""
    device = resolve(device)
    cfg = MadConfig.from_run_kwargs(**regime["run_kwargs"])
    cfg = cfg.replace(
        detect=dataclasses.replace(cfg.detect, max_anchors=max_anchors),
        filter=dataclasses.replace(cfg.filter, rescue_rounds=rescue_rounds))
    kw = {k: regime[k] for k in ("radius", "ring_dz", "rise", "twist")
          if k in regime}
    sub, copies = make_symmetric_assembly(
        regime["kind"], regime["n"], n_res=regime["n_res"],
        seed=regime["seed"], **kw)
    dmap = _fit_inputs(copies, regime["resolution"], regime["voxsp"],
                       device).reduce_void()
    moved = decoy_transform(sub)
    sols = _dock(dmap, moved, regime["resolution"], cfg, len(copies),
                 f"topo_{regime['name']}", device)[2]
    rmsds, claimed = [], []
    for c in copies:
        per_sol = [s.structure.rmsd_ca_with(c) for s in sols]
        best = int(np.argmin(per_sol)) if per_sol else -1
        rmsds.append(per_sol[best] if per_sol else np.inf)
        claimed.append(best)
    thresh = max(4.0, regime["resolution"] / 2.0)
    rec = np.asarray(rmsds) < thresh
    return dict(name=regime["name"], cite=regime["cite"],
                kind=regime["kind"], map_shape=tuple(dmap.shape),
                n_solutions=len(sols), rmsds=rmsds, threshold=thresh,
                recovered=int(np.sum(rec)), n_copies=len(copies),
                distinct_claimed=len({c for c, r in zip(claimed, rec)
                                      if r}))


def run_knob_regime(regime: dict, rescue_rounds: int = 0, *, device=None):
    """Dock one KNOB_REGIMES entry end-to-end (self-fit decoy protocol with
    the full rotation+translation decoy) on ``device`` (mad_tpu's
    ``run_knob_regime``). Returns a result dict with per-copy best
    CA-RMSDs, recovery count and solution count."""
    device = resolve(device)
    cfg = MadConfig.from_run_kwargs(**regime["run_kwargs"])
    cfg = cfg.replace(
        detect=dataclasses.replace(cfg.detect, max_anchors=2048),
        filter=dataclasses.replace(cfg.filter,
                                   rescue_rounds=rescue_rounds,
                                   n_samples=cfg.filter.n_samples))
    sub, copies = make_assembly(n_copies=regime["n_copies"],
                                n_res=regime["n_res"], seed=regime["seed"],
                                spread=regime["spread"],
                                shell=regime["n_copies"] > 4)
    dmap = _fit_inputs(copies, regime["resolution"], regime["voxsp"],
                       device).reduce_void()
    moved = decoy_transform(sub)
    sols = _dock(dmap, moved, regime["resolution"], cfg,
                 regime["n_copies"], f"knob_{regime['name']}", device)[2]
    rmsds = [min((s.structure.rmsd_ca_with(c) for s in sols),
                 default=np.inf) for c in copies]
    thresh = max(4.0, regime["resolution"] / 2.0)
    return dict(name=regime["name"], cite=regime["cite"],
                map_shape=tuple(dmap.shape), n_solutions=len(sols),
                rmsds=rmsds, threshold=thresh,
                recovered=int(np.sum(np.asarray(rmsds) < thresh)),
                n_copies=regime["n_copies"])


# -- mad_tpu's two large documented workloads (scripts/stress_large.py,
# scripts/ensemble_bench.py) through the port ---------------------------------

# the ensemble bench's decoy conformers: deform_structure magnitudes (A)
# (mad_tpu/scripts/ensemble_bench.py:36)
DECOY_SCALES = (3.0, 5.0, 7.0, 9.0, 12.0, 15.0)
ENSEMBLE_SCORES = ("Repeatability", "Weight", "mCC", "RWmCC")


def _say(line: str) -> None:
    print(line, flush=True)


def build_system(n_copies: int = 10, n_res: int = 260, voxsp: float = 1.4,
                 resolution: float = 10.0, spread: float = 115.0,
                 seed: int = 0, shell: bool = True, *, device=None,
                 timings=None):
    """bench.py's ``build_system`` on ``device``: ``n_copies`` subunits
    (a shell, or a ring) simulated at ``resolution`` and
    ``reduce_void``-ed (stage ``simulate`` of ``timings``); returns
    (subunit, copies, map)."""
    from .timing import stage
    device = resolve(device)
    sub, copies = make_assembly(n_copies=n_copies, n_res=n_res, seed=seed,
                                spread=spread, shell=shell)
    with stage(timings, "simulate", device):
        dmap = _fit_inputs(copies, resolution, voxsp, device).reduce_void()
    return sub, copies, dmap


def assemble_solutions(structures, dmap, cfg, n_copies: int, *,
                       device=None, timings=None, max_models: int = 10,
                       max_overlap: float = 0.1):
    """bench.py:69-83 on ``device``: the solutions' overlap, the
    homomultimer ranking of min(``n_copies``, solutions) of them, up to
    ``max_models`` models CC-scored (bench.py's arguments), each a stage
    of ``timings`` (``overlap``, ``enumerate``, ``score_models``).
    Returns a dict of the structures, overlap, tuples and models."""
    from .engine import assemble as asm
    from .timing import stage
    device = resolve(device)
    with stage(timings, "overlap", device):
        ov_dev = asm.device_overlap(structures, cfg.assembly, device)
        overlap = asm.host_overlap(ov_dev)
    with stage(timings, "enumerate", device):
        tuples, sums, stds, maxs = asm.enumerate_homomultimer(
            len(structures), min(n_copies, len(structures)), overlap,
            device=device, overlap_dev=ov_dev)
    with stage(timings, "score_models", device):
        models = asm.score_models(tuples, sums, stds, maxs, structures, dmap,
                                  cfg.assembly, max_models, max_overlap)
    asm.pop_enum_notes()
    return dict(structures=structures, overlap=overlap, tuples=tuples,
                models=models)


def fit_pass(sub, copies, dmap, resolution: float, cfg, *, device=None,
             timings=None):
    """bench.py's ``run_fit`` on ``device``: the map and the decoy
    described (stages ``describe_map``, ``describe_subunit``),
    ``len(copies)`` copies docked (the dock's stages), then, with two
    solutions or more, :func:`assemble_solutions`. Returns a dict of the
    decoy (``moved``), both DescriptorSets, the solutions (``sols``), the
    assembly (None under two solutions) and its models."""
    device = resolve(device)
    moved = decoy_transform(sub)
    map_set, sub_set, sols = _dock(dmap, moved, resolution, cfg, len(copies),
                                   "bench", device, timings)
    assembly = None
    if len(sols) >= 2:
        assembly = assemble_solutions([s.structure for s in sols], dmap, cfg,
                                      len(copies), device=device,
                                      timings=timings)
    return dict(moved=moved, map_set=map_set, sub_set=sub_set, sols=sols,
                assembly=assembly,
                models=assembly["models"] if assembly else [])


def timed_pass(sub, copies, dmap, resolution: float, cfg, *, device=None):
    """:func:`fit_pass` timed (synchronized on the card). Returns its
    host results only, so that a caller holding them leaves the next
    pass's peak as it was: the solutions (``sols``), the models, the
    seconds, the peak device memory (bytes, None off the card), each
    copy's best CA-RMSD and the copies recovered (best CA-RMSD < 10 A)."""
    device = resolve(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    r = fit_pass(sub, copies, dmap, resolution, cfg, device=device)
    if cuda:
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    sols = r["sols"]
    rmsds = [min((s.structure.rmsd_ca_with(c) for s in sols),
                 default=np.inf) for c in copies]
    return dict(sols=sols, models=r["models"], seconds=seconds, peak=peak,
                rmsds=rmsds, recovered=int(np.sum(np.asarray(rmsds) < 10.0)))


def run_stress(n_copies: int = 16, n_res: int = 260, spread: float = 165.0,
               seed: int = 1, rescue_rounds: int = 1,
               resolution: float = 10.0, voxsp: float = 1.4,
               passes: int = 2, *, device=None, log=_say):
    """mad_tpu's scale stress (scripts/stress_large.py) through the port
    on ``device``: ``n_copies`` subunits in one map (mad_tpu's is
    370x353x336, 44 M voxels; its upsampled octave passes the bfloat16
    gate of the gradient field), one rescue round, ``passes`` fits of
    bench.py's chain (:func:`timed_pass`), each printed as mad_tpu prints
    it (``log``) with its peak device memory. Returns the map, its
    octaves' (real shape, gradient field dtype) as ``iter_octaves`` makes
    them, and the passes' results."""
    from .core.config import MadConfig
    from .ops.scalespace import iter_octaves
    device = resolve(device)
    cfg = MadConfig()
    cfg = cfg.replace(filter=dataclasses.replace(
        cfg.filter, rescue_rounds=rescue_rounds))
    t0 = time.perf_counter()
    sub, copies, dmap = build_system(n_copies, n_res, voxsp, resolution,
                                     spread, seed, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fields = [(o.real_shape, o.grad_dtype())
              for _org, o in iter_octaves(dmap, cfg.scalespace)]
    log(f"stress> map {dmap.shape} ({np.prod(dmap.shape) / 1e6:.0f} M vox) "
        f"built in {time.perf_counter() - t0:.1f}s; octaves "
        + ", ".join(f"{s} {str(d).split('.')[-1]} field"
                    for s, d in fields))
    out = []
    for i in range(passes):
        r = timed_pass(sub, copies, dmap, resolution, cfg, device=device)
        peak = ("" if r["peak"] is None
                else f", peak {r['peak'] / 2 ** 30:.2f} GiB")
        log(f"stress> pass {i}: {r['seconds']:.1f}s, "
            f"{len(r['sols'])} solutions, {len(r['models'])} models, "
            f"{r['recovered']}/{n_copies} recovered, median best CA-RMSD "
            f"{np.median(r['rmsds']):.2f} A{peak}")
        out.append(r)
    return dict(map_shape=tuple(dmap.shape), fields=fields, copies=copies,
                sub=sub, dmap=dmap, cfg=cfg, passes=out)


def run_ensemble_bench(workdir: str, n_copies: int = 10, n_res: int = 260,
                       spread: float = 115.0, seed: int = 0,
                       resolution: float = 10.0, voxsp: float = 1.4,
                       scales=DECOY_SCALES, *, device=None, log=_say):
    """mad_tpu's ensemble bench (scripts/ensemble_bench.py:38-90) through
    the port's ``MaD`` session on ``device``: the bench system's map and
    conformers conf_0 (the true subunit) and conf_i = deform_structure(
    sub, scales[i - 1], seed=i), docked as one ensemble of ``n_copies``
    copies under ``workdir``; ``score_ensembles`` ranks them. Prints the
    conformer ladder, the seconds of ``run`` and ``score_ensembles`` and
    the top conformer by each score (``log``). Passes when conf_0 is
    first by RWmCC, the MaD score (mad_tpu's condition); the other three
    columns are printed."""
    import os
    from .api import MaD
    from .core.grid import write_mrc
    from .core.structure import write_pdb
    device = resolve(device)
    t0 = time.perf_counter()
    sub, _copies, dmap = build_system(n_copies, n_res, voxsp, resolution,
                                      spread, seed, device=device)
    map_path = os.path.join(workdir, "bench_map.mrc")
    write_mrc(dmap, map_path)
    ens = os.path.join(workdir, "conformers")
    os.makedirs(ens)
    write_pdb(sub, os.path.join(ens, "conf_0.pdb"))
    ladder = [0.0]
    for i, scale in enumerate(scales, start=1):
        d = deform_structure(sub, scale, seed=i)
        ladder.append(float(np.sqrt(((d.coords[d.ca_idx]
                                      - sub.coords[sub.ca_idx]) ** 2)
                                    .sum(-1).mean())))
        write_pdb(d, os.path.join(ens, f"conf_{i}.pdb"))
    log(f"ens-bench> system built in {time.perf_counter() - t0:.1f}s; "
        f"conformer CA-RMSD ladder: {', '.join(f'{r:.2f}' for r in ladder)}"
        " A")
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    mad = MaD(workdir=workdir, device=device)
    mad.add_map(map_path, resolution=resolution)
    mad.add_subunit(ens, n_copies=n_copies, identifier="conformers")
    mad.run(transform_subunits=True)
    if cuda:
        torch.cuda.synchronize(device)
    t_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = mad.score_ensembles()["conformers"]
    t_score = time.perf_counter() - t0
    log(f"ens-bench> run {t_run:.1f}s, score_ensembles {t_score:.1f}s")
    top = {}
    for col, name in enumerate(ENSEMBLE_SCORES, start=1):
        by = sorted(rows, key=lambda r: r[col], reverse=True)
        top[name] = by[0][0]
        log(f"ens-bench> top by {name}: {top[name]} "
            f"({', '.join(f'{r[0]}={r[col]:.2f}' for r in by[:3])})")
    ok = top["RWmCC"] == "conf_0"
    log(f"ens-bench> true conformer first by MaD score: {ok} (first on "
        f"{sum(t == 'conf_0' for t in top.values())}/4 printed rankings)")
    return dict(ladder=ladder, rows=rows, top=top, ok=ok, t_run=t_run,
                t_score=t_score, mad=mad, map_shape=tuple(dmap.shape))


@contextlib.contextmanager
def recording(module, name: str):
    """Record the positional arguments of every call of ``module.name``
    made inside the block (the call still runs)."""
    calls, fn = [], getattr(module, name)

    def rec(*args):
        calls.append(args)
        return fn(*args)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def near_isovalue(structures, cfg, device, eps: float = 1e-5):
    """Per solution: (voxels whose unclamped low-res density lies within
    ``eps`` of the isovalue, voxels at or above it), as float64 arrays."""
    from .engine.assemble import _solution_densities
    dens, _ = _solution_densities(structures, cfg, device, 0.0)
    near = ((dens - cfg.sim_isovalue).abs() <= eps).sum(dim=(1, 2, 3))
    occ = (dens >= cfg.sim_isovalue).sum(dim=(1, 2, 3))
    return (near.cpu().numpy().astype(np.float64),
            occ.cpu().numpy().astype(np.float64))


def overlap_slack(near: np.ndarray, occ: np.ndarray,
                  atol: float = 1e-6) -> np.ndarray:
    """(n, n) bound on |ov_a - ov_b| for two computations of
    ``solution_overlap`` that may round the low-res densities differently.

    Only voxels within rounding of the isovalue can change occupancy. With
    near_i such voxels in solution i and occ_i occupied ones, count[i, j]
    moves by at most near_i + near_j and count[i, i] by near_i, so
    ov[i, j] moves by at most (2 near_i + near_j) / (occ_i - near_i); the
    bound is that plus ``atol`` (``atol`` alone where no voxel is near).
    """
    return atol + (2 * near[:, None] + near[None, :]) / np.maximum(
        occ - near, 1.0)[:, None]


def overlap_tolerance(structures, cfg, device, eps: float = 1e-5,
                      atol: float = 1e-6) -> np.ndarray:
    """``overlap_slack`` of the solutions' densities simulated on
    ``device``."""
    return overlap_slack(*near_isovalue(structures, cfg, device, eps), atol)


def orient_agreement(got, ref, tol: float = 1e-6):
    """How far two computations of K6's output agree, per anchor: the same
    lane validity and, on the valid lanes, the same main and secondary
    bins. Returns (share of agreeing anchors, max |rfinal difference| over
    the agreeing anchors' valid lanes, whether that max is within
    ``tol``). Only valid lanes are defined (kernels/orient.py)."""
    import torch
    mg, sg, rg, og = got
    mr, sr, rr, orr = ref
    K, M, S = orr.shape
    main_eq = (mg == mr)[:, :, None].expand(-1, -1, S) | ~orr
    sec_eq = (sg == sr) | ~orr
    agree = ((og == orr) & main_eq & sec_eq).reshape(K, -1).all(dim=1)
    d = (rg - rr).abs().amax(dim=(-1, -2))
    d = torch.where(orr & agree[:, None, None], d, torch.zeros_like(d))
    dmax = float(d.max()) if d.numel() else 0.0
    share = float(agree.float().mean()) if K else 1.0
    return share, dmax, dmax <= tol


def ca_rmsds(a: np.ndarray, b: np.ndarray, ca_idx) -> np.ndarray:
    """Per candidate CA-RMSD between two (C, N, 3) coordinate sets."""
    d = np.asarray(a, np.float64)[:, ca_idx] - np.asarray(b, np.float64)[
        :, ca_idx]
    return np.sqrt((d * d).sum(-1).mean(-1))


def _rotations(rng, n: int) -> np.ndarray:
    """(n, 3, 3) float64 rotations from random unit quaternions."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        -1).reshape(n, 3, 3)


def _turn(rng, angle: float) -> np.ndarray:
    """A rotation by ``angle`` rad about a random axis (float64)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


# Lanes of the two rounds of post_scenario: (copy, turn in rad, shift in A)
# of the refined pose, or "failed" / "far" (refined 200 A away: no hit).
POST_LANES = (
    ((0, 0.01, 0.3), "failed", "far", (1, 0.01, 0.2), (1, 0.03, 0.8),
     (2, 0.0, 0.1)),
    ((1, 0.02, 0.5), (3, 0.01, 0.2), (3, 0.02, 0.6), (0, 1.0, 0.3)),
)


def post_scenario(seed: int = 0, n_res: int = 12, n_rows: int = 160):
    """Two docking rounds' worth of refined lanes for the post-refine merge
    (K16), made from a numpy seed: a subunit of n_res residues, 10 subunit
    anchors, map anchors at four copies' poses (0.4 A noise) plus 6 stray
    ones, ``n_rows`` table rows on those anchors plus 3 rows off them. Each
    round (POST_LANES) starts every lane on its copy's exact pose, then the
    lane's refined pose turns and shifts it. In round 1 lane 1 is failed,
    lane 2 has no hit and lane 4 lies within the dedup RMSD of lane 3; in
    round 2 lane 0 merges into a round-1 solution and lane 2 into lane 1.
    Returns numpy arrays: sub, hi_cloud, lo_cloud, lo_rows and per round
    the candidates' rot (float32) / hi / lo / weight / members and the
    refinement's R, t, coords (float32) and failed."""
    rng = np.random.default_rng(seed)
    sub = make_protein(n_res=n_res, seed=seed)
    sub = sub.with_coords(sub.coords - sub.center())
    x0 = sub.coords
    hi_cloud = (x0[rng.choice(len(x0), 10, replace=False)]
                + rng.normal(scale=0.5, size=(10, 3)))
    copies = [(_rotations(rng, 1)[0], rng.normal(size=3) * 40)
              for _ in range(4)]
    lo_cloud = np.unique(np.round(np.concatenate(
        [hi_cloud @ R + T + rng.normal(scale=0.4, size=hi_cloud.shape)
         for R, T in copies] + [rng.normal(size=(6, 3)) * 60]), 3), axis=0)
    lo_rows = np.concatenate([lo_cloud[rng.integers(0, len(lo_cloud),
                                                    n_rows)],
                              rng.normal(size=(3, 3)) * 30])
    rounds = []
    for lanes in POST_LANES:
        rd = {k: [] for k in ("rot", "hi", "lo", "weight", "members", "R",
                              "t", "coords", "failed")}
        for i, lane in enumerate(lanes):
            k, turn, shift = ((2, 0.0, 0.0) if lane == "failed" else
                              (3, 0.0, 0.0) if lane == "far" else lane)
            R, T = copies[k]
            h = hi_cloud[rng.integers(0, len(hi_cloud))]
            rot = R.T.astype(np.float32)
            lo = h @ R + T
            y0 = ((x0 - h) @ rot.T.astype(np.float64) + lo).astype(np.float32)
            center = y0.sum(axis=0) / np.float32(len(y0))
            Rm = _turn(rng, turn).astype(np.float32)
            t = (np.array([200.0, 0.0, 0.0]) if lane == "far" else
                 rng.normal(size=3) * shift / np.sqrt(3)).astype(np.float32)
            coords = (y0 - center) @ Rm + center + t
            if lane == "failed":
                coords[:] = np.nan
            for key, v in (("rot", rot), ("hi", h), ("lo", lo),
                           ("weight", int(rng.integers(1, 6))),
                           ("members", [np.full(8, 10.0 * len(rounds) + i)]),
                           ("R", Rm), ("t", t), ("coords", coords),
                           ("failed", lane == "failed")):
                rd[key].append(v)
        rounds.append({k: (v if k in ("weight", "members") else np.stack(v))
                       for k, v in rd.items()})
    return dict(sub=sub, hi_cloud=hi_cloud, lo_cloud=lo_cloud,
                lo_rows=lo_rows, rounds=rounds)


def post_round(sc: dict, r: int, device):
    """Round r of a post_scenario as the port's docking gets it: the
    candidates (with rot, hi_coord, lo_coord, weight, members) and the
    refinement result, K15's device outputs on ``device`` included."""
    import torch
    from types import SimpleNamespace
    from .engine.refine import RefineResult
    rd = sc["rounds"][r]
    cands = [SimpleNamespace(rot=rd["rot"][i], hi_coord=rd["hi"][i],
                             lo_coord=rd["lo"][i], weight=rd["weight"][i],
                             members=rd["members"][i])
             for i in range(len(rd["weight"]))]
    dev = [torch.as_tensor(rd[k], device=device)
           for k in ("R", "t", "coords", "failed")]
    res = RefineResult(rot=rd["R"], trans=rd["t"],
                       coords=rd["coords"].astype(np.float64),
                       converged=~rd["failed"], steps=None,
                       failed=rd["failed"], device_out=tuple(dev))
    return cands, res


def repeat_inputs(a_hi: int, a_lo: int, n_pairs: int, seed: int,
                  box: float = 40.0) -> tuple:
    """Exact repeatability's inputs at any size: subunit and map anchor
    clouds uniform in a cube of side ``box`` (A), and n_pairs poses
    x -> (x - h_k) @ R_k^T + l_k with R_k random, h_k a subunit anchor and
    l_k a map anchor moved by a unit normal. Returns float32 arrays
    (hi_cloud, lo_cloud, rot, hi, lo)."""
    rng = np.random.default_rng(seed)
    hi_cloud = rng.uniform(-box / 2, box / 2, (a_hi, 3))
    lo_cloud = rng.uniform(-box / 2, box / 2, (a_lo, 3))
    rot = _rotations(rng, n_pairs)
    hi = hi_cloud[rng.integers(0, a_hi, n_pairs)]
    lo = lo_cloud[rng.integers(0, a_lo, n_pairs)] \
        + rng.normal(size=(n_pairs, 3))
    return tuple(np.asarray(a, np.float32)
                 for a in (hi_cloud, lo_cloud, rot, hi, lo))


def pose_table(n: int, n_centers: int, seed: int, a_hi: int = 32,
               spread: float = 40.0, noise: float = 0.05) -> dict:
    """A repeat-ordered match table of n pairs whose poses scatter around
    n_centers centre poses: pair k moves the subunit cloud by
    x -> (x - h_k) @ R_k^T + l_k with R_k a centre rotation turned by a
    random rotation of about ``noise`` rad and l_k chosen so that the
    moved cloud lies near the centre's translation (within ~``noise`` *
    10 A). Anchors sit on a 0.25 A lattice; repeats are 100 k / a_hi,
    descending. Returns the MatchTable fields as numpy arrays."""
    rng = np.random.default_rng(seed)
    hi_cloud = np.unique(np.round(rng.normal(size=(a_hi, 3)) * 32) / 4,
                         axis=0)
    Rc = _rotations(rng, n_centers)
    tc = rng.normal(size=(n_centers, 3)) * spread
    k = rng.integers(0, n_centers, n)
    tilt = _rotations(rng, n)
    # a small turn: the identity pulled toward a random rotation
    small = np.eye(3) + noise * (tilt - np.transpose(tilt, (0, 2, 1))) / 2
    u, _s, vt = np.linalg.svd(small)
    rot = (Rc[k] @ (u @ vt)).astype(np.float32)
    hi = hi_cloud[rng.integers(0, hi_cloud.shape[0], n)]
    lo = (np.einsum("pd,ped->pe", hi, rot.astype(np.float64)) + tc[k]
          + rng.normal(size=(n, 3)) * noise * 10)
    lo = np.round(lo * 4) / 4
    counts = np.sort(rng.integers(1, hi_cloud.shape[0] + 1, n))[::-1]
    repeat = (100.0 * counts / hi_cloud.shape[0]).astype(np.float32)
    lo_cloud = np.unique(lo, axis=0)
    return dict(cc=rng.uniform(0.6, 1.0, n).astype(np.float32),
                repeat=repeat, hi_idx=np.arange(n), lo_idx=np.arange(n),
                rot=rot, hi_coord=hi, lo_coord=lo, hi_cloud=hi_cloud,
                lo_cloud=lo_cloud)
