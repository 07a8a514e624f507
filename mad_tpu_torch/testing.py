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
"""

from __future__ import annotations

import contextlib

import numpy as np

from .core.structure import ATOMIC_MASS, Structure

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
