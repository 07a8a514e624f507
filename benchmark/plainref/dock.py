"""Plain docking of a described subunit into a described map, and the
ranking of an assembly's tuples.

The method of the reference (mad/MaD.py:371-453, 456-629, 686-745,
mad/structure_utils.py:58-161) with the rescue rounds of this project's
configuration, as plain numpy and PyTorch, frozen from the port's plain
versions so that it does not move with the program:

1. matching: the cosine of every (subunit row, map row) pair; pairs
   above ``cc_threshold``, at most ``row_cap`` a subunit row (value
   descending, column ascending) and ``max_pairs`` in all (value
   descending, row, column); the pose R = R_lo^T R_hi of each pair; its
   repeatability, the share of the subunit's anchor cloud that the pose
   puts within ``anchor_dist`` of a map anchor: approximate for every
   pair (the map anchors' voxel spheres), exact (nearest neighbours) for
   the top ``max(exact_top, n_samples * n_copies)`` rounded up to 64;
   the table in descending repeatability (stable);
2. clustering: the greedy scan of the first ``n_samples * n_copies``
   rows by the closed-form cloud RMSD, in float64; clusters kept above
   the weight and repeat gates, by weight * repeat;
3. refinement: alternating translation and rotation steps up the map's
   density gradient (trilinear, float32), the step halved every
   ``batch_size`` steps for poses that moved less than it, frozen below
   ``min_step``;
4. merging, in float64: the refined anchors' hits, the greedy CA-RMSD
   dedup (``dedup_rmsd``) with weight merging, and for a rescue round the
   first ``n_samples * n_copies`` table rows whose map anchor no accepted
   solution's atom lies within ``anchor_dist`` of; a rescue round
   re-scores them exactly, clusters them against the full table's best
   repeat, refines and merges; the rounds stop when one adds nothing;
5. scoring: each solution's CC against the map (:func:`sim.ccc`), the
   solutions ranked by repeat * weight * CC;
6. assembly (:func:`rank_tuples`): all C(n, k) tuples of the first n
   solutions (n cut until C(n, k) <= 5,000,000), ranked by their largest
   pairwise overlap (float32 fractions), ties in lexicographic order;
   models taken in that order up to ``max_models``, stopping at the first
   past ``max_overlap`` after the first.

``dtype``: the type the volumes are computed in (the refinement's
gradient field and the CC's simulations): float32, or bfloat16 for the
control. Nothing here imports the program.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import sim
from .describe import Described, axis_angle_mat, gradient, norm3, rows_times

F32, F64 = torch.float32, torch.float64


def bucket(n: int, b: int) -> int:
    return ((int(n) + b - 1) // b) * b


def unit_rows(desc: torch.Tensor) -> torch.Tensor:
    """float32 unit rows of int16 counts (zero rows stay zero)."""
    x = desc.to(F32)
    lens = torch.sqrt((x * x).sum(dim=1, keepdim=True))
    return torch.where(lens > 0, x / torch.where(lens > 0, lens,
                                                 torch.ones_like(lens)), x)


# -- 1. matching ---------------------------------------------------------

def pair_head(sim_m: torch.Tensor, row_cap: int, max_pairs: int,
              threshold: float):
    """(cosines float32, rows, cols) of the kept pairs, in order."""
    dh, dl = sim_m.shape
    r, c = torch.nonzero(sim_m > threshold, as_tuple=True)   # row-major
    v = sim_m[r, c]
    o = torch.sort(v, descending=True, stable=True).indices
    o = o[torch.sort(r[o], stable=True).indices]
    rr = r[o]
    start = torch.searchsorted(rr, rr, right=False)
    rank = torch.arange(rr.shape[0], device=rr.device) - start
    sel = o[rank < min(row_cap, dl)]
    g = torch.sort(v[sel], descending=True, stable=True).indices[:max_pairs]
    sel = sel[g]
    return (v[sel].cpu().numpy(), r[sel].cpu().numpy().astype(np.int64),
            c[sel].cpu().numpy().astype(np.int64))


def anchor_field(shape, vox: torch.Tensor, r: int) -> torch.Tensor:
    """int8 grid, 1 within the voxel sphere of radius r of an anchor."""
    g = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1]
    offs = torch.as_tensor(np.argwhere(np.sum(g * g, axis=0) <= r * r) - r,
                           device=vox.device)
    pts = (vox.long()[:, None, :] + offs[None]).reshape(-1, 3)
    dims = torch.as_tensor(shape, device=vox.device)
    pts = pts[((pts >= 0) & (pts < dims)).all(dim=1)]
    field = torch.zeros(tuple(shape), dtype=torch.int8, device=vox.device)
    field[pts[:, 0], pts[:, 1], pts[:, 2]] = 1
    return field


def approx_repeat(field, hi_cloud, origin, inv_voxsp: float, rot, hi, lo,
                  chunk: int = 256) -> torch.Tensor:
    shape = torch.as_tensor(field.shape, dtype=F32, device=field.device)
    denom = max(hi_cloud.shape[0], 1)
    out = torch.empty(rot.shape[0], dtype=F32, device=field.device)
    for s in range(0, rot.shape[0], chunk):
        R, h, l = rot[s:s + chunk], hi[s:s + chunk], lo[s:s + chunk]
        pts = rows_times(hi_cloud[None] - h[:, None],
                         R.transpose(1, 2)) + l[:, None]
        v = torch.round((pts - origin) * torch.tensor(
            inv_voxsp, dtype=F32, device=field.device))
        v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
        inb = ((v >= 0) & (v < shape)).all(dim=-1)
        v = torch.minimum(torch.clamp(v, min=0), shape - 1).to(torch.int64)
        hit = field[v[..., 0], v[..., 1], v[..., 2]] > 0
        cnt = (hit & inb).sum(dim=-1).to(F32)
        out[s:s + chunk] = 100.0 * cnt / torch.full_like(cnt, denom)
    return out


def exact_repeat(hi_cloud, lo_cloud, rot, hi, lo, thresh: float,
                 chunk: int = 16) -> torch.Tensor:
    denom = max(hi_cloud.shape[0], 1)
    lo_sq = (lo_cloud * lo_cloud).sum(dim=-1)
    out = torch.empty(rot.shape[0], dtype=F32, device=hi_cloud.device)
    for s in range(0, rot.shape[0], chunk):
        R, h, l = rot[s:s + chunk], hi[s:s + chunk], lo[s:s + chunk]
        pts = torch.einsum("cad,ced->cae", hi_cloud[None] - h[:, None], R) \
            + l[:, None]
        d2 = ((pts * pts).sum(dim=-1)[..., None] + lo_sq[None, None]
              - 2.0 * torch.einsum("cad,ld->cal", pts, lo_cloud))
        cnt = (d2.amin(dim=-1) < thresh * thresh).sum(dim=-1).to(F32)
        out[s:s + chunk] = 100.0 * cnt / torch.full_like(cnt, denom)
    return out


def order_keys(rep: torch.Tensor) -> torch.Tensor:
    """Unique int64 keys, descending in the stable descending order of
    ``rep`` (NaN lowest, -0.0 as +0.0)."""
    u = rep.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(rep == 0, torch.zeros_like(u), u)
    u = torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | 1 << 31)
    u = torch.where(torch.isnan(rep), torch.zeros_like(u), u)
    idx = torch.arange(rep.shape[0], device=rep.device)
    return (u - (1 << 31)) * (1 << 32) + (0xFFFFFFFF - idx)


@dataclass
class Table:
    cc: np.ndarray
    repeat: np.ndarray        # float32
    rot: np.ndarray           # (P, 3, 3) float32
    hi_coord: np.ndarray      # (P, 3) float64
    lo_coord: np.ndarray
    hi_cloud: np.ndarray      # (A_hi, 3) float64
    lo_cloud: np.ndarray

    @property
    def n(self) -> int:
        return self.cc.shape[0]

    def take(self, rows, repeat):
        return Table(self.cc[rows], repeat, self.rot[rows],
                     self.hi_coord[rows], self.lo_coord[rows],
                     self.hi_cloud, self.lo_cloud)


def _t32(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                           device=device)


def match(map_d: Described, sub_d: Described, grid_shape, grid_origin,
          voxsp: float, m: dict, min_exact: int, device):
    """The repeat-ordered table of matched pairs (None without pairs)."""
    sim_m = unit_rows(sub_d.desc.to(device)) @ unit_rows(
        map_d.desc.to(device)).T
    ccs, rows, cols = pair_head(sim_m, m["row_cap"], m["max_pairs"],
                                float(m["cc_threshold"]))
    del sim_m
    if len(rows) == 0:
        return None
    hi_coord, lo_coord = sub_d.subv[rows], map_d.subv[cols]
    hi_cloud = np.unique(hi_coord, axis=0)
    lo_cloud = np.unique(lo_coord, axis=0)
    rot = np.einsum("pji,pjk->pik", map_d.rfinal[cols], sub_d.rfinal[rows])
    r_vox = max(1, int(round(m["anchor_dist"] / voxsp)))
    origin32 = np.asarray(grid_origin, dtype=np.float32)
    vox = np.clip(np.round((lo_cloud.astype(np.float32) - origin32)
                           / voxsp).astype(np.int64), 0,
                  np.asarray(grid_shape) - 1).astype(np.int32)
    field = anchor_field(tuple(grid_shape), torch.as_tensor(vox,
                                                            device=device),
                         r_vox)
    rot_t, hi_t, lo_t = (_t32(a, device) for a in (rot, hi_coord, lo_coord))
    rep = approx_repeat(field, _t32(hi_cloud, device),
                        _t32(grid_origin, device),
                        float(np.float32(1.0 / voxsp)), rot_t, hi_t, lo_t)
    del field
    want = max(m["exact_top"], min_exact)
    if want > 0:
        n_use = min(bucket(want, 64), len(rows))
        top = torch.sort(order_keys(rep), descending=True).indices[:n_use]
        erep = exact_repeat(_t32(hi_cloud, device), _t32(lo_cloud, device),
                            rot_t[top], hi_t[top], lo_t[top],
                            float(m["anchor_dist"]))
        rep[top] = erep
    rep = rep.cpu().numpy()
    order = np.argsort(-rep, kind="stable")
    return Table(ccs[order], rep[order], rot[order], hi_coord[order],
                 lo_coord[order], hi_cloud, lo_cloud)


# -- 2. clustering -------------------------------------------------------

def _cloud_r2(CA, Cb, A, b, mu, M):
    D = CA - A
    d = Cb - b

    def dot3(x, y):
        return (x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]) \
            + x[..., 2] * y[..., 2]

    t1 = None
    for i in range(3):
        for k in range(3):
            term = M[i, k] * dot3(D[:, i], D[:, k])
            t1 = term if t1 is None else t1 + term
    u = [dot3(D[:, j], d) for j in range(3)]
    t2 = (mu[0] * u[0] + mu[1] * u[1]) + mu[2] * u[2]
    return (t1 + 2.0 * t2) + dot3(d, d)


def cluster(table: Table, f: dict, n_samples: int, best_repeat=None):
    """The kept clusters' founding poses, best first: dicts of rot
    (float32), hi and lo (float64) and weight (the scan in float64 on the
    CPU)."""
    n = min(n_samples, table.n)
    X = table.hi_cloud
    if best_repeat is None:
        best_repeat = table.repeat[0]
    rep_thresh = float(np.float32(max(f["min_repeat"],
                                      best_repeat * f["repeat_frac"])))
    cpu = dict(dtype=F64, device="cpu")
    rot = torch.as_tensor(np.ascontiguousarray(table.rot[:n], np.float32))
    hi = torch.as_tensor(table.hi_coord[:n], **cpu)
    lo = torch.as_tensor(table.lo_coord[:n], **cpu)
    mu = torch.as_tensor(X.mean(axis=0), **cpu)
    M = torch.as_tensor((X.T @ X) / X.shape[0], **cpu)
    A = rot.to(F64).transpose(1, 2)
    b = lo - ((hi[:, 0:1] * A[:, 0] + hi[:, 1:2] * A[:, 1])
              + hi[:, 2:3] * A[:, 2])
    CA, Cb, found, assign = [], [], [], []
    for i in range(n):
        new = not CA
        if CA:
            r2 = _cloud_r2(torch.stack(CA), torch.stack(Cb), A[i], b[i],
                           mu, M)
            j = int(torch.argmin(r2))
            new = float(torch.sqrt(torch.clamp(r2[j], min=0.0))) > \
                f["rmsd_cloud"]
        if new:
            j = len(CA)
            CA.append(A[i])
            Cb.append(b[i])
            found.append(i)
        assign.append(j)
    weights = np.bincount(assign, minlength=len(found))
    rep = table.repeat[:n].astype(np.float32)[found]
    keep = [c for c in range(len(found))
            if weights[c] >= f["weight_threshold"]
            and not float(rep[c]) < rep_thresh]
    score = np.asarray([rep[c] * np.float32(weights[c]) for c in keep],
                       dtype=np.float32)
    out = []
    for o in np.argsort(-score, kind="stable"):
        row = found[keep[o]]
        out.append(dict(rot=table.rot[row], hi=table.hi_coord[row],
                        lo=table.lo_coord[row], weight=int(weights[keep[o]])))
    return out


# -- 3. refinement -------------------------------------------------------

def trilinear(field, pts):
    x, y, z = field.shape[:3]
    flat = field.reshape(-1, field.shape[3])
    shp = torch.as_tensor((x, y, z), device=pts.device)
    p = torch.minimum(torch.clamp(pts, min=0.0), (shp - 1).to(pts.dtype))
    p0 = torch.minimum(torch.clamp(torch.floor(p).to(torch.int64), min=0),
                       shp - 2)
    f = p - p0.to(p.dtype)
    w0, w1 = 1.0 - f, f
    base = (p0[..., 0] * y + p0[..., 1]) * z + p0[..., 2]
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((w1[..., 0] if dx else w0[..., 0])
                     * (w1[..., 1] if dy else w0[..., 1])
                     * (w1[..., 2] if dz else w0[..., 2]))
                term = w[..., None] * flat[base + (dx * y + dy) * z + dz]
                out = term if out is None else out + term
    return out


def _unit(v, eps: float = 1e-30):
    n = norm3(v)[..., None]
    ok = n > eps
    return torch.where(ok, v / torch.where(ok, n, torch.ones_like(n)), v)


def refine(field, bounds, starts: np.ndarray, r: dict, device):
    """(rot, trans, coords (C, N, 3) float32, failed) of the refined
    starts (C, N, 3)."""
    y0 = torch.as_tensor(np.asarray(starts, dtype=np.float32), device=device)
    C, N = y0.shape[:2]
    center = y0.sum(dim=1, keepdim=True) / float(max(N, 1))
    angle_den = torch.clamp(norm3(y0 - center).amax(dim=1), min=1e-6)
    origin, hi_bound, voxsp = bounds[0:3], bounds[3:6], bounds[6]
    arm = y0 - center
    trans = torch.zeros((C, 3), dtype=F32, device=device)
    rot = torch.eye(3, dtype=F32, device=device).repeat(C, 1, 1)
    step_size = torch.full((C,), float(r["max_step"]), dtype=F32,
                           device=device)
    prev = y0.clone()
    frozen = torch.zeros(C, dtype=torch.bool, device=device)
    failed = torch.zeros(C, dtype=torch.bool, device=device)
    for step in range(r["n_steps"]):
        if step % r["batch_size"] == 0 and bool(frozen.all()):
            break
        coords = arm @ rot + center + trans[:, None]
        inb = ((coords > origin) & (coords < hi_bound)).all(dim=-1)
        g = trilinear(field, (coords - origin) / voxsp) \
            * inb.to(coords.dtype)[..., None]
        upd = ~frozen
        if step % 2 == 0:
            dtrans = _unit(g.sum(dim=1)) * step_size[:, None]
            trans = torch.where(upd[:, None], trans + dtrans, trans)
        else:
            torque = _unit(torch.linalg.cross(g, coords - center,
                                              dim=-1).sum(dim=1))
            rstep = axis_angle_mat(torque, step_size / angle_den)
            rot = torch.where(upd[:, None, None], rot @ rstep, rot)
        new_coords = arm @ rot + center + trans[:, None]
        if (step + 1) % r["batch_size"] == 0:
            disp = norm3(prev - new_coords).amax(dim=1)
            shrink = (disp < step_size) & upd
            step_size = torch.where(shrink, step_size * 0.5, step_size)
            prev = torch.where(upd[:, None, None], new_coords, prev)
        finite = (torch.isfinite(new_coords).all(dim=2).all(dim=1)
                  & torch.isfinite(trans).all(dim=1))
        failed = failed | ~finite
        frozen = frozen | (step_size < r["min_step"]) | failed
    coords = arm @ rot + center + trans[:, None]
    return rot, trans, coords, failed


def map_field(vol: torch.Tensor, origin, voxsp: float, dtype):
    """The map's gradient field (float32, or ``dtype`` rounded and widened
    for the control) and the float32 [origin, hi bound, voxsp] bounds."""
    v = vol.to(F32) if dtype == F32 else vol.to(dtype)
    field = gradient(v, dtype).to(F32)
    o = torch.as_tensor(np.asarray(origin, dtype=np.float32),
                        device=vol.device)
    vs = torch.tensor(np.float32(voxsp), device=vol.device)
    hi_bound = o + (torch.as_tensor(vol.shape, device=vol.device) - 1) * vs
    return field, torch.cat([o, hi_bound, vs[None]])


# -- 4. merging ----------------------------------------------------------

def _vecmat(v, M):
    return ((v[..., 0:1] * M[..., 0, :] + v[..., 1:2] * M[..., 1, :])
            + v[..., 2:3] * M[..., 2, :])


def _d2(a, b):
    d = a - b
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _min_d2(points, atoms, chunk: int = 64):
    if atoms.shape[0] == 0 or points.shape[0] == 0:
        return torch.full((points.shape[0],), float("inf"), dtype=F64,
                          device=points.device)
    return torch.cat([_d2(points[q:q + chunk, None], atoms[None]).amin(1)
                      for q in range(0, points.shape[0], chunk)])


@dataclass
class Solution:
    coords: np.ndarray        # (N, 3) float64
    repeat: float
    weight: int
    ccc: float = 0.0
    score: float = 0.0


def merge(rot_m, trans_m, coords_m, failed, cands, table: Table,
          x0: np.ndarray, ca_idx: np.ndarray, solutions: List[Solution],
          hit_thresh: float, dedup_rmsd: float, anchor_dist: float,
          n_top: int, device):
    """Appends the round's new solutions (weights merged into earlier
    ones); returns the table rows the next round may take."""
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64),
                                    device=device)
    N = x0.shape[0]
    Arot = put([c["rot"] for c in cands]).transpose(1, 2)
    b = put([c["lo"] for c in cands]) - _vecmat(put([c["hi"] for c in cands]),
                                                Arot)
    x032 = put(x0.astype(np.float32).astype(np.float64))
    center = (_vecmat(x032[None], Arot[:, None]) + b[:, None]).sum(dim=1) / N
    R, t = rot_m.to(F64), trans_m.to(F64)
    u = (_vecmat(put(table.hi_cloud)[None], Arot[:, None]) + b[:, None]) \
        - center[:, None]
    s_a = (_vecmat(u, R[:, None]) + center[:, None]) + t[:, None]
    lo_cloud = put(table.lo_cloud)
    near = torch.stack([_d2(s_a[i][:, None], lo_cloud[None]).amin(dim=1)
                        for i in range(len(cands))])
    hits = (near < hit_thresh * hit_thresh) & ~failed[:, None]
    counts = hits.sum(dim=1).cpu().numpy()
    ok = (~failed.cpu().numpy()) & (counts > 0)
    idx = torch.as_tensor(ca_idx if len(ca_idx) else np.arange(N),
                          device=device)
    new = coords_m.to(F64)[:, idx]
    prev = (put(np.stack([s.coords for s in solutions]))[:, idx]
            if solutions else new[:0])
    targets = torch.cat([prev, new])
    rmat = (_d2(new[:, None], targets[None]).sum(dim=2)
            / idx.shape[0]).sqrt().cpu().numpy()
    coords_np = coords_m.cpu().numpy().astype(np.float64)
    cols = list(range(len(solutions)))
    S, accepted = len(solutions), []
    for i, c in enumerate(cands):
        w = c["weight"]
        if not ok[i]:
            continue
        best, k_best = float("inf"), -1
        for k, col in enumerate(cols):
            if rmat[i][col] < best:
                best, k_best = rmat[i][col], k
        if k_best >= 0 and best < dedup_rmsd:
            solutions[k_best].weight += w
        else:
            cols.append(S + i)
            accepted.append(i)
            solutions.append(Solution(
                coords=coords_np[i],
                repeat=100.0 * float(counts[i]) / table.hi_cloud.shape[0],
                weight=w))
    if n_top <= 0:
        return np.zeros(0, np.int64)
    atoms = torch.cat([put(np.stack([s.coords for s in solutions[:S]]))
                       .reshape(-1, 3) if S else put(np.zeros((0, 3))),
                       coords_m.to(F64)[accepted].reshape(-1, 3)])
    elig = (~(_min_d2(lo_cloud, atoms) < anchor_dist * anchor_dist)
            ).cpu().numpy()
    _u, inv = np.unique(table.lo_coord, axis=0, return_inverse=True)
    return np.nonzero(elig[inv.reshape(-1)])[0][:n_top]


# -- the dock ------------------------------------------------------------

def dock(map_d: Described, sub_d: Described, x0: np.ndarray,
         masses: np.ndarray, ca_idx: np.ndarray, vol: torch.Tensor,
         origin, voxsp: float, resolution: float, method: dict,
         n_copies: int, dtype=F32):
    """(the first round's candidates, the solutions best first) of one
    dock."""
    device = vol.device
    m, f, r = method["match"], method["filter"], method["refine"]
    n_samples = f["n_samples"] * n_copies
    table = match(map_d, sub_d, vol.shape, origin, voxsp, m, n_samples,
                  device)
    if table is None:
        return [], []
    cands = cluster(table, f, n_samples)
    first = list(cands)
    if not cands:
        return first, []
    field, bounds = map_field(vol, origin, voxsp, dtype)
    rounds = max(0, int(f["rescue_rounds"]))
    solutions: List[Solution] = []

    def refine_merge(cands, n_top):
        starts = np.stack([(x0 - c["hi"]) @ c["rot"].T + c["lo"]
                           for c in cands]).astype(np.float32)
        rot, trans, coords, failed = refine(field, bounds, starts, r, device)
        before = len(solutions)
        top = merge(rot, trans, coords, failed, cands, table, x0, ca_idx,
                    solutions, voxsp * 1.5, r["dedup_rmsd"],
                    m["anchor_dist"], n_top, device)
        return len(solutions) - before, top

    _n, top = refine_merge(cands, n_samples if rounds else 0)
    best_repeat = float(table.repeat[0])
    for k in range(rounds):
        if not solutions or not len(top):
            break
        erep = exact_repeat(
            _t32(table.hi_cloud, device), _t32(table.lo_cloud, device),
            _t32(table.rot[top], device), _t32(table.hi_coord[top], device),
            _t32(table.lo_coord[top], device),
            float(m["anchor_dist"])).cpu().numpy()
        order = np.argsort(-erep, kind="stable")
        cands = cluster(table.take(top[order], erep[order]), f, n_samples,
                        best_repeat=best_repeat)
        if not cands:
            break
        n_new, top = refine_merge(cands, n_samples if k + 1 < rounds else 0)
        if n_new == 0:
            break
    if solutions:
        cccs = solution_cccs(vol, origin, voxsp,
                             np.stack([s.coords for s in solutions]),
                             masses, resolution, method["shape_bucket"],
                             dtype)
        for s, c in zip(solutions, cccs):
            s.ccc = float(c)
            s.score = s.repeat * s.weight * s.ccc
    solutions.sort(key=lambda s: s.score, reverse=True)
    return first, solutions


def solution_cccs(vol, origin, voxsp: float, coords: np.ndarray,
                  masses: np.ndarray, resolution: float, shape_bucket: int,
                  dtype=F32) -> np.ndarray:
    """The CC of each of M poses (M, N, 3) simulated together on one box,
    as the dock scores its solutions."""
    if len(coords) == 0:
        return np.zeros(0)
    vols, origins = sim.simulate(coords, masses, resolution, voxsp,
                                 vol.device, shape_bucket=shape_bucket,
                                 dtype=dtype)
    return sim.ccc(vol.to(dtype), origin, voxsp, vols, origins)


# -- 6. assembly ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _combinations(n: int, k: int) -> np.ndarray:
    """All C(n, k) index tuples (M, k) in lexicographic order (int8)."""
    if k == 0:
        out = np.zeros((1, 0), dtype=np.int8)
    elif k == n:
        out = np.arange(n, dtype=np.int8)[None, :]
    else:
        sub = _combinations(n - 1, k - 1)
        first = np.concatenate([np.zeros((len(sub), 1), np.int8), sub + 1],
                               axis=1)
        out = np.concatenate([first, _combinations(n - 1, k) + 1], axis=0)
    out.setflags(write=False)
    return out


def rank_tuples(overlap32: np.ndarray, n_copies: int, max_models: int,
                max_overlap: float, device,
                max_combinations: int = 5_000_000) -> List[tuple]:
    """The models' tuples of solution indices, in rank order, from the
    solutions' float32 upper-triangular overlap (module docstring, 6)."""
    n = overlap32.shape[0]
    k = min(n_copies, n)
    while n > k and math.comb(n, k) > max_combinations:
        n -= 1
    if k <= 1:
        return [(i,) for i in range(min(n, max_models))]
    tuples = _combinations(n, k)
    ov = torch.as_tensor(np.ascontiguousarray(overlap32[:n, :n],
                                              dtype=np.float32),
                         device=device)
    pairs = [(a, b) for a in range(k) for b in range(a + 1, k)]
    i0 = torch.as_tensor([p[0] for p in pairs], device=device)
    i1 = torch.as_tensor([p[1] for p in pairs], device=device)
    maxs = []
    for c0 in range(0, len(tuples), 1 << 18):
        t = torch.as_tensor(tuples[c0:c0 + (1 << 18)].astype(np.int64),
                            device=device)
        maxs.append(ov[t[:, i0], t[:, i1]].amax(dim=1))
    mx = torch.cat(maxs).cpu().numpy()
    order = np.argsort(mx, kind="stable")
    out = []
    for cnt, o in enumerate(order[:max_models]):
        if mx[o] > max_overlap and cnt:
            break
        out.append(tuple(int(i) for i in tuples[o]))
    return out


def overlap32(coords: np.ndarray, masses: np.ndarray, asm: dict, device,
              dtype=F32) -> np.ndarray:
    """(n, n) float32 upper-triangular overlap fractions of the solutions'
    occupancies (count of the pair over the row's own count)."""
    n = len(coords)
    if n < 2:
        return np.zeros((n, n), np.float32)
    counts = sim.occupancy_counts(coords, np.broadcast_to(masses, (
        n, len(masses))), device, asm["sim_resolution"], asm["sim_voxsp"],
        asm["sim_isovalue"], dtype)
    diag = np.diag(counts).astype(np.float32)
    ov = counts.astype(np.float32) / np.maximum(diag, 1)[:, None]
    ov = np.where(diag[:, None] == 0, np.float32(0), ov).astype(np.float32)
    return np.triu(ov, k=1)
