"""K16: the post-refine merge and the rescue eligibility of a docking round.

Replaces mad_tpu/engine/dock_fused.py:344-453 (the ``_compiled_dock_post``
body) on the port's split path, whose host version is mad_tpu's
``engine/docking._merge_refined`` (numpy and ``cKDTree``, float64) and the
rescue round's eligibility query. In float64, for the C refined lanes of
a round:

1. the composed pose of each lane: A = rot^T, b = lo - hi A from the
   candidate, center = mean(x0 A + b) (x0 the subunit rounded to
   float32), and the subunit anchors s_a = ((hi_cloud A + b) - center) R
   + center + t with the refinement's R, t;
2. the hits: an anchor hits when its nearest map anchor (direct
   differences) lies at a squared distance below hit_thresh^2, which is
   what ``cKDTree.query(..., distance_upper_bound=hit_thresh)`` and
   ``d <= hit_thresh`` decide; counts per lane;
3. the greedy CA-RMSD dedup in candidate order: a failed or hitless lane
   is skipped; otherwise it merges into the accepted solution of least
   CA-RMSD (the first on ties; the S solutions of earlier rounds first,
   then this round's in order) when that RMSD is below dedup_rmsd, else
   it founds a new solution. RMSD = sqrt(sum d^2 / n) over ``idx`` (the CA
   atoms, or all atoms when there are none);
4. when ``n_top`` > 0, the rescue eligibility of each table row: no atom
   of an accepted solution lies at a squared distance below
   anchor_dist^2 of its map anchor (``cKDTree``'s upper bound, then
   ``d > anchor_dist``); per point of the map-anchor cloud, each row taking
   its point's answer. Then the first ``n_top`` eligible rows, in table
   order.

The CUDA source ``csrc/post.cu`` does this in five stages (its note says
how), each with its wrapper here, its plain PyTorch version and its own
launch counter: the lanes (1-2, :func:`post_lanes`), the dedup
(3, :func:`post_dedup`, counted by ``launches``), the eligibility of the
cloud points and of the table rows (4, :func:`post_points`,
:func:`post_rows`) and the ordered compaction (:func:`post_compact`).
The lane, point and row stages take a (start, count) range: with a mesh,
:func:`post` runs them on each shard's block on its device and gathers the
parts on the home device, where the dedup and the compaction run once, as
mad_tpu's mesh form does (its ``lane_map_fn`` and ``pair_scan_fn``,
engine/dock_fused.py:455-524). Without one, the lanes and the dedup run
in one launch (:func:`post_lanes_dedup`, counted by ``fold_launches``;
its plain version is the two plain stages), the point and row stages on
one block. :func:`post_plain` is the same composition of the plain
versions. Both return one float64 vector that :func:`split_post` cuts on
the host: s_a (C, A, 3) | hits (C, A) | counts (C) | accepted (C) | slot
(C) | number of rows taken | rows (n_top, -1 past them). ``slot`` is the lane's index in the solution
list: the new one it founds, or the one it merges into; -1 for a skipped
lane. A failed lane's s_a is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import Mesh, map_rows, replicate
from . import build

# atoms a block of the point stage takes, about (csrc/post.cu)
ATOM_CHUNK = build.constants("post.cu")["kAtomChunk"]

launches = 0            # post_dedup launches since the last reset
lane_launches = 0       # post_lanes launches
fold_launches = 0       # post_lanes_dedup launches
point_launches = 0      # post_points launches
row_launches = 0        # post_rows launches
compact_launches = 0    # post_compact launches


def _vecmat(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """v (..., 3) @ M (..., 3, 3), each sum left to right."""
    return ((v[..., 0:1] * M[..., 0, :] + v[..., 1:2] * M[..., 1, :])
            + v[..., 2:3] * M[..., 2, :])


def _d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (dx^2 + dy^2) + dz^2 of a (..., 3) - b (..., 3)."""
    d = a - b
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _min_d2(points: torch.Tensor, atoms: torch.Tensor,
            chunk: int = 64) -> torch.Tensor:
    """Per point (Q, 3) the least squared distance to the atoms (T, 3);
    inf when there is no atom."""
    if atoms.shape[0] == 0:
        return torch.full((points.shape[0],), float("inf"),
                          dtype=torch.float64, device=points.device)
    return torch.cat([_d2(points[q:q + chunk, None], atoms[None]).amin(1)
                      for q in range(0, points.shape[0], chunk)]
                     or [points.new_zeros(0)])


def _atoms(prev: torch.Tensor, coords_m: torch.Tensor,
           accepted: torch.Tensor) -> torch.Tensor:
    """The atoms of the earlier solutions and of the accepted lanes."""
    return torch.cat([prev.reshape(-1, 3),
                      coords_m.to(torch.float64)[accepted != 0]
                      .reshape(-1, 3)])


def out_size(C: int, A: int, n_top: int) -> int:
    return C * A * 4 + 3 * C + 1 + n_top


def split_post(vec: np.ndarray, C: int, A: int, n_top: int):
    """(s_a (C, A, 3), hits (C, A) bool, counts (C,), accepted (C,) bool,
    slot (C,), rows taken) of a vector pulled to the host."""
    vec = np.asarray(vec)
    o = C * A * 3
    s_a = vec[:o].reshape(C, A, 3)
    hits = vec[o:o + C * A].reshape(C, A) != 0
    o += C * A
    counts = vec[o:o + C].astype(np.int64)
    accepted = vec[o + C:o + 2 * C] != 0
    slot = vec[o + 2 * C:o + 3 * C].astype(np.int64)
    o += 3 * C
    n_taken = int(vec[o])
    return s_a, hits, counts, accepted, slot, \
        vec[o + 1:o + 1 + n_taken].astype(np.int64)


# -- the plain versions of the stages -----------------------------------------

def post_lanes_plain(rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo, x0,
                     hi_cloud, lo_cloud, hit_thresh, start, count):
    sl = slice(start, start + count)
    f64 = torch.float64
    N, A_hi = x0.shape[0], hi_cloud.shape[0]
    failed = failed[sl].to(torch.bool)
    A = cand_rot[sl].to(f64).transpose(1, 2)
    b = cand_lo[sl] - _vecmat(cand_hi[sl], A)
    center = (_vecmat(x0[None], A[:, None]) + b[:, None]).sum(dim=1) / N
    R, t = rot_m[sl].to(f64), trans_m[sl].to(f64)
    u = (_vecmat(hi_cloud[None], A[:, None]) + b[:, None]) - center[:, None]
    s_a = (_vecmat(u, R[:, None]) + center[:, None]) + t[:, None]
    s_a = torch.where(failed[:, None, None], torch.zeros_like(s_a), s_a)
    if lo_cloud.shape[0]:
        near = _d2(s_a[:, :, None], lo_cloud[None, None]).amin(dim=2)
    else:
        near = torch.full((count, A_hi), float("inf"), dtype=f64,
                          device=x0.device)
    hits = (near < hit_thresh * hit_thresh) & ~failed[:, None]
    return s_a, hits.to(f64), hits.sum(dim=1).to(f64)


def post_dedup_plain(coords_m, failed, counts, prev, idx, dedup_rmsd):
    dev, f64 = coords_m.device, torch.float64
    C, S = coords_m.shape[0], prev.shape[0]
    new = coords_m.to(f64)[:, idx]
    targets = torch.cat([prev[:, idx], new])
    rmat = (_d2(new[:, None], targets[None]).sum(dim=2)
            / idx.shape[0]).sqrt().tolist()
    ok = (~failed.to(torch.bool) & (counts > 0)).tolist()
    cols = list(range(S))          # solution index -> column of rmat
    accepted, slot = [0] * C, [-1] * C
    for i in range(C):
        if not ok[i]:
            continue
        best, k_best = float("inf"), -1
        for k, col in enumerate(cols):
            if rmat[i][col] < best:
                best, k_best = rmat[i][col], k
        if k_best >= 0 and best < dedup_rmsd:
            slot[i] = k_best
        else:
            slot[i], accepted[i] = len(cols), 1
            cols.append(S + i)
    return (torch.as_tensor(accepted, dtype=f64, device=dev),
            torch.as_tensor(slot, dtype=f64, device=dev))


def post_lanes_dedup_plain(rot_m, trans_m, coords_m, failed, cand_rot,
                           cand_hi, cand_lo, x0, hi_cloud, lo_cloud, prev,
                           idx, hit_thresh, dedup_rmsd):
    s_a, hits, counts = post_lanes_plain(
        rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo, x0, hi_cloud,
        lo_cloud, hit_thresh, 0, rot_m.shape[0])
    return (s_a, hits, counts) + post_dedup_plain(coords_m, failed, counts,
                                                  prev, idx, dedup_rmsd)


def post_points_plain(lo_cloud, prev, coords_m, accepted, anchor_dist,
                      start, count):
    atoms = _atoms(prev, coords_m, accepted)
    near = _min_d2(lo_cloud[start:start + count], atoms)
    return (~(near < anchor_dist * anchor_dist)).to(torch.uint8)


def post_rows_plain(lo_rows, lo_cloud, elig_pt, prev, coords_m, accepted,
                    anchor_dist, start, count):
    rows = lo_rows[start:start + count]
    same = (rows[:, None] == lo_cloud[None]).all(dim=2)
    found = same.any(dim=1)
    flag = torch.zeros(count, dtype=torch.bool, device=rows.device)
    if lo_cloud.shape[0]:
        flag = (elig_pt[same.to(torch.int8).argmax(dim=1)] != 0) & found
    flag[~found] = ~(_min_d2(rows[~found], _atoms(prev, coords_m, accepted))
                     < anchor_dist * anchor_dist)
    return flag.to(torch.uint8)


def post_compact_plain(row_flag, n_top):
    rows = torch.nonzero(row_flag).flatten()[:n_top]
    out = torch.full((1 + n_top,), -1.0, dtype=torch.float64,
                     device=row_flag.device)
    out[0] = rows.shape[0]
    out[1:1 + rows.shape[0]] = rows.to(torch.float64)
    return out


# -- the stage wrappers -------------------------------------------------------

def point_chunks(solutions: int, N: int) -> int:
    """The runs of atoms that csrc/post.cu's point stage cuts the
    solutions' atoms into, one a block row of its grid: about ATOM_CHUNK
    atoms each (at most 65,535 runs)."""
    return max(1, min(65535, -(-solutions * N // ATOM_CHUNK)))


def _f64(*ts):
    return [t.to(torch.float64).contiguous() for t in ts]


def post_lanes(rot_m: torch.Tensor, trans_m: torch.Tensor,
               failed: torch.Tensor, cand_rot: torch.Tensor,
               cand_hi: torch.Tensor, cand_lo: torch.Tensor,
               x0: torch.Tensor, hi_cloud: torch.Tensor,
               lo_cloud: torch.Tensor, hit_thresh: float, start: int,
               count: int):
    """Stage 1 for lanes start .. start + count - 1 of the C lanes given:
    (s_a (count, A, 3), hits (count, A), counts (count)) float64."""
    if x0.device.type == "cpu":
        return post_lanes_plain(rot_m, trans_m, failed, cand_rot, cand_hi,
                                cand_lo, x0, hi_cloud, lo_cloud, hit_thresh,
                                start, count)
    global lane_launches
    C, N, A_hi = rot_m.shape[0], x0.shape[0], hi_cloud.shape[0]
    if (rot_m.shape != (C, 3, 3) or trans_m.shape != (C, 3)
            or failed.shape != (C,) or cand_rot.shape != (C, 3, 3)
            or cand_hi.shape != (C, 3) or cand_lo.shape != (C, 3)
            or x0.shape != (N, 3) or hi_cloud.shape != (A_hi, 3)
            or lo_cloud.dim() != 2 or lo_cloud.shape[1] != 3
            or not 0 <= start <= start + count <= C):
        raise ValueError("post_lanes: bad shapes or range")
    f32 = [t.to(torch.float32).contiguous() for t in (rot_m, trans_m)]
    f64 = _f64(cand_rot, cand_hi, cand_lo, x0, hi_cloud, lo_cloud)
    failed = failed.to(torch.uint8).contiguous()
    build.require_cuda("post_lanes", *f32, failed, *f64)
    dev = x0.device
    s_a = torch.empty((count, A_hi, 3), dtype=torch.float64, device=dev)
    hits = torch.empty((count, A_hi), dtype=torch.float64, device=dev)
    counts = torch.empty(count, dtype=torch.float64, device=dev)
    if count == 0:
        return s_a, hits, counts
    build.launch(
        build.library().mad_post_lanes, dev, *(t.data_ptr() for t in f32),
        failed.data_ptr(), *(t.data_ptr() for t in f64[:3]), int(start),
        int(count), f64[3].data_ptr(), N, f64[4].data_ptr(), A_hi,
        f64[5].data_ptr(), f64[5].shape[0], float(hit_thresh),
        s_a.data_ptr(), hits.data_ptr(), counts.data_ptr())
    lane_launches += 1
    return s_a, hits, counts


def post_dedup(coords_m: torch.Tensor, failed: torch.Tensor,
               counts: torch.Tensor, prev: torch.Tensor, idx: torch.Tensor,
               dedup_rmsd: float):
    """Stage 2-3 on all C lanes: (accepted (C), slot (C)) float64."""
    if coords_m.device.type == "cpu":
        return post_dedup_plain(coords_m, failed, counts, prev, idx,
                                dedup_rmsd)
    global launches
    C, N = coords_m.shape[:2]
    S = prev.shape[0]
    if (coords_m.shape != (C, N, 3) or failed.shape != (C,)
            or counts.shape != (C,) or prev.shape != (S, N, 3)
            or idx.dim() != 1 or not 0 < idx.shape[0] <= N):
        raise ValueError("post_dedup: bad shapes")
    coords_m = coords_m.to(torch.float32).contiguous()
    failed = failed.to(torch.uint8).contiguous()
    counts, prev = _f64(counts, prev)
    idx = idx.to(torch.int64).contiguous()
    build.require_cuda("post_dedup", coords_m, failed, counts, prev, idx)
    dev = coords_m.device
    acc = torch.empty(C, dtype=torch.float64, device=dev)
    slot = torch.empty(C, dtype=torch.float64, device=dev)
    if C == 0:
        return acc, slot
    rmat = torch.empty(C * (S + C), dtype=torch.float64, device=dev)
    lane_of = torch.empty(C + 1, dtype=torch.int32, device=dev)
    build.launch(
        build.library().mad_post_dedup, dev, coords_m.data_ptr(),
        failed.data_ptr(), counts.data_ptr(), C, N, prev.data_ptr(), S,
        idx.data_ptr(), idx.shape[0], float(dedup_rmsd), rmat.data_ptr(),
        lane_of.data_ptr(), acc.data_ptr(), slot.data_ptr())
    launches += 1
    return acc, slot


def post_lanes_dedup(rot_m: torch.Tensor, trans_m: torch.Tensor,
                     coords_m: torch.Tensor, failed: torch.Tensor,
                     cand_rot: torch.Tensor, cand_hi: torch.Tensor,
                     cand_lo: torch.Tensor, x0: torch.Tensor,
                     hi_cloud: torch.Tensor, lo_cloud: torch.Tensor,
                     prev: torch.Tensor, idx: torch.Tensor,
                     hit_thresh: float, dedup_rmsd: float):
    """Stages 1-3 on all C lanes in one launch (one device): (s_a (C, A,
    3), hits (C, A), counts (C), accepted (C), slot (C)) float64, as
    :func:`post_lanes` on every lane and then :func:`post_dedup` give
    them."""
    if x0.device.type == "cpu":
        return post_lanes_dedup_plain(rot_m, trans_m, coords_m, failed,
                                      cand_rot, cand_hi, cand_lo, x0,
                                      hi_cloud, lo_cloud, prev, idx,
                                      hit_thresh, dedup_rmsd)
    global fold_launches
    C, N, A_hi = rot_m.shape[0], x0.shape[0], hi_cloud.shape[0]
    S = prev.shape[0]
    if (rot_m.shape != (C, 3, 3) or trans_m.shape != (C, 3)
            or coords_m.shape != (C, N, 3) or failed.shape != (C,)
            or cand_rot.shape != (C, 3, 3) or cand_hi.shape != (C, 3)
            or cand_lo.shape != (C, 3) or x0.shape != (N, 3)
            or hi_cloud.shape != (A_hi, 3) or lo_cloud.dim() != 2
            or lo_cloud.shape[1] != 3 or prev.shape != (S, N, 3)
            or idx.dim() != 1 or not 0 < idx.shape[0] <= N):
        raise ValueError("post_lanes_dedup: bad shapes")
    f32 = [t.to(torch.float32).contiguous()
           for t in (rot_m, trans_m, coords_m)]
    f64 = _f64(cand_rot, cand_hi, cand_lo, x0, hi_cloud, lo_cloud, prev)
    failed = failed.to(torch.uint8).contiguous()
    idx = idx.to(torch.int64).contiguous()
    build.require_cuda("post_lanes_dedup", *f32, failed, *f64, idx)
    dev = x0.device
    s_a = torch.empty((C, A_hi, 3), dtype=torch.float64, device=dev)
    hits = torch.empty((C, A_hi), dtype=torch.float64, device=dev)
    counts, acc, slot = torch.empty((3, C), dtype=torch.float64,
                                    device=dev)
    if C == 0:
        return s_a, hits, counts, acc, slot
    rmat = torch.empty(C * (S + C), dtype=torch.float64, device=dev)
    lane_of = torch.empty(C, dtype=torch.int32, device=dev)
    tickets = torch.empty(C + 1, dtype=torch.int64, device=dev)
    build.launch(
        build.library().mad_post_lanes_dedup, dev,
        *(t.data_ptr() for t in f32), failed.data_ptr(),
        *(t.data_ptr() for t in f64[:3]), C, f64[3].data_ptr(), N,
        f64[4].data_ptr(), A_hi, f64[5].data_ptr(), f64[5].shape[0],
        float(hit_thresh), f64[6].data_ptr(), S, idx.data_ptr(),
        idx.shape[0], float(dedup_rmsd), rmat.data_ptr(), lane_of.data_ptr(),
        tickets.data_ptr(), s_a.data_ptr(), hits.data_ptr(),
        counts.data_ptr(), acc.data_ptr(), slot.data_ptr())
    fold_launches += 1
    return s_a, hits, counts, acc, slot


def post_points(lo_cloud: torch.Tensor, prev: torch.Tensor,
                coords_m: torch.Tensor, accepted: torch.Tensor,
                anchor_dist: float, start: int, count: int) -> torch.Tensor:
    """Stage 4 for cloud points start .. start + count - 1: 1 where no atom
    of an accepted solution lies within anchor_dist, (count,) uint8."""
    if lo_cloud.device.type == "cpu":
        return post_points_plain(lo_cloud, prev, coords_m, accepted,
                                 anchor_dist, start, count)
    global point_launches
    lo_cloud, prev, accepted = _f64(lo_cloud, prev, accepted)
    coords_m = coords_m.to(torch.float32).contiguous()
    C, N = coords_m.shape[:2]
    if (lo_cloud.dim() != 2 or lo_cloud.shape[1] != 3
            or prev.shape[1:] != (N, 3) or accepted.shape != (C,)
            or not 0 <= start <= start + count <= lo_cloud.shape[0]):
        raise ValueError("post_points: bad shapes or range")
    build.require_cuda("post_points", lo_cloud, prev, coords_m, accepted)
    dev = lo_cloud.device
    out = torch.empty(count, dtype=torch.uint8, device=dev)
    if count == 0:
        return out
    chunks = point_chunks(prev.shape[0] + C, N)
    part = torch.empty(chunks * count + 1, dtype=torch.float64, device=dev)
    build.launch(
        build.library().mad_post_points, dev, lo_cloud.data_ptr(),
        int(start), int(count), prev.data_ptr(), prev.shape[0],
        coords_m.data_ptr(), accepted.data_ptr(), C, N, float(anchor_dist),
        chunks, part.data_ptr(), out.data_ptr())
    point_launches += 1
    return out


def post_rows(lo_rows: torch.Tensor, lo_cloud: torch.Tensor,
              elig_pt: torch.Tensor, prev: torch.Tensor,
              coords_m: torch.Tensor, accepted: torch.Tensor,
              anchor_dist: float, start: int, count: int) -> torch.Tensor:
    """Stage 5 for table rows start .. start + count - 1, each taking its
    map anchor's point answer (elig_pt, every point's) or, off the cloud,
    measured itself: (count,) uint8, 1 where eligible."""
    if lo_rows.device.type == "cpu":
        return post_rows_plain(lo_rows, lo_cloud, elig_pt, prev, coords_m,
                               accepted, anchor_dist, start, count)
    global row_launches
    lo_rows, lo_cloud, prev, accepted = _f64(lo_rows, lo_cloud, prev,
                                             accepted)
    coords_m = coords_m.to(torch.float32).contiguous()
    elig_pt = elig_pt.to(torch.uint8).contiguous()
    C, N = coords_m.shape[:2]
    B = lo_cloud.shape[0]
    if (lo_rows.dim() != 2 or lo_rows.shape[1] != 3
            or lo_cloud.shape != (B, 3) or elig_pt.shape != (B,)
            or prev.shape[1:] != (N, 3) or accepted.shape != (C,)
            or not 0 <= start <= start + count <= lo_rows.shape[0]):
        raise ValueError("post_rows: bad shapes or range")
    build.require_cuda("post_rows", lo_rows, lo_cloud, elig_pt, prev,
                       coords_m, accepted)
    dev = lo_rows.device
    out = torch.empty(count, dtype=torch.uint8, device=dev)
    if count == 0:
        return out
    build.launch(
        build.library().mad_post_rows, dev, lo_rows.data_ptr(), int(start),
        int(count), lo_cloud.data_ptr(), B, elig_pt.data_ptr(),
        prev.data_ptr(), prev.shape[0], coords_m.data_ptr(),
        accepted.data_ptr(), C, N, float(anchor_dist), out.data_ptr())
    row_launches += 1
    return out


def post_compact(row_flag: torch.Tensor, n_top: int) -> torch.Tensor:
    """Stage 6: (1 + n_top,) float64, the number of rows taken (the first
    n_top flagged, in order), then the rows, -1 past them."""
    if row_flag.device.type == "cpu":
        return post_compact_plain(row_flag, n_top)
    global compact_launches
    row_flag = row_flag.to(torch.uint8).contiguous()
    if row_flag.dim() != 1 or n_top < 0:
        raise ValueError("post_compact: bad shapes")
    build.require_cuda("post_compact", row_flag)
    if row_flag.data_ptr() % 16:        # the kernel's 16-byte loads
        row_flag = row_flag.clone()
    out = torch.empty(1 + n_top, dtype=torch.float64, device=row_flag.device)
    build.launch(build.library().mad_post_compact, row_flag.device,
                 row_flag.data_ptr(), row_flag.shape[0], int(n_top),
                 out.data_ptr())
    compact_launches += 1
    return out


# -- the round ----------------------------------------------------------------

PLAIN = dict(lanes=post_lanes_plain, dedup=post_dedup_plain,
             fold=post_lanes_dedup_plain, points=post_points_plain,
             rows=post_rows_plain, compact=post_compact_plain)


def _round(stage, rot_m, trans_m, coords_m, failed, cand_rot, cand_hi,
           cand_lo, x0, hi_cloud, lo_cloud, prev, idx, hit_thresh,
           dedup_rmsd, lo_rows, anchor_dist, n_top, mesh):
    """The round's vector from the stage functions ``stage`` (name ->
    function), the lane, point and row stages over ``mesh``'s shards;
    without one the lanes and the dedup in one call (``fold``), the point
    and row stages on one block on the inputs' device."""
    home = coords_m.device
    shards = mesh or Mesh((home,))
    C, B = coords_m.shape[0], lo_cloud.shape[0]
    P = lo_rows.shape[0] if n_top > 0 else 0
    if mesh is None:
        s_a, hits, counts, accepted, slot = stage["fold"](
            rot_m, trans_m, coords_m, failed, cand_rot, cand_hi, cand_lo,
            x0, hi_cloud, lo_cloud, prev, idx, hit_thresh, dedup_rmsd)
    else:
        lane_in = replicate(shards, lambda d: tuple(t.to(d) for t in (
            rot_m, trans_m, failed, cand_rot, cand_hi, cand_lo, x0,
            hi_cloud, lo_cloud)))
        s_a, hits, counts = map_rows(
            shards, C, lambda d, a, e: stage["lanes"](*lane_in[d],
                                                      hit_thresh, a, e - a))
        accepted, slot = stage["dedup"](coords_m, failed, counts, prev, idx,
                                        dedup_rmsd)
    row_flag = torch.zeros(0, dtype=torch.uint8, device=home)
    if P > 0:
        atoms = replicate(shards, lambda d: tuple(t.to(d) for t in (
            lo_cloud, prev, coords_m, accepted)))
        elig_pt = map_rows(shards, B, lambda d, a, e: stage["points"](
            *atoms[d], anchor_dist, a, e - a))
        rows_in = replicate(shards, lambda d: (lo_rows.to(d),
                                               elig_pt.to(d)))
        row_flag = map_rows(shards, P, lambda d, a, e: stage["rows"](
            rows_in[d][0], atoms[d][0], rows_in[d][1], *atoms[d][1:],
            anchor_dist, a, e - a))
    return torch.cat([s_a.reshape(-1), hits.reshape(-1), counts, accepted,
                      slot, stage["compact"](row_flag, n_top)])


def post_plain(rot_m, trans_m, coords_m, failed, cand_rot, cand_hi,
               cand_lo, x0, hi_cloud, lo_cloud, prev, idx, hit_thresh,
               dedup_rmsd, lo_rows, anchor_dist, n_top, mesh=None):
    return _round(PLAIN, rot_m, trans_m, coords_m, failed, cand_rot,
                  cand_hi, cand_lo, x0, hi_cloud, lo_cloud, prev, idx,
                  hit_thresh, dedup_rmsd, lo_rows, anchor_dist, n_top, mesh)


def post(rot_m: torch.Tensor, trans_m: torch.Tensor, coords_m: torch.Tensor,
         failed: torch.Tensor, cand_rot: torch.Tensor, cand_hi: torch.Tensor,
         cand_lo: torch.Tensor, x0: torch.Tensor, hi_cloud: torch.Tensor,
         lo_cloud: torch.Tensor, prev: torch.Tensor, idx: torch.Tensor,
         hit_thresh: float, dedup_rmsd: float, lo_rows: torch.Tensor,
         anchor_dist: float, n_top: int,
         mesh: Mesh = None) -> torch.Tensor:
    """The round's post-refine vector (module docstring) on coords_m's
    device, the lane and eligibility stages over ``mesh``'s shards.

    From K15: rot_m (C, 3, 3), trans_m (C, 3), coords_m (C, N, 3) float32
    and failed (C,) bool. float64: the candidates' cand_rot (C, 3, 3),
    cand_hi / cand_lo (C, 3); x0 (N, 3) the subunit rounded to float32;
    hi_cloud (A, 3) and lo_cloud (B, 3) the anchor clouds; prev (S, N, 3)
    the earlier rounds' solutions; lo_rows (P, 3) the table's map anchors
    (read only when n_top > 0). idx (n,) int64 the RMSD atoms."""
    stages = dict(lanes=post_lanes, dedup=post_dedup, fold=post_lanes_dedup,
                  points=post_points, rows=post_rows, compact=post_compact)
    return _round(stages, rot_m, trans_m, coords_m, failed, cand_rot,
                  cand_hi, cand_lo, x0, hi_cloud, lo_cloud, prev, idx,
                  hit_thresh, dedup_rmsd, lo_rows, anchor_dist, n_top, mesh)
