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

The CUDA kernel ``csrc/post.cu`` does this in one launcher (its note says
how); :func:`post_plain` is the plain PyTorch version. Both return one
float64 vector that :func:`split_post` cuts on the host: s_a (C, A, 3) |
hits (C, A) | counts (C) | accepted (C) | slot (C) | number of rows
taken | rows (n_top, -1 past them). ``slot`` is the lane's index in the
solution list: the new one it founds, or the one it merges into; -1 for a
skipped lane. A failed lane's s_a is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0            # kernel launches since the last reset


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


def post_plain(rot_m, trans_m, coords_m, failed, cand_rot, cand_hi,
               cand_lo, x0, hi_cloud, lo_cloud, prev, idx, hit_thresh,
               dedup_rmsd, lo_rows, anchor_dist, n_top):
    dev, f64 = coords_m.device, torch.float64
    C, N = coords_m.shape[:2]
    A_hi, S = hi_cloud.shape[0], prev.shape[0]
    failed = failed.to(torch.bool)

    # 1. composed poses and the moved subunit anchors
    A = cand_rot.to(f64).transpose(1, 2)
    b = cand_lo - _vecmat(cand_hi, A)
    center = (_vecmat(x0[None], A[:, None]) + b[:, None]).sum(dim=1) / N
    R, t = rot_m.to(f64), trans_m.to(f64)
    u = (_vecmat(hi_cloud[None], A[:, None]) + b[:, None]) - center[:, None]
    s_a = (_vecmat(u, R[:, None]) + center[:, None]) + t[:, None]
    s_a = torch.where(failed[:, None, None], torch.zeros_like(s_a), s_a)

    # 2. hits and counts
    if lo_cloud.shape[0]:
        near = _d2(s_a[:, :, None], lo_cloud[None, None]).amin(dim=2)
    else:
        near = torch.full((C, A_hi), float("inf"), dtype=f64, device=dev)
    hits = (near < hit_thresh * hit_thresh) & ~failed[:, None]
    counts = hits.sum(dim=1)

    # 3. RMSD of every lane to the earlier solutions and to every lane,
    # then the greedy scan in candidate order
    new = coords_m.to(f64)[:, idx]
    targets = torch.cat([prev[:, idx], new])
    rmat = (_d2(new[:, None], targets[None]).sum(dim=2)
            / idx.shape[0]).sqrt().tolist()
    ok = (~failed & (counts > 0)).tolist()
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

    # 4. rescue eligibility, per cloud point, then per row
    rows = torch.zeros(0, dtype=torch.int64, device=dev)
    if n_top > 0:
        acc = torch.as_tensor(accepted, dtype=torch.bool, device=dev)
        atoms = torch.cat([prev.reshape(-1, 3),
                           coords_m.to(f64)[acc].reshape(-1, 3)])
        ad2 = anchor_dist * anchor_dist
        elig_pt = ~(_min_d2(lo_cloud, atoms) < ad2)
        same = (lo_rows[:, None] == lo_cloud[None]).all(dim=2)
        found = same.any(dim=1)
        flag = torch.zeros(lo_rows.shape[0], dtype=torch.bool, device=dev)
        if lo_cloud.shape[0]:
            flag = elig_pt[same.to(torch.int8).argmax(dim=1)] & found
        flag[~found] = ~(_min_d2(lo_rows[~found], atoms) < ad2)
        rows = torch.nonzero(flag).flatten()[:n_top]

    pad = torch.full((n_top - rows.shape[0],), -1, dtype=torch.int64,
                     device=dev)
    return torch.cat([
        s_a.reshape(-1), hits.to(f64).reshape(-1), counts.to(f64),
        torch.as_tensor(accepted, dtype=f64, device=dev),
        torch.as_tensor(slot, dtype=f64, device=dev),
        torch.tensor([float(rows.shape[0])], dtype=f64, device=dev),
        torch.cat([rows, pad]).to(f64)])


def post(rot_m: torch.Tensor, trans_m: torch.Tensor, coords_m: torch.Tensor,
         failed: torch.Tensor, cand_rot: torch.Tensor, cand_hi: torch.Tensor,
         cand_lo: torch.Tensor, x0: torch.Tensor, hi_cloud: torch.Tensor,
         lo_cloud: torch.Tensor, prev: torch.Tensor, idx: torch.Tensor,
         hit_thresh: float, dedup_rmsd: float, lo_rows: torch.Tensor,
         anchor_dist: float, n_top: int) -> torch.Tensor:
    """The round's post-refine vector (module docstring).

    From K15: rot_m (C, 3, 3), trans_m (C, 3), coords_m (C, N, 3) float32
    and failed (C,) bool. float64: the candidates' cand_rot (C, 3, 3),
    cand_hi / cand_lo (C, 3); x0 (N, 3) the subunit rounded to float32;
    hi_cloud (A, 3) and lo_cloud (B, 3) the anchor clouds; prev (S, N, 3)
    the earlier rounds' solutions; lo_rows (P, 3) the table's map anchors
    (read only when n_top > 0). idx (n,) int64 the RMSD atoms."""
    if coords_m.device.type == "cpu":
        return post_plain(rot_m, trans_m, coords_m, failed, cand_rot,
                          cand_hi, cand_lo, x0, hi_cloud, lo_cloud, prev,
                          idx, hit_thresh, dedup_rmsd, lo_rows, anchor_dist,
                          n_top)
    global launches
    C, N = coords_m.shape[:2]
    A_hi, B, S = hi_cloud.shape[0], lo_cloud.shape[0], prev.shape[0]
    P = lo_rows.shape[0] if n_top > 0 else 0
    if (rot_m.shape != (C, 3, 3) or trans_m.shape != (C, 3)
            or coords_m.shape != (C, N, 3) or failed.shape != (C,)
            or cand_rot.shape != (C, 3, 3) or cand_hi.shape != (C, 3)
            or cand_lo.shape != (C, 3) or x0.shape != (N, 3)
            or hi_cloud.shape != (A_hi, 3) or lo_cloud.shape != (B, 3)
            or prev.shape != (S, N, 3) or idx.dim() != 1
            or lo_rows.dim() != 2 or lo_rows.shape[1] != 3
            or not 0 < idx.shape[0] <= N):
        raise ValueError("post: bad shapes")
    f32 = [t.to(torch.float32).contiguous()
           for t in (rot_m, trans_m, coords_m)]
    f64 = [t.to(torch.float64).contiguous()
           for t in (cand_rot, cand_hi, cand_lo, x0, hi_cloud, lo_cloud,
                     prev, lo_rows)]
    failed = failed.to(torch.uint8).contiguous()
    idx = idx.to(torch.int64).contiguous()
    build.require_cuda("post", *f32, failed, *f64, idx)
    dev = coords_m.device
    out = torch.empty(out_size(C, A_hi, n_top), dtype=torch.float64,
                      device=dev)
    rmat = torch.empty(C * (S + C), dtype=torch.float64, device=dev)
    lane_of = torch.empty(C, dtype=torch.int32, device=dev)
    elig_pt = torch.empty(B, dtype=torch.uint8, device=dev)
    row_flag = torch.empty(P, dtype=torch.uint8, device=dev)
    build.launch(
        build.library().mad_post, dev, *(t.data_ptr() for t in f32),
        failed.data_ptr(), *(t.data_ptr() for t in f64[:3]), C,
        f64[3].data_ptr(), N, f64[4].data_ptr(), A_hi, f64[5].data_ptr(), B,
        f64[6].data_ptr(), S, idx.data_ptr(), idx.shape[0], float(hit_thresh),
        float(dedup_rmsd), f64[7].data_ptr(), P, float(anchor_dist),
        int(n_top), rmat.data_ptr(), lane_of.data_ptr(), elig_pt.data_ptr(),
        row_flag.data_ptr(), out.data_ptr())
    launches += 1
    return out
