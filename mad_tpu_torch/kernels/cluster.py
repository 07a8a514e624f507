"""K14: greedy pose clustering and candidate selection.

Replaces mad_tpu/engine/dock_fused.py:50-129 (``_cluster_select_body``:
the scan, the weights, the gates and the candidate order) on the port's
split path, whose host version is ``engine/cluster.filter_pairs``. The
rows arrive in repeat order; row i joins the founded cluster with the
smallest closed-form cloud RMSD (the first on ties) unless that RMSD is
above ``rmsd_cloud`` or no cluster exists yet, then it founds one. As in
``filter_pairs`` the RMSD is taken in float64; the gates and the score
(repeat * weight) in float32, as numpy 2 and the JAX body take them.

The CUDA source ``csrc/cluster.cu`` takes every row's near test against
every earlier row in parallel, then finds the founders with one warp's
bit operations and assigns the other rows (its note says how; three
launches, one call); :func:`cluster_select_plain` is the plain PyTorch
version, the JAX body's masked scan over all slots in float64 with the
RMSD terms summed in the kernel's order.

Both return one int32 vector: assign (n) | founding row (n, -1 past the
clusters) | weight (n) | candidate slots by (score desc, slot asc) (n, -1
past the candidates) | number of clusters | number of candidates;
:func:`split_selection` cuts it on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0            # kernel launches since the last reset (3 a call)


def near_words(n: int) -> int:
    """Words of near bits a row in csrc/cluster.cu's scratch: one a 32-row
    tile, padded to a multiple of 4 for its 16-byte loads."""
    return 4 * -(-n // 128)


def gate_threshold(best_repeat, min_repeat: float, repeat_frac: float
                   ) -> float:
    """The repeat gate of ``filter_pairs``, max(min_repeat, best_repeat *
    repeat_frac), as the float32 value a float32 repeat is compared with
    (numpy 2 compares an np.float32 with a Python float in float32).
    best_repeat: the table's first repeat (np.float32: the product is
    taken in float32) or a Python float (the rescue round's)."""
    return float(np.float32(max(min_repeat, best_repeat * repeat_frac)))


def split_selection(sel: np.ndarray, n: int):
    """(assign, founding rows, weights, candidate slots, n_candidates) of
    a selection vector pulled to the host."""
    sel = np.asarray(sel)
    n_cl, n_cands = int(sel[4 * n]), int(sel[4 * n + 1])
    return (sel[:n], sel[n:n + n_cl], sel[2 * n:2 * n + n_cl],
            sel[3 * n:3 * n + n_cands], n_cands)


def _cloud_r2(CA, Cb, A, b, mu, M):
    """Closed-form squared cloud RMSD between the pose (A, b) and each
    cluster (CA, Cb): trace(D^T M D) + 2 mu . (D d) + |d|^2 with D = CA - A,
    d = Cb - b, each sum left to right."""
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


def cluster_select_plain(rot: torch.Tensor, hi: torch.Tensor,
                         lo: torch.Tensor, repeat: torch.Tensor,
                         mu: torch.Tensor, M: torch.Tensor,
                         rmsd_cloud: float, weight_threshold: int,
                         rep_thresh: float) -> torch.Tensor:
    n, dev = rot.shape[0], rot.device
    A = rot.to(torch.float64).transpose(1, 2)                  # R^T
    b = lo - ((hi[:, 0:1] * A[:, 0] + hi[:, 1:2] * A[:, 1])
              + hi[:, 2:3] * A[:, 2])                          # l - h @ R^T
    slots = torch.arange(n, device=dev)
    CA = torch.zeros((n, 3, 3), dtype=torch.float64, device=dev)
    Cb = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    found = torch.full((n,), -1, dtype=torch.int64, device=dev)
    assign = torch.empty(n, dtype=torch.int64, device=dev)
    n_cl = torch.zeros((), dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    for i in range(n):
        r2 = torch.where(slots < n_cl, _cloud_r2(CA, Cb, A[i], b[i], mu, M),
                         inf)
        j = torch.argmin(r2)
        new = (n_cl == 0) | (torch.sqrt(torch.clamp(r2[j], min=0.0))
                             > rmsd_cloud)
        slot = torch.where(new, n_cl, j)
        upd = new & (slots == slot)
        CA = torch.where(upd[:, None, None], A[i], CA)
        Cb = torch.where(upd[:, None], b[i], Cb)
        found = torch.where(upd, i, found)
        assign[i] = slot
        n_cl = n_cl + new.to(torch.int64)
    weights = torch.bincount(assign, minlength=n)
    rep = repeat.to(torch.float32)[found.clamp(min=0)]
    gate = ((slots < n_cl) & (weights >= weight_threshold)
            & ~(rep.to(torch.float64) < rep_thresh))
    score = rep * weights.to(torch.float32)
    order = torch.argsort(torch.where(gate, -score, torch.full_like(
        score, float("inf"))), stable=True)
    n_cands = gate.sum()
    cand = torch.where(slots < n_cands, order, torch.full_like(order, -1))
    return torch.cat([assign, found, weights, cand, n_cl.view(1),
                      n_cands.view(1)]).to(torch.int32)


def cluster_select(rot: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
                   repeat: torch.Tensor, mu: torch.Tensor, M: torch.Tensor,
                   rmsd_cloud: float, weight_threshold: int,
                   rep_thresh: float) -> torch.Tensor:
    """The selection vector of the first n rows of a repeat-ordered match
    table: rot (n, 3, 3) float32, hi / lo (n, 3) float64 pair anchors,
    repeat (n,) float32, mu (3,) and M (3, 3) float64 moments of the
    subunit cloud; rep_thresh from :func:`gate_threshold`."""
    if rot.device.type == "cpu":
        return cluster_select_plain(rot, hi, lo, repeat, mu, M, rmsd_cloud,
                                    weight_threshold, rep_thresh)
    global launches
    rot, repeat = (t.to(torch.float32).contiguous() for t in (rot, repeat))
    hi, lo, mu, M = (t.to(torch.float64).contiguous()
                     for t in (hi, lo, mu, M))
    build.require_cuda("cluster_select", rot, hi, lo, repeat, mu, M)
    n = rot.shape[0]
    if (rot.shape[1:] != (3, 3) or hi.shape != (n, 3) or lo.shape != (n, 3)
            or repeat.shape != (n,) or mu.shape != (3,)
            or M.shape != (3, 3)):
        raise ValueError("cluster_select: bad shapes")
    out = torch.empty(4 * n + 2, dtype=torch.int32, device=rot.device)
    if n == 0:
        return out.zero_()
    W = near_words(n)
    table = torch.empty(12 * n, dtype=torch.float64, device=rot.device)
    near = torch.empty(n * W + 1, dtype=torch.int32, device=rot.device)
    score = torch.empty(n, dtype=torch.float32, device=rot.device)
    lib = build.library()
    build.launch(
        lib.mad_cluster_select, rot.device, rot.data_ptr(), hi.data_ptr(),
        lo.data_ptr(), repeat.data_ptr(), mu.data_ptr(), M.data_ptr(), n,
        float(rmsd_cloud), int(weight_threshold), float(rep_thresh), W,
        table.data_ptr(), near.data_ptr(), score.data_ptr(), out.data_ptr())
    launches += 3           # cluster_near, cluster_scan, cluster_assign
    return out
