"""A witness of the bench fit: a small JSON record of what a run computes
on bench.py's system (the map, the two DescriptorSets, the match table,
the solutions and the models) and on mad_tpu's ensemble bench (the
``score_ensembles`` rows and each conformer's solutions), and the
comparison of two such records under the bench's tolerances.

``scripts/torch_witness.py`` writes the port's record on the card into
``WITNESS``; ``chip_smoke.py`` holds every card run to it, and
``tests/test_torch_bench_parity_slow.py`` holds mad_tpu's CPU results to
it. The records take either package's objects (duck-typed: numpy or torch
arrays) and hold numpy arrays as zlib-compressed base64.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import zlib

import numpy as np

WITNESS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "torch_witness", "bench_h100.json")
MAP_SAMPLES, MAP_SEED = 4096, 0
MAP_TOL = 1e-5          # of the map's max (tests/test_torch_slice.py)
ROWS_EQUAL = 0.99       # K7's standing tolerance: rows with equal digests
MATCH_TOL = 1e-3        # A: a row of one run is a row of another if its
                        # anchor is this near (with the same octave, bins)
COORD_SCALE = 1e4       # anchors are kept as integers of 1e-4 A
REPEAT_TOL = 1e-4       # % (exact repeats are counts over the cloud)
POSE_TOL, POSE_MEDIAN = 0.5, 0.05   # A CA-RMSD, K15's gate
CCC_TOL = 1e-4
RECOVER_RMSD = 10.0     # A, bench.py's rule
DIGEST_BYTES = 4
EDGE_TOL = 1e-4         # voxel, K12's .5 rounding edges
ENSEMBLE_TOL = 1e-4     # of a score_ensembles value (means of the above)


def pack(a) -> dict:
    a = np.ascontiguousarray(a)
    return dict(dtype=a.dtype.str, shape=list(a.shape),
                zlib=base64.b64encode(zlib.compress(a.tobytes(), 9)
                                      ).decode())


def unpack(d: dict) -> np.ndarray:
    raw = zlib.decompress(base64.b64decode(d["zlib"]))
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"])


def host(a) -> np.ndarray:
    """A numpy copy of a numpy, JAX or torch array."""
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a)


def sha1(a) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def map_record(data) -> dict:
    """The map (float32): SHA-1 of its bytes, float64 sum, maximum and its
    values at MAP_SAMPLES voxels drawn with MAP_SEED."""
    d = np.ascontiguousarray(host(data), dtype=np.float32)
    idx = sample_voxels(d.size)
    return dict(shape=list(d.shape), sha1=sha1(d),
                sum=float(d.sum(dtype=np.float64)), max=float(d.max()),
                samples=pack(d.reshape(-1)[idx]))


def sample_voxels(size: int) -> np.ndarray:
    return np.sort(np.random.default_rng(MAP_SEED).choice(
        size, MAP_SAMPLES, replace=False))


def row_keys(ds) -> np.ndarray:
    return np.stack([ds.anchor_id, ds.octave, ds.main_bin, ds.sec_bin],
                    axis=1).astype(np.int32)


def row_digests(desc: np.ndarray) -> np.ndarray:
    """(n, DIGEST_BYTES) uint8: a SHA-1 prefix of each int16 row."""
    rows = np.ascontiguousarray(desc, dtype=np.int16)
    return np.array([np.frombuffer(hashlib.sha1(r.tobytes()).digest()
                                   [:DIGEST_BYTES], np.uint8) for r in rows]
                    ).reshape(-1, DIGEST_BYTES)


def set_record(ds) -> dict:
    """A DescriptorSet: per octave its anchors and rows, and per row its
    keys (anchor id, octave, main and secondary bin), its anchor (1e-4 A)
    and a digest of its int16 row."""
    n = ds.n
    octave = np.asarray(ds.octave[:n])
    octaves = {str(int(o)): dict(
        anchors=int(len(np.unique(np.asarray(ds.anchor_id[:n])[octave == o]))),
        rows=int((octave == o).sum())) for o in np.unique(octave)}
    return dict(n=int(n), octaves=octaves, keys=pack(row_keys(ds)[:n]),
                anchors=pack(np.round(np.asarray(ds.subv_coords[:n],
                                                 np.float64)
                                      * COORD_SCALE).astype(np.int64)),
                digests=pack(row_digests(host(ds.desc)[:n])))


def pair_keys(table) -> np.ndarray:
    return (np.asarray(table.hi_idx, np.int64) << 32) | np.asarray(
        table.lo_idx, np.int64)


def table_record(table, n_rows: int, approx=None) -> dict:
    """The match table: its pair count, a SHA-1 of its sorted pair set,
    its first ``n_rows`` rows (subunit row, map row, repeat) and, given
    ``approx`` (every pair's approximate repeat in the table's order), those
    as hit counts over the subunit cloud in the pair set's sorted order."""
    keys = pair_keys(table)
    out = dict(n=int(table.n), a_hi=int(len(table.hi_cloud)),
               a_lo=int(len(table.lo_cloud)), pairs_sha1=sha1(np.sort(keys)),
               head=dict(hi=pack(np.asarray(table.hi_idx[:n_rows], np.int32)),
                         lo=pack(np.asarray(table.lo_idx[:n_rows], np.int32)),
                         repeat=pack(np.asarray(table.repeat[:n_rows],
                                                np.float32))))
    if approx is not None:
        out["approx_counts"] = pack(approx_counts(
            np.asarray(approx)[np.argsort(keys, kind="stable")],
            len(table.hi_cloud)))
    return out


def approx_counts(rep: np.ndarray, a_hi: int) -> np.ndarray:
    return np.round(np.asarray(rep, np.float64) * max(a_hi, 1) / 100.0
                    ).astype(np.uint16)


def approx_all(table, dmap, match_cfg, device) -> np.ndarray:
    """The approximate repeatability of every pair of ``table`` as the
    port's match stage computes it (K11's field, K12) on ``device``."""
    import torch
    from .engine.match import anchor_voxels
    from .kernels.approx import approx_repeat
    from .kernels.field import anchor_field
    voxsp = float(dmap.voxsp)
    r_vox = max(1, int(round(match_cfg.anchor_dist / voxsp)))
    vox = torch.as_tensor(anchor_voxels(table.lo_cloud, dmap.origin, voxsp,
                                        dmap.shape), device=device)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=device)

    field = anchor_field(tuple(dmap.shape), vox, r_vox)
    rep = approx_repeat(field, vox, r_vox, f32(table.hi_cloud),
                        f32(dmap.origin), float(np.float32(1.0 / voxsp)),
                        f32(table.rot), f32(table.hi_coord),
                        f32(table.lo_coord))
    return rep.cpu().numpy()


def edge_pairs(table, origin, voxsp: float, chunk: int = 2048
               ) -> np.ndarray:
    """Per pair, whether a moved subunit anchor lies within EDGE_TOL voxel
    of a .5 rounding edge (float64)."""
    cloud = np.asarray(table.hi_cloud, np.float64)
    out = []
    for s in range(0, table.n, chunk):
        x = cloud[None] - np.asarray(table.hi_coord[s:s + chunk],
                                     np.float64)[:, None]
        y = (np.einsum("pad,ped->pae", x, np.asarray(table.rot[s:s + chunk],
                                                      np.float64))
             + np.asarray(table.lo_coord[s:s + chunk], np.float64)[:, None])
        v = (y - np.asarray(origin, np.float64)) / voxsp
        out.append((np.abs(v - np.floor(v) - 0.5) < EDGE_TOL).any(axis=(1, 2)))
    return np.concatenate(out) if out else np.zeros(0, bool)


def poses(sols, moved) -> np.ndarray:
    """(S, 4, 3) float64: each solution's rigid transform of the decoy,
    rows R (x @ R) and T (kabsch over all atoms)."""
    from .core.geometry import kabsch_np
    x0 = np.asarray(moved.coords, np.float64)
    out = np.zeros((len(sols), 4, 3))
    for i, s in enumerate(sols):
        R, T = kabsch_np(x0, np.asarray(s.structure.coords, np.float64))
        out[i, :3], out[i, 3] = R, T
    return out


def best_rmsds(sols, copies) -> list:
    return [min((s.structure.rmsd_ca_with(c) for s in sols),
                default=np.inf) for c in copies]


def solutions_record(sols, moved) -> list:
    p = poses(sols, moved)
    return [dict(pose=p[i].tolist(), repeat=float(s.repeat),
                 weight=int(s.weight), ccc=float(s.ccc))
            for i, s in enumerate(sols)]


def models_record(models) -> list:
    return [dict(components=[int(c) for c in m.components],
                 ccc=float(m.ccc)) for m in models]


def ensemble_record(rows, solutions: dict) -> dict:
    """``score_ensembles``' rows (name, Repeatability, Weight, mCC, RWmCC)
    and each conformer's solutions (repeat, weight, CCC), best first, from
    a session's ``solutions`` (its ``*_files`` entries left out)."""
    return dict(rows=[[str(r[0])] + [float(v) for v in r[1:]] for r in rows],
                solutions={k: [[float(s.repeat), int(s.weight),
                                float(s.ccc)] for s in v]
                           for k, v in sorted(solutions.items())
                           if not k.endswith("_files")})


def fit_record(dmap, map_set, sub_set, table, n_rows, sols, moved, copies,
               models, approx=None) -> dict:
    """The record of one bench fit: the map, both sets, the table (its
    first ``n_rows`` rows, ``approx`` as in ``table_record``), the decoy's
    SHA-1 (the poses are its transforms), the solutions, the copies
    recovered and the models."""
    rmsds = best_rmsds(sols, copies)
    return dict(
        map=map_record(dmap.data if hasattr(dmap, "data") else dmap),
        decoy_sha1=sha1(np.asarray(moved.coords, np.float64)),
        map_set=set_record(map_set), sub_set=set_record(sub_set),
        table=table_record(table, n_rows, approx),
        solutions=solutions_record(sols, moved),
        recovered=int(np.sum(np.asarray(rmsds) < RECOVER_RMSD)),
        copies=len(copies), models=models_record(models))


def dump(record: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


def load(path: str = None) -> dict:
    with open(path or WITNESS) as fh:
        return json.load(fh)


# -- holding one record to another ------------------------------------------

def _stage(name, ok, **numbers):
    return dict(stage=name, ok=bool(ok), **numbers)


def hold_map(w: dict, r: dict) -> dict:
    a, b = unpack(w["samples"]), unpack(r["samples"])
    same_shape = w["shape"] == r["shape"]
    err = float(np.abs(a.astype(np.float64) - b).max()) if same_shape \
        else np.inf
    return _stage("map", same_shape and err <= MAP_TOL * abs(w["max"])
                  and abs(w["max"] - r["max"]) <= MAP_TOL * abs(w["max"]),
                  same_bits=w["sha1"] == r["sha1"], max_err=err,
                  tol=MAP_TOL * abs(w["max"]), sum=(w["sum"], r["sum"]))


def match_rows(w: dict, r: dict) -> np.ndarray:
    """For each row of set record ``w``, the row of ``r`` with the same
    octave, main and secondary bin whose anchor is nearest, if within
    MATCH_TOL (one to one), else -1. Rows are matched by what they
    describe, not by position: a row more or less upstream shifts the
    positions and the anchor ids after it."""
    kw, kr = unpack(w["keys"]), unpack(r["keys"])
    aw, ar = unpack(w["anchors"]), unpack(r["anchors"])
    index = {}
    for j, k in enumerate(kr[:, 1:].tolist()):
        index.setdefault(tuple(k), []).append(j)
    out = np.full(len(kw), -1)
    used = np.zeros(len(kr), bool)
    for i, k in enumerate(kw[:, 1:].tolist()):
        js = [j for j in index.get(tuple(k), []) if not used[j]]
        if not js:
            continue
        d = np.abs(ar[js] - aw[i]).max(axis=1)
        if d.min() <= MATCH_TOL * COORD_SCALE:
            out[i] = js[int(d.argmin())]
            used[out[i]] = True
    return out


def hold_set(name: str, w: dict, r: dict, allow: int = None) -> dict:
    """Two set records: rows matched by ``match_rows`` (the same row count
    and keys in the same positions reported), their digests equal in
    >= ROWS_EQUAL of the larger set's rows, or, given ``allow``, at most
    that many rows unequal or unmatched."""
    match = match_rows(w, r)
    hit = match >= 0
    equal = (unpack(w["digests"])[hit]
             == unpack(r["digests"])[match[hit]]).all(axis=1)
    n = max(w["n"], r["n"], 1)
    differ = n - int(equal.sum())
    anchors = (np.abs(unpack(w["anchors"])[hit]
                      - unpack(r["anchors"])[match[hit]]).max(axis=1)
               if hit.any() else np.zeros(1))
    same_keys = w["n"] == r["n"] and np.array_equal(unpack(w["keys"]),
                                                    unpack(r["keys"]))
    ok = (differ <= allow) if allow is not None else \
        (equal.sum() / n >= ROWS_EQUAL)
    return _stage(name, ok, n=(w["n"], r["n"]),
                  octaves=(w["octaves"], r["octaves"]),
                  same_keys=same_keys, unmatched=int((~hit).sum()),
                  anchor_max=float(anchors.max() / COORD_SCALE),
                  rows_differ=differ, rows_equal=float(equal.sum() / n),
                  allow=allow)


def hold_table(w: dict, r: dict, sub_match=None, map_match=None) -> dict:
    """The same pair count; the rows of the head above its last repeat
    (ties at the cut may order either way) the same pairs with the same
    repeats, a pair of ``w`` taken to ``r``'s rows through ``sub_match``
    and ``map_match`` (``match_rows`` of the two sets; the identity by
    default). The pair sets (SHA-1 of the sorted row pairs) and, with both
    records' approximate counts over the same pair set, the pairs whose
    counts differ are reported."""
    out = dict(n=(w["n"], r["n"]), same_pairs=w["pairs_sha1"]
               == r["pairs_sha1"])
    hw, hr = w["head"], r["head"]
    hi, lo = unpack(hw["hi"]), unpack(hw["lo"])
    if sub_match is not None:
        hi, lo = sub_match[hi], map_match[lo]
    rep_w, rep_r = unpack(hw["repeat"]), unpack(hr["repeat"])
    mine = dict(zip(zip(unpack(hr["hi"]).tolist(), unpack(hr["lo"]).tolist()),
                    rep_r.tolist()))
    cut = max(float(rep_w[-1]) if len(rep_w) else 0.0,
              float(rep_r[-1]) if len(rep_r) else 0.0)
    above = rep_w > cut + REPEAT_TOL
    miss = sum(1 for k, v in zip(zip(hi[above].tolist(), lo[above].tolist()),
                                 rep_w[above].tolist())
               if k not in mine or abs(mine[k] - v) > REPEAT_TOL)
    out.update(head_rows=len(rep_w), head_above_cut=int(above.sum()),
               head_differ=miss)
    if "approx_counts" in w and "approx_counts" in r and out["same_pairs"]:
        out["approx_differ"] = int((unpack(w["approx_counts"])
                                    != unpack(r["approx_counts"])).sum())
    # the approximate counts are printed, not held: each record's come from
    # its own poses, whose last bits move anchors across .5 edges
    return _stage("table", w["n"] == r["n"] and not miss, **out)


def pose_coords(pose, ca: np.ndarray) -> np.ndarray:
    p = np.asarray(pose, np.float64)
    return ca @ p[:3] + p[3]


def hold_solutions(w: list, r: list, ca: np.ndarray,
                   recovered=(None, None)) -> dict:
    """Each solution of ``w`` paired with the nearest of ``r`` by CA-RMSD
    on the decoy's CA atoms ``ca``: one to one, each within POSE_TOL and
    their median within POSE_MEDIAN, the same weights and CCCs within
    CCC_TOL."""
    if len(w) != len(r) or not w:
        return _stage("solutions", False, n=(len(w), len(r)))
    cw = [pose_coords(s["pose"], ca) for s in w]
    cr = [pose_coords(s["pose"], ca) for s in r]
    d = np.array([[float(np.sqrt(np.square(a - b).sum(-1).mean()))
                   for b in cr] for a in cw])
    pair = d.argmin(axis=1)
    rms = d[np.arange(len(w)), pair]
    one_to_one = len(set(pair.tolist())) == len(w)
    weights = sum(w[i]["weight"] != r[j]["weight"] for i, j in
                  enumerate(pair))
    ccc = max(abs(w[i]["ccc"] - r[j]["ccc"]) for i, j in enumerate(pair))
    rank = int((pair != np.arange(len(w))).sum())
    full = recovered[0] is None or recovered[0] == recovered[1]
    return _stage("solutions", one_to_one and rms.max() <= POSE_TOL
                  and np.median(rms) <= POSE_MEDIAN and weights == 0
                  and ccc <= CCC_TOL and full, n=len(w),
                  rmsd_max=float(rms.max()), rmsd_median=float(np.median(rms)),
                  weights_differ=int(weights), ccc_max_diff=float(ccc),
                  rank_moves=rank, recovered=recovered)


def hold_models(w: list, r: list) -> dict:
    same = [a["components"] for a in w] == [b["components"] for b in r]
    ccc = max((abs(a["ccc"] - b["ccc"]) for a, b in zip(w, r)), default=0.0)
    return _stage("models", same and len(w) > 0 and ccc <= CCC_TOL,
                  n=(len(w), len(r)), same_tuples=same, ccc_max_diff=ccc)


def hold_fit(w: dict, r: dict, ca: np.ndarray, allow: dict = None
             ) -> list:
    """The stages of two fit records in pipeline order; ``allow``: set
    name -> rows that may differ (``hold_set``)."""
    allow = allow or {}
    sub, mp = (match_rows(w[k], r[k]) for k in ("sub_set", "map_set"))
    return [hold_map(w["map"], r["map"]),
            hold_set("map_set", w["map_set"], r["map_set"],
                     allow.get("map_set")),
            hold_set("sub_set", w["sub_set"], r["sub_set"],
                     allow.get("sub_set")),
            hold_table(w["table"], r["table"], sub, mp),
            _stage("decoy", w["decoy_sha1"] == r["decoy_sha1"]),
            hold_solutions(w["solutions"], r["solutions"], ca,
                           (w["recovered"], r["recovered"])),
            hold_models(w["models"], r["models"]),
            _stage("recovered", w["recovered"] == w["copies"]
                   and r["recovered"] == r["copies"],
                   recovered=(w["recovered"], r["recovered"]))]


def first_difference(stages: list):
    return next((s["stage"] for s in stages if not s["ok"]), None)


def ensemble_top(rows: list, col: int) -> str:
    return sorted(rows, key=lambda x: x[col], reverse=True)[0][0]


def hold_ensemble(w: dict, r: dict) -> dict:
    """Two ensemble records: the same conformers; each conformer's
    solutions in rank order with the same weights, repeats within
    REPEAT_TOL and CCCs within CCC_TOL; the four columns within ENSEMBLE_TOL
    of their size; the same conformer first by each column."""
    names = [x[0] for x in w["rows"]] == [x[0] for x in r["rows"]]
    cols = max((abs(a - b) / max(1.0, abs(a))
                for x, y in zip(w["rows"], r["rows"])
                for a, b in zip(x[1:], y[1:])), default=0.0)
    sols = {}
    for k, a in w["solutions"].items():
        b = r["solutions"].get(k, [])
        sols[k] = (len(a) == len(b) and all(
            p[1] == q[1] and abs(p[0] - q[0]) <= REPEAT_TOL
            and abs(p[2] - q[2]) <= CCC_TOL for p, q in zip(a, b)))
    tops = [(ensemble_top(w["rows"], c), ensemble_top(r["rows"], c))
            for c in range(1, 5)]
    return _stage("ensemble", names and cols <= ENSEMBLE_TOL
                  and all(sols.values()) and all(a == b for a, b in tops),
                  columns_max_rel_diff=cols, tops=tops,
                  conformers_differ=[k for k, v in sols.items() if not v])
