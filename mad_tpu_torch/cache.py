"""Copied from mad_tpu/cache.py: the content-addressed descriptor cache
(``dsc_db/``), the matching cache (``dock_structure(match_cache=)``) and
the pose-search checkpoint (``pose_db/``). Where ``h5py`` imports, all
three are written as mad_tpu's HDF5 files, the same names, datasets,
types and attribute, so the port and mad_tpu (or MaD) reuse each other's
caches. Where it does not (it is not a dependency of the port), they are
numpy ``.npz`` files with the same names but the suffix and the same
keys. A file is read by its suffix: an ``.h5`` file needs ``h5py``, and a
failed read raises.

Parity with the reference's dsc_db/ store (mad/MaD.py:116-162, 848-875,
mad/Descriptor.py:226-254): same dataset names ('dsc', 'info', 'coords',
'rot') and the same parameter-string file naming, so cached runs short-cut
the describe pipeline identically.
"""

from __future__ import annotations

import hashlib
import os
from contextlib import contextmanager

import numpy as np

from .convert import descriptor_set_from_numpy
from .engine.pipeline import DescriptorSet


def suffix() -> str:
    """The suffix of the files this process writes: mad_tpu's ``.h5``
    where h5py imports, else ``.npz``."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return ".npz"
    return ".h5"


def _write(path: str, attrs: dict, arrays: dict) -> None:
    """The datasets ``arrays`` (and the scalar attributes ``attrs``) to an
    HDF5 file, or to an ``.npz`` file whose keys hold both."""
    if path.endswith(".h5"):
        import h5py
        with h5py.File(path, "w") as hf:
            for k, v in attrs.items():
                hf.attrs[k] = v
            for k, v in arrays.items():
                hf.create_dataset(k, data=v)
    else:
        np.savez(path, **{k: np.asarray(v) for k, v in attrs.items()},
                 **arrays)


@contextmanager
def _read(path: str):
    """(attrs, arrays) of a file written by _write: two mappings whose
    items read as numpy values."""
    if path.endswith(".h5"):
        import h5py
        with h5py.File(path, "r") as hf:
            yield ({k: hf.attrs[k] for k in hf.attrs},
                   {k: np.asarray(hf[k]) for k in hf})
    else:
        with np.load(path) as f:
            yield f, f


def cache_filename(db_dir: str, name: str, resolution: float, isovalue: float,
                   detect_sigma: float, presmooth_sigma: float,
                   patch_size: int, ori_eqsp: int, dsc_eqsp: int,
                   subregions: int) -> str:
    """Reference-compatible cache key (mad/MaD.py:118)."""
    return os.path.join(
        db_dir,
        f"{name}_res{resolution}_iso{isovalue}_detSig{detect_sigma}"
        f"_presmooth{presmooth_sigma}_patch{patch_size}_orieqsp{ori_eqsp}"
        f"_dsceqsp{dsc_eqsp}_subregions{subregions}{suffix()}")


def save_descriptors(ds: DescriptorSet, path: str) -> None:
    info = np.stack([
        ds.anchor_id, ds.main_bin, ds.sec_bin, ds.octave,
        np.full(ds.n, ds.eqsp_size), np.full(ds.n, ds.subeqsp_size),
    ], axis=1).astype(np.uint16)
    coords = np.stack([ds.coords.astype(np.float64), ds.map_coords,
                       ds.subv_coords], axis=1)
    _write(path, {}, dict(
        dsc=ds.desc[:ds.n].cpu().numpy().astype(np.int16), info=info,
        coords=coords, rot=ds.rfinal.astype(np.float64)))


def load_descriptors(path: str, name: str = "", device="cuda"
                     ) -> DescriptorSet:
    """The cached table as a DescriptorSet with its rows on ``device``."""
    with _read(path) as (_attrs, f):
        desc, info, coords, rot = f["dsc"], f["info"], f["coords"], f["rot"]
    n = desc.shape[0]
    return descriptor_set_from_numpy(
        desc, coords[:, 0].astype(np.float32), coords[:, 1], coords[:, 2],
        rot.astype(np.float32), info[:, 3].astype(np.int32),
        info[:, 0].astype(np.int32), info[:, 1].astype(np.int32),
        info[:, 2].astype(np.int32),
        eqsp_size=int(info[0, 4]) if n else 112,
        subeqsp_size=int(info[0, 5]) if n else 16,
        name=name or os.path.splitext(os.path.basename(path))[0],
        device=device)


def matching_filename(out_folder: str, key: str, cc_threshold: float,
                      weight_threshold: int, n_samples: int) -> str:
    """Reference-compatible matching-cache key (mad/MaD.py:387)."""
    return os.path.join(
        out_folder,
        f"matching_{key}_cc{cc_threshold:.2f}_w{weight_threshold}"
        f"_samples{n_samples}{suffix()}")


def save_matching(table, path: str) -> None:
    """Persist a MatchTable (working version of the reference's
    commented-out matching cache, mad/MaD.py:386-399, 877-889)."""
    _write(path, {}, dict(
        cc=table.cc, repeat=table.repeat, hi_idx=table.hi_idx,
        lo_idx=table.lo_idx, rot=table.rot, hi_coord=table.hi_coord,
        lo_coord=table.lo_coord, map_anchors=table.lo_cloud,
        comp_anchors=table.hi_cloud))


def load_matching(path: str):
    """The cached table as the port's MatchTable (host arrays), whichever
    package wrote it."""
    from .engine.match import MatchTable
    with _read(path) as (_attrs, f):
        return MatchTable(
            cc=f["cc"], repeat=f["repeat"], hi_idx=f["hi_idx"],
            lo_idx=f["lo_idx"], rot=f["rot"], hi_coord=f["hi_coord"],
            lo_coord=f["lo_coord"], hi_cloud=f["comp_anchors"],
            lo_cloud=f["map_anchors"])


# ---------------------------------------------------------------------------
# Pose-search checkpoint (SURVEY section 5, "failure detection" row:
# "optional checkpoint of pose search state"). The descriptor cache above
# resumes the describe stage; these resume the DOCK stage: a killed
# multi-subunit run reloads each completed subunit's solution set and
# continues at the first un-docked subunit (api.MaD._dock_one).
# ---------------------------------------------------------------------------

def solutions_filename(db_dir: str, map_name: str, key: str,
                       state_hash: str) -> str:
    return os.path.join(db_dir, f"solutions_{map_name}_{key}_"
                                f"{state_hash}{suffix()}")


def dock_state_hash(struct_coords: np.ndarray, n_copies: int,
                    resolution: float, isovalue: float, cfg) -> str:
    """Content hash of everything the dock result depends on: the processed
    subunit coordinates (decoy transform included) and the dock-relevant
    config trees. A changed knob or input invalidates the checkpoint."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(struct_coords, dtype=np.float64).tobytes())
    h.update(repr((n_copies, float(resolution), float(isovalue),
                   cfg.scalespace, cfg.detect, cfg.orient, cfg.describe,
                   cfg.match, cfg.filter, cfg.refine)).encode())
    return h.hexdigest()[:12]


def save_solutions(sols, path: str) -> None:
    """Persist a docked subunit's Solution list (engine/docking.Solution):
    refined coords, scores and the ragged corresp-anchor / member tables."""
    if not sols:
        _write(path, dict(n=0), {})
        return
    ca = [np.asarray(s.corresp_anchors, dtype=np.float64).reshape(-1, 3)
          for s in sols]
    mem = [np.asarray(m, dtype=np.float64) for s in sols for m in s.members]
    _write(path, dict(n=len(sols)), dict(
        coords=np.stack([s.structure.coords for s in sols]),
        scores=np.asarray([[s.repeat, float(s.weight), s.ccc, s.score]
                           for s in sols]),
        corresp=np.concatenate(ca), corresp_len=np.asarray([len(a)
                                                            for a in ca]),
        members=np.stack(mem) if mem else np.zeros((0, 8)),
        members_len=np.asarray([len(s.members) for s in sols])))


def load_solutions(path: str, struct):
    """Rebuild the Solution list against ``struct`` (the processed
    subunit)."""
    from .engine.docking import Solution
    with _read(path) as (attrs, f):
        n = int(attrs["n"])
        if n == 0:
            return []
        coords, scores = f["coords"], f["scores"]
        corresp, clen = f["corresp"], f["corresp_len"]
        members, mlen = f["members"], f["members_len"]
    sols = []
    co = mo = 0
    for i in range(n):
        sols.append(Solution(
            structure=struct.with_coords(coords[i]),
            corresp_anchors=corresp[co:co + clen[i]],
            repeat=float(scores[i, 0]), weight=int(scores[i, 1]),
            ccc=float(scores[i, 2]), score=float(scores[i, 3]),
            members=list(members[mo:mo + mlen[i]])))
        co += clen[i]
        mo += mlen[i]
    return sols
