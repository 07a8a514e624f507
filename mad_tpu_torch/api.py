"""MaD session API on the card (port of mad_tpu/api.py).

Parity with mad/MaD.py class MaD (:25-286): ``add_map``, ``add_subunit``,
``run``, ``build_assembly``, ``score_ensembles`` and the same artifact
contract (results/<...> tree, dsc_db cache, Solutions_refined_*.csv,
individual_solutions/sol_*.pdb, assembly_models/Model_*.pdb,
complex_ranking.csv, anchor debug dumps), plus mad_tpu's pose_db
checkpoint. The caches are mad_tpu's HDF5 files where ``h5py`` imports,
``.npz`` files of the same names and keys otherwise
(mad_tpu_torch/cache.py).

The session runs on ``device`` (the card unless the caller names another)
or, with ``mesh`` (mad_tpu/api.py:71-82: None, "auto" for one mesh over
all cards, or a ``parallel.mesh.Mesh``), on the mesh: the describe stage
in capacity mode (``engine.pipeline.describe_grid(..., mesh=)``) and the
dock sharded (``engine.docking.dock_structure(..., mesh=)``), everything
else on the mesh's home device. mad_tpu's warm start, describe thread pool
and ensemble frame groups exist for the TPU host and are not carried over.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

from . import cache as dsc_cache
from .core.config import MadConfig
from .core.eqsp import get_eqsp
from .core.grid import DensityGrid, read_map, write_mrc
from .core.structure import (Structure, parse_pdb, write_complex, write_pdb,
                             write_pseudo_pdb)
from .device import resolve
from .engine import assemble as asm
from .engine.docking import Solution, dock_structure
from .engine.pipeline import DescriptorSet, describe_grid, describe_structure
from .ops.simulate import simulate_density
from .parallel.mesh import auto_mesh, run_device
from .testing import decoy_transform


def _write_csv(path: str, rows, header) -> None:
    """CSV artifacts via the stdlib (same cell layout as the reference's
    pandas ``to_csv(index=False)``, without the optional dependency)."""
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(header)
        w.writerows(rows)


def _read_csv(path: str) -> List[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


class MaD:
    """Session object mirroring the reference's user API."""

    def __init__(self, workdir: str = ".", config: Optional[MadConfig] = None,
                 mesh=None, *, device=None):
        """device: where the pipeline runs; None means the card ("cuda"),
        and raises on a machine without one. mesh: None (one device),
        "auto" (a mesh over all cards, None below two) or a
        ``parallel.mesh.Mesh``; with a mesh the describe and dock stages
        shard over it and ``device`` is its home device (naming another
        raises)."""
        self.workdir = workdir
        self.config = config or MadConfig()
        if mesh == "auto":
            mesh = auto_mesh()
        self.mesh = mesh
        self.device = resolve(device if mesh is None
                              else run_device(mesh, device))
        self.input_map: Optional[str] = None
        self.input_subunits: Dict[str, list] = {}
        self.input_ensembles: Dict[str, dict] = {}
        self.processed_map: Optional[str] = None
        self.processed_subunits: Dict[str, list] = {}
        self.processed_ensembles: Dict[str, dict] = {}
        self.buildable_subunits: Dict[str, list] = {}
        self.solutions: Dict[str, List[Solution]] = {}
        self.out_folder: Optional[str] = None
        self.dmap: Optional[DensityGrid] = None
        self.map_dsc: Optional[DescriptorSet] = None
        self.dsc_dict: Dict[str, object] = {}
        # run() overwrites this from its kwarg; initialized here so the
        # preprocess surface (check_preprocess_data / get_descriptors) is
        # callable standalone (the reference only sets it inside run,
        # mad/MaD.py:91).
        self.transform_subunits: bool = False
        # Pre-refinement solution artifacts (pre_solutions/ +
        # Solutions_filtered_*.csv, mad/MaD.py:891-921). The reference's
        # call site is commented out (mad/MaD.py:404-405), so this defaults
        # to off; set to True to emit them.
        self.save_pre_solutions: bool = False
        # Pose-search checkpoint: each docked subunit's solution set
        # persists in pose_db/ (content-addressed: processed coords + dock
        # knobs), so an interrupted multi-subunit run resumes at the first
        # un-docked subunit. Companion of the dsc_db/ cache.
        self.pose_checkpoint: bool = True

    # ------------------------------------------------------------------
    # inputs (parity mad/MaD.py:46-85)
    # ------------------------------------------------------------------

    def add_subunit(self, sub_path: str, n_copies: int = 1,
                    identifier: str = "") -> None:
        assert os.path.exists(sub_path), f"MaD> subunit not found: {sub_path}"
        if os.path.isfile(sub_path):
            name = os.path.splitext(os.path.split(sub_path)[-1])[0]
            key = identifier or name
            if key in self.input_subunits:
                print(f"MaD> subunit {name} already added; overwriting")
            self.input_subunits[key] = [sub_path, n_copies]
            print(f"MaD> Added: subunit {sub_path}")
        elif os.path.isdir(sub_path):
            key = identifier or os.path.basename(os.path.normpath(sub_path))
            frames = sorted(
                os.path.join(sub_path, f) for f in os.listdir(sub_path)
                if f.split(".")[-1].lower() == "pdb")
            if not frames:
                print(f"MaD> No PDB files found in ensemble folder {sub_path}")
                return
            self.input_ensembles[key] = {}
            for frame in frames:
                fk = os.path.splitext(os.path.split(frame)[-1])[0]
                self.input_ensembles[key][fk] = [frame, n_copies]
            print(f"MaD> Added: ensemble {key} of {len(frames)} frames")
        else:
            print(f"MaD> Error: {sub_path} not a valid structure or ensemble")

    def add_map(self, input_map: str, resolution: float,
                isovalue: float = 0.0) -> None:
        assert os.path.exists(input_map), f"MaD> map not found: {input_map}"
        assert resolution > 0, "MaD> Map cannot have a negative resolution"
        self.resolution = resolution
        self.isovalue = isovalue
        self.input_map = input_map
        self.map_name = os.path.splitext(os.path.split(input_map)[-1])[0]
        print(f"MaD> Added: density map {self.map_name}, "
              f"resolution {resolution:.2f} A")

    # ------------------------------------------------------------------
    # main pipeline (parity mad/MaD.py:87-189)
    # ------------------------------------------------------------------

    def run(self, transform_subunits: bool = False, detect_sigma: float = 2.0,
            presmooth_sigma: float = 1.0, ori_eqsp_size: int = 112,
            dsc_eqsp_size: int = 16, dsc_subregions: int = 64,
            patch_size: int = 16, cc_threshold: float = 0.6,
            weight_threshold: int = 4, n_samples: int = 60) -> None:
        self.transform_subunits = transform_subunits
        # Rebuild from the session's own config so construction-time knobs
        # (rescue_rounds, refine/assembly tweaks) survive run().
        self.config = MadConfig.from_run_kwargs(
            detect_sigma, presmooth_sigma, ori_eqsp_size, dsc_eqsp_size,
            dsc_subregions, patch_size, cc_threshold, weight_threshold,
            n_samples, base=self.config)
        self.check_preprocess_data()
        if self.out_folder is None:
            return  # inputs incomplete; check_preprocess_data printed why
        self.get_descriptors()
        self.get_solutions()

    def check_preprocess_data(self) -> None:
        if self.input_map is None or not (
                len(self.input_subunits) + len(self.input_ensembles)):
            print("MaD> Make sure you have defined at least one component "
                  "and a density map")
            return
        self._prep_files_folders()

    def _dsc_path(self, name: str) -> str:
        cfg = self.config
        return dsc_cache.cache_filename(
            os.path.join(self.workdir, "dsc_db"), name, self.resolution,
            self.isovalue, cfg.scalespace.detect_sigma,
            cfg.scalespace.presmooth_sigma, cfg.orient.patch_size,
            cfg.orient.eqsp_size, cfg.describe.subeqsp_size,
            cfg.describe.subregions)

    def get_descriptors(self) -> None:
        # map
        path = self._dsc_path(self.map_name)
        if os.path.exists(path):
            self.map_dsc = dsc_cache.load_descriptors(path, self.map_name,
                                                      self.device)
            print(f"MaD> {self.map_dsc.n} descriptors for {self.map_name} "
                  "found in database")
        else:
            print(f"\nMaD> Processing map {self.map_name}")
            self.map_dsc = describe_grid(self.dmap, self.config,
                                         name=self.map_name,
                                         device=self.device, mesh=self.mesh)
            dsc_cache.save_descriptors(self.map_dsc, path)

        # subunits
        for k, (pdb_path, _n) in self.processed_subunits.items():
            path = self._dsc_path(k)
            if os.path.exists(path):
                ds = dsc_cache.load_descriptors(path, k, self.device)
                print(f"MaD> {ds.n} descriptors for {k} found in database")
            else:
                print(f"\nMaD> Processing subunit {k}")
                ds = self._describe_pdb(pdb_path, k)
                dsc_cache.save_descriptors(ds, path)
            self.dsc_dict[k] = ds

        # ensembles: store the cache path per frame (memory-friendly,
        # parity mad/MaD.py:158-162)
        for ek, ensemble in self.processed_ensembles.items():
            print(f"\nMaD> Describing ensemble {ek}")
            for fk, (pdb_path, _n) in ensemble.items():
                path = self._dsc_path(fk)
                if not os.path.exists(path):
                    print(f"MaD> Describing {ek}-{fk}")
                    dsc_cache.save_descriptors(
                        self._describe_pdb(pdb_path, fk), path)
                self.dsc_dict[fk] = path

    def get_solutions(self) -> None:
        for k, (pdb_path, n_copies) in self.processed_subunits.items():
            sols = self._dock_one(pdb_path, n_copies, k)
            if sols:
                self.buildable_subunits[k] = [
                    n_copies, [s for s in self.solutions[k + "_files"]]]
        for ek, ensemble in self.processed_ensembles.items():
            first = next(iter(ensemble.values()))
            self.buildable_subunits[ek] = [first[1], []]
            for fk, (pdb_path, n_copies) in ensemble.items():
                sols = self._dock_one(pdb_path, n_copies, fk)
                if sols:
                    self.buildable_subunits[ek][1].extend(
                        self.solutions[fk + "_files"])

    # ------------------------------------------------------------------
    # assembly (parity mad/MaD.py:192-223, 632-843)
    # ------------------------------------------------------------------

    def build_assembly(self, max_models: int = 10,
                       max_overlap_complex: float = 0.1) -> None:
        if not self.buildable_subunits:
            print("MaD> No solutions found. Please run() first or adjust "
                  "parameters if you did not get any solution.")
            return
        if sum(v[0] for v in self.buildable_subunits.values()) == 1:
            print("MaD> No assembly to build from a monomeric structure")
            return
        if len(self.buildable_subunits) == 1:
            key = next(iter(self.buildable_subunits))
            self._build_from_single(key, max_models, max_overlap_complex,
                                    homomultimer=True)
        else:
            sub_sol: Dict[str, List[str]] = {}
            for key in self.buildable_subunits:
                sub_sol[key] = self._build_from_single(
                    key, max_models, max_overlap_complex, homomultimer=False)
            self._build_models(sub_sol, max_models, max_overlap_complex)

    def _build_from_single(self, sub_key: str, max_models: int,
                           max_overlap: float, homomultimer: bool):
        acfg = self.config.assembly
        sub_dir = "assembly_models" if homomultimer else "subcomplexes"
        out_dir = os.path.join(self.out_folder, sub_dir)
        os.makedirs(out_dir, exist_ok=True)
        n_copies, sol_files = self.buildable_subunits[sub_key]
        if n_copies > len(sol_files):
            print(f"MaD> Not enough solutions to cover all copies for "
                  f"subunit {sub_key} !")
            print("     Maybe try increasing n_samples or reducing "
                  "min_cc/wthresh ?")
            n_copies = len(sol_files)
        structures = [parse_pdb(f) for f in sol_files]

        def report(overlap):
            self._print_overlap_table(overlap, sub_key)
            print(f"MaD> Assembling {n_copies} copies of chain {sub_key} "
                  f"from {len(sol_files)} solutions...")

        if not homomultimer:
            sub = asm.subcomplexes(structures, n_copies, acfg, max_overlap,
                                   self.device, on_overlap=report)
            asm.pop_enum_notes()
            valid = []
            for s_idx, tup, merged in zip(sub.ranks, sub.tuples,
                                          sub.structures):
                code = "_".join(f"{sub_key}{i}" for i in tup)
                out = os.path.join(
                    out_dir, f"SubComplex{sub_key}_{s_idx}_{code}.pdb")
                write_complex([merged], out)
                valid.append(out)
            if n_copies > 1:
                print(f"MaD> Generated {len(valid)} subcomplexes from "
                      f"component {sub_key}")
            return valid

        tuples, sums, stds, maxs = asm.rank_copies(
            structures, n_copies, acfg, self.device, on_overlap=report)
        enum_notes = asm.pop_enum_notes()
        models = asm.score_models(tuples, sums, stds, maxs, structures,
                                  self.dmap, acfg, max_models, max_overlap)
        self._report_models(models, out_dir, structures, enum_notes)

    def _build_models(self, sub_sol: Dict[str, List[str]], max_models: int,
                      max_overlap: float) -> None:
        print(f"MaD> Building assembly models from {len(sub_sol)} "
              "components...")
        models, structures = asm.build_heteromer(
            {key: [parse_pdb(f) for f in files]
             for key, files in sub_sol.items()},
            self.dmap, self.config.assembly, max_models, max_overlap,
            self.device, on_overlap=lambda overlap: self._print_overlap_table(
                overlap, "+".join(sub_sol)))
        enum_notes = asm.pop_enum_notes()
        out_dir = os.path.join(self.out_folder, "assembly_models")
        os.makedirs(out_dir, exist_ok=True)
        self._report_models(models, out_dir, structures, enum_notes)

    def _report_models(self, models, out_dir, structures,
                       enum_notes=()) -> None:
        header = "    # |   CC   | Sum(O) | Std(O) | Max(O) | Composition"
        print("MaD> Final models docked in map %s: \n" % self.map_name)
        print(header)
        print("-" * len(header))
        rows = []
        for i, m in enumerate(models):
            out = os.path.join(out_dir, f"Model_{i + 1}.pdb")
            write_complex([structures[j] for j in m.components], out)
            comp = ".".join(str(c) for c in m.components)
            print("  %3i | %6.2f  %6.2f   %6.2f   %6.2f  | %s" % (
                i + 1, m.ccc, m.sum_overlap, m.std_overlap, m.max_overlap,
                comp))
            rows.append([i + 1, m.ccc, m.sum_overlap, m.std_overlap,
                         m.max_overlap, [str(c) for c in m.components]])
        print("-" * len(header))
        if rows:
            path = os.path.join(self.out_folder, "complex_ranking.csv")
            _write_csv(
                path, rows,
                ["#", "CC", "Sum(O)", "Std(O)", "Max(O)", "Composition"])
            if enum_notes:
                # enumeration-restriction metadata as trailing comments so
                # a truncated search never reads as exhaustive
                with open(path, "a") as fh:
                    for note in enum_notes:
                        fh.write(f"# {note}\n")

    def _print_overlap_table(self, overlap, key) -> None:
        print(f"MaD> Pairwise overlaps between solutions of {key}:\n")
        for idx, row in enumerate(overlap):
            cells = "".join("   0  " if v == 0 else "%.3f " % v for v in row)
            print(f"{idx}.{key} | {cells}")
        print()

    # ------------------------------------------------------------------
    # ensembles (parity mad/MaD.py:225-286)
    # ------------------------------------------------------------------

    def score_ensembles(self):
        if not self.processed_ensembles:
            print("MaD> No ensembles were provided and/or processed")
            return
        rankings = {}
        for ek, ensemble in self.processed_ensembles.items():
            frames = sorted(ensemble.keys())
            per_frame: Dict[str, List[dict]] = {}
            for fk in frames:
                path = os.path.join(self.out_folder,
                                    f"Solutions_refined_{fk}.csv")
                if not os.path.exists(path):
                    continue
                per_frame[fk] = _read_csv(path)
            if not per_frame:
                print(f"MaD> No solutions for ensemble {ek}")
                continue

            def mean(fk, col):
                vals = [float(r[col]) for r in per_frame.get(fk, [])]
                return sum(vals) / len(vals) if vals else float("nan")

            ranking = [
                [fk, mean(fk, "Repeatability"), mean(fk, "Weight"),
                 mean(fk, "mCC"), mean(fk, "RWmCC")]
                for fk in frames]
            rankings[ek] = ranking
            names = ["Repeatability", "Weight", "Cross-corr.", "MaD score"]
            print(f"MaD> Ranking for ensemble {ek}: ")
            for col, nm in enumerate(names, start=1):
                top = sorted(ranking, key=lambda r: r[col], reverse=True)
                print(f"     Top 3 - {nm}:")
                for i in range(min(3, len(top))):
                    print("     %i: %6.2f %s" % (i + 1, top[i][col],
                                                 top[i][0]))
            self._plot_ensemble(ranking)
        return rankings

    def _plot_ensemble(self, ranking) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as mplot
        except ImportError:
            return
        fig, axes = mplot.subplots(nrows=1, ncols=4, figsize=(12, 5))
        names = ["Avg. R", "Avg. |clust|", "Avg. CC", "Avg. S"]
        n_bars = len(ranking) + 1
        for ax, col, nm in zip(axes, range(1, 5), names):
            ax.bar(range(1, n_bars), [r[col] for r in ranking])
            ax.set_xticks(range(1, n_bars))
            ax.set_xticklabels([f"C{i}" for i in range(1, n_bars)],
                               rotation=90)
            ax.set_title(nm)
        mplot.tight_layout()
        mplot.savefig(os.path.join(self.out_folder,
                                   "Plot_score_ensemble.png"), dpi=600)
        mplot.close(fig)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _prep_files_folders(self) -> None:
        results = os.path.join(self.workdir, "results")
        os.makedirs(results, exist_ok=True)
        os.makedirs(os.path.join(self.workdir, "dsc_db"), exist_ok=True)
        sub_keys = [f"{k}x{self.input_subunits[k][1]}"
                    for k in sorted(self.input_subunits)]
        ens_keys = [
            f"{k}x{next(iter(self.input_ensembles[k].values()))[1]}"
            for k in sorted(self.input_ensembles)]
        comp = ".".join(sub_keys + ens_keys)
        out = os.path.join(
            results,
            f"{self.map_name}_{comp}_res{self.resolution:.3f}"
            f"_iso{self.isovalue:.3f}")
        if os.path.exists(out):
            idx = 1
            while os.path.exists(f"{out}_{idx}"):
                idx += 1
            out = f"{out}_{idx}"
        os.makedirs(out)
        self.out_folder = out
        print(f"MaD> Created output folder: {out}")
        init_path = os.path.join(out, "initial_files")
        os.makedirs(init_path)

        ext = os.path.splitext(self.input_map)[-1].lower()
        if ext in (".sit", ".situs", ".mrc", ".map"):
            g = read_map(self.input_map, isovalue=self.isovalue,
                         device=self.device)
            g = g.reduce_void()
            self.voxsp = g.voxsp
            self.processed_map = os.path.join(init_path,
                                              f"{self.map_name}_mad.mrc")
            write_mrc(g, self.processed_map)
            self.dmap = g
        elif ext == ".pdb":
            print(f"MaD> PDB provided for density map: {self.input_map}")
            print("     Simulating at specified resolution and voxel "
                  "spacing of 1.2 angstroms")
            self.voxsp = 1.2
            struct = parse_pdb(self.input_map)
            g = simulate_density(struct, self.resolution, self.voxsp,
                                 device=self.device,
                                 shape_bucket=self.config.shape_bucket)
            self.processed_map = os.path.join(
                init_path, f"{self.map_name}_simulated_map.mrc")
            write_mrc(g, self.processed_map)
            self.dmap = g
        else:
            print("MaD> ERROR: density map not understood: %s"
                  % self.input_map)
            return

        for k, (pdb_path, n_copies) in self.input_subunits.items():
            struct = parse_pdb(pdb_path)
            if self.transform_subunits:
                struct = decoy_transform(struct)
            out_name = os.path.join(init_path, f"{k}.pdb")
            write_pdb(struct, out_name)
            self.processed_subunits[k] = [out_name, n_copies]

        for ek, ensemble in self.input_ensembles.items():
            self.processed_ensembles[ek] = {}
            for fk, (pdb_path, n_copies) in ensemble.items():
                struct = parse_pdb(pdb_path)
                if self.transform_subunits:
                    struct = decoy_transform(struct)
                out_name = os.path.join(init_path,
                                        os.path.split(pdb_path)[-1])
                write_pdb(struct, out_name)
                self.processed_ensembles[ek][fk] = [out_name, n_copies]

    def _describe_pdb(self, pdb_path: str, name: str) -> DescriptorSet:
        return describe_structure(parse_pdb(pdb_path), self.resolution,
                                  self.voxsp, self.config, name=name,
                                  device=self.device, mesh=self.mesh)

    def _dock_one(self, pdb_path: str, n_copies: int, k: str
                  ) -> List[Solution]:
        cfg = self.config
        struct = parse_pdb(pdb_path)
        # Pose-search checkpoint: a completed subunit's solution set
        # persists in pose_db/, content-addressed by the processed coords +
        # dock-relevant knobs, so a killed multi-subunit run resumes at the
        # first un-docked subunit.
        ckpt = None
        if self.pose_checkpoint:
            db = os.path.join(self.workdir, "pose_db")
            os.makedirs(db, exist_ok=True)
            ckpt = dsc_cache.solutions_filename(
                db, self.map_name, k,
                dsc_cache.dock_state_hash(struct.coords, n_copies,
                                          self.resolution, self.isovalue,
                                          cfg))
            if os.path.exists(ckpt):
                sols = dsc_cache.load_solutions(ckpt, struct)
                print(f"MaD> {len(sols)} docked solution(s) for {k} found "
                      "in pose checkpoint")
                self.solutions[k] = sols
                self.solutions[k + "_files"] = \
                    self._save_solutions_refined(sols, k)
                return sols
        ds = self.dsc_dict[k]
        if isinstance(ds, str):
            ds = dsc_cache.load_descriptors(ds, k, self.device)
        print(f"MaD> Matching descriptors ({self.map_name} vs. {k}) "
              f"(cc = {cfg.match.cc_threshold:.2f})...")
        on_filtered = None
        if self.save_pre_solutions:
            def on_filtered(cands):
                self._save_solutions_filtered(cands, struct, k)
        sols = dock_structure(self.map_dsc, ds, struct, self.dmap,
                              self.resolution, cfg, n_copies=n_copies,
                              verbose=True, device=self.device,
                              on_filtered=on_filtered, mesh=self.mesh)
        if ckpt is not None:
            dsc_cache.save_solutions(sols, ckpt)
        self.solutions[k] = sols
        files = self._save_solutions_refined(sols, k)
        self.solutions[k + "_files"] = files
        return sols

    def _save_solutions_filtered(self, candidates, struct: Structure,
                                 sub_key: str) -> List[str]:
        """Pre-refinement solutions: pre_solutions/presol_*.pdb, oriented
        anchor dumps and Solutions_filtered_<key>.csv
        (parity mad/MaD.py:891-921)."""
        sol_path = os.path.join(self.out_folder, "pre_solutions")
        os.makedirs(sol_path, exist_ok=True)
        header = "|   # |   dCC  | Repeat |   W |    R*W   |"
        sep = "-" * len(header)
        print("\n" + sep + "\n" + header + "\n" + sep)
        rows, files = [], []
        x0 = struct.coords
        for idx, c in enumerate(candidates):
            fname = os.path.join(sol_path, f"presol_{sub_key}_{idx}.pdb")
            coords = (x0 - c.hi_coord) @ c.rot.T + c.lo_coord
            write_pdb(struct.with_coords(coords), fname)
            files.append(fname)
            self._save_oriented_anchors(c.members, sol_path,
                                        f"{sub_key}_{idx}")
            print("| %3i |  %5.3f |  %5.2f | %3i |  %7.2f |"
                  % (idx, c.cc, c.repeat, c.weight, c.score))
            rows.append([idx, c.cc, c.repeat, c.weight, c.score])
        print(sep + "\n")
        if rows:
            _write_csv(
                os.path.join(self.out_folder,
                             f"Solutions_filtered_{sub_key}.csv"),
                rows, ["ID", "dCC", "Repeatability", "Weight", "RW"])
        return files

    def _save_solutions_refined(self, sols: List[Solution], sub_key: str
                                ) -> List[str]:
        sol_path = os.path.join(self.out_folder, "individual_solutions")
        os.makedirs(sol_path, exist_ok=True)
        anchor_path = os.path.join(sol_path, "anchor_files")
        os.makedirs(anchor_path, exist_ok=True)
        header = "|  # | Repeat | Weight |   mCC  |  RWmCC |"
        sep = "-" * len(header)
        print("\n" + sep + "\n" + header + "\n" + sep)
        rows, files = [], []
        for idx, s in enumerate(sols):
            fname = os.path.join(sol_path, f"sol_{sub_key}_{idx}.pdb")
            write_pdb(s.structure, fname)
            files.append(fname)
            write_pseudo_pdb(
                s.corresp_anchors,
                os.path.join(anchor_path,
                             f"corresp_anchors_{sub_key}_{idx}.pdb"),
                res_name="EPC", chain="E")
            self._save_oriented_anchors(s.members, anchor_path,
                                        f"{sub_key}_{idx}")
            print("| %2i | %6.2f | %6i | %6.2f | %6.2f |"
                  % (idx, s.repeat, s.weight, s.ccc, s.score))
            rows.append([idx, s.repeat, s.weight, s.ccc, s.score])
        print(sep + "\n")
        if rows:
            _write_csv(
                os.path.join(self.out_folder,
                             f"Solutions_refined_{sub_key}.csv"),
                rows, ["ID", "Repeatability", "Weight", "mCC", "RWmCC"])
        return files

    def _save_oriented_anchors(self, members, anchor_path, identifier):
        """Anchor + orientation debug dumps (mad/MaD.py:1016-1089)."""
        eqsp = get_eqsp(self.config.orient.eqsp_size)
        members = list(members)
        if not members:
            return
        arr = np.asarray(members)
        for off, bidx, target in ((0, 6, "hi"), (3, 7, "lo")):
            coords = arr[:, off:off + 3]
            bins = arr[:, bidx].astype(int)
            write_pseudo_pdb(
                coords,
                os.path.join(anchor_path,
                             f"anchor_{target}_{identifier}.pdb"),
                res_name="ANC", chain="A",
                bfactors=np.arange(len(arr)) / len(arr), elem="C")
            # raw-array dump next to the pseudo-PDB (the reference saves
            # both, mad/Detector.py:47-49,135-136): columns x, y, z, bin
            np.save(os.path.join(anchor_path,
                                 f"anchor_{target}_{identifier}.npy"),
                    np.concatenate([coords, bins[:, None]], axis=1))
            ori = coords - eqsp.c_centers[bins] * 10.0
            with open(os.path.join(
                    anchor_path,
                    f"anchor_ori_{target}_{identifier}.bld"), "w") as fh:
                fh.write(".color black\n")
                for c, o in zip(coords, ori):
                    fh.write(".arrow %f %f %f %f %f %f 0.2 1.0 0.75\n"
                             % (c[0], c[1], c[2], o[0], o[1], o[2]))
            if off == 0:
                # hi->lo correspondence cylinders (mad/MaD.py:1085-1089)
                los = arr[:, 3:6]
                with open(os.path.join(
                        anchor_path,
                        f"anchor_cor_{identifier}.bld"), "w") as fh:
                    fh.write(".color black\n")
                    for c, l in zip(coords, los):
                        fh.write(".cylinder %f %f %f %f %f %f 0.1 \n"
                                 % (c[0], c[1], c[2], l[0], l[1], l[2]))
