"""A whole fit: the map of the pool that the job's turn names described
(``describe_grid``), the decoy described (``describe_structure``), the
copies docked (``dock_structure``), the assembly built from two or more
solutions (their overlap, ``enumerate_homomultimer``, ``score_models``):
the chain of the repository's ``bench.py:run_fit``."""

LAYERS = ("rows", "dock", "assembly")


def groups(cell):
    return cell.n_maps


def setup(cell):
    pass


def subunit(cell, group, rng):
    return group, 0, cell.maps[group].sub


def run(cell, map_index, struct, span, timings):
    p, cfg, dev = cell.program, cell.cfg, cell.device
    grid = cell.grids[map_index]
    with span("describe_map"):
        map_set = p.describe_grid(grid, cfg, name="map", device=dev)
    with span("describe_subunit"):
        sub_set = p.describe_structure(struct, cell.system["resolution"],
                                       grid.voxsp, cfg, name="subunit",
                                       device=dev)
    cands = []
    with span("dock"):
        sols = p.dock_structure(map_set, sub_set, struct, grid,
                                cell.system["resolution"], cfg,
                                n_copies=cell.system["n_copies"],
                                verbose=False, on_filtered=cands.extend,
                                device=dev, timings=timings)
    models = []
    if len(sols) >= 2:
        with span("assembly"):
            models = assemble(cell, sols, grid)
    return dict(map_set=map_set, sub_set=sub_set, candidates=cands,
                sols=sols, models=models)


def assemble(cell, sols, grid):
    asm, cfg, dev = cell.program.assemble, cell.cfg, cell.device
    structures = [s.structure for s in sols]
    ov_dev = asm.device_overlap(structures, cfg.assembly, dev)
    overlap = asm.host_overlap(ov_dev)
    n_copies = cell.system["n_copies"]
    tuples, sums, stds, maxs = asm.enumerate_homomultimer(
        len(structures), min(n_copies, len(structures)), overlap,
        device=dev, overlap_dev=ov_dev)
    models = asm.score_models(tuples, sums, stds, maxs, structures, grid,
                              cfg.assembly, cell.traffic["max_models"],
                              cell.traffic["max_overlap"])
    asm.pop_enum_notes()
    return models
