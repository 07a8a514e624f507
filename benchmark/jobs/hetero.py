"""A heteromer's whole fit: the map of the pool that the job's turn names
described (``describe_grid``), each kind's decoy described
(``describe_structure``) and docked with its copies against that one
described map (``dock_structure``), then, where two or more kinds have
solutions, the assembly of those kinds: each kind's subcomplexes
(``engine/assemble.subcomplexes``) and their cartesian product ranked and
scored (``build_heteromer``), the chain of ``MaD.build_assembly`` on
solutions in memory."""

LAYERS = ("rows", "dock", "hetero_assembly")


def groups(cell):
    return cell.n_maps


def setup(cell):
    if not hasattr(cell.program.assemble, "build_heteromer"):
        raise RuntimeError(
            "the program has no engine/assemble.build_heteromer: it cannot "
            "assemble a heteromer from solutions in memory")


def subunit(cell, group, rng):
    return group, 0, [c.mol for c in cell.maps[group].components]


def run(cell, map_index, structs, span, timings):
    p, cfg, dev = cell.program, cell.cfg, cell.device
    grid = cell.grids[map_index]
    res = cell.system["resolution"]
    kinds = cell.maps[map_index].components
    with span("describe_map"):
        map_set = p.describe_grid(grid, cfg, name="map", device=dev)
    with span("describe_subunit"):
        sub_sets = [p.describe_structure(s, res, grid.voxsp, cfg,
                                         name="subunit", device=dev)
                    for s in structs]
    comps = []
    with span("dock"):
        for kind, struct, sub_set in zip(kinds, structs, sub_sets,
                                         strict=True):
            cands = []
            sols = p.dock_structure(map_set, sub_set, struct, grid, res, cfg,
                                    n_copies=kind.n_copies, verbose=False,
                                    on_filtered=cands.extend, device=dev,
                                    timings=timings)
            comps.append(dict(kind=kind.kind, n_copies=kind.n_copies,
                              sub_set=sub_set, candidates=cands, sols=sols))
    models = []
    docked = [c for c in comps if c["sols"]]
    if len(docked) >= 2:
        with span("assembly"):
            models = assemble(cell, docked, grid)
    return dict(map_set=map_set, components=comps, models=models)


def assemble(cell, docked, grid):
    asm, acfg, dev = cell.program.assemble, cell.cfg.assembly, cell.device
    max_overlap = cell.traffic["max_overlap"]
    groups = {
        str(c["kind"]): asm.subcomplexes(
            [s.structure for s in c["sols"]], c["n_copies"], acfg,
            max_overlap, dev).structures
        for c in docked}
    models, _structures = asm.build_heteromer(
        groups, grid, acfg, cell.traffic["max_models"], max_overlap, dev)
    asm.pop_enum_notes()
    return models
