"""One conformer docked against a map described once in set-up and held,
as ``MaD.add_map`` holds it for a session: the conformer described
(``describe_structure``) and docked (``dock_structure``), no assembly.
Conformers come in turn: the true subunit, then ``deform_structure`` at
each of the traffic's ``scales``, the deformation drawn from the job's
own stream."""

from plainref import inputs

LAYERS = ("rows", "dock")


def groups(cell):
    return 1 + len(cell.traffic["scales"])


def setup(cell):
    cell.held = cell.program.describe_grid(cell.grids[0], cell.cfg,
                                           name="screen_map",
                                           device=cell.device)


def subunit(cell, group, rng):
    mol = cell.maps[0].sub
    if group:
        mol = inputs.deform_structure(mol, cell.traffic["scales"][group - 1],
                                      seed=int(rng.integers(1 << 31)))
    return 0, group, mol


def run(cell, map_index, struct, span, timings):
    p, cfg, dev = cell.program, cell.cfg, cell.device
    grid = cell.grids[map_index]
    with span("describe_subunit"):
        sub_set = p.describe_structure(struct, cell.system["resolution"],
                                       grid.voxsp, cfg, name="subunit",
                                       device=dev)
    cands = []
    with span("dock"):
        sols = p.dock_structure(cell.held, sub_set, struct, grid,
                                cell.system["resolution"], cfg,
                                n_copies=cell.system["n_copies"],
                                verbose=False, on_filtered=cands.extend,
                                device=dev, timings=timings)
    return dict(map_set=cell.held, sub_set=sub_set, candidates=cands,
                sols=sols)
