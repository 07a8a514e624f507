"""K6's zone lookup table against the full scan of the zones.

``kernels/orient.zone_table`` lists, for each phi slot (below the first
bound, on each sorted distinct 4-decimal phi bound, in each open gap
between them), the zones whose closed phi range meets the slot; the
kernel tests only the candidates of a direction's slot, with the same
strict tests as the full scan of ``core.geometry.zone_mask``. The table is
a superset if every zone that the full scan puts a direction in is a
candidate of its slot: checked here on 10^5 seeded directions and on
angles placed exactly on every phi and theta bound (and one float32 step
either side), at the orientation sphere (112 zones) and the descriptors'
(16). The angles are computed as the kernel computes them, in float32.
"""

import math

import numpy as np
import pytest
import torch

from mad_tpu_torch.core.eqsp import get_eqsp
from mad_tpu_torch.core.geometry import spherical_angles
from mad_tpu_torch.kernels.orient import zone_table
from mad_tpu_torch.ops.orient import ref_zone_bounds


def zone_slot(edges: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """The slot of each phi in a zone_table, as csrc/orient.cu's phi_slot
    finds it: 0 below the first bound or NaN, 2j + 1 on bound j, 2j + 2
    above it."""
    cnt = (edges <= phi[..., None]).sum(dim=-1)    # NaN: no bound <= it
    on = (cnt > 0) & (edges[torch.clamp(cnt - 1, min=0)] == phi)
    return torch.where(cnt == 0, torch.zeros_like(cnt),
                       torch.where(on, 2 * cnt - 1, 2 * cnt))


def in_zones(theta, phi, bounds):
    """The full scan: (n, Z) strict membership of zone_mask on the angles."""
    t, p = theta[:, None], phi[:, None]
    s = (theta + 2.0 * math.pi)[:, None]
    b = bounds
    return ((((t > b[:, 0]) & (t < b[:, 2])) | ((s > b[:, 0]) & (s < b[:, 2])))
            & (p > b[:, 1]) & (p < b[:, 3]))


def assert_superset(theta, phi, bounds):
    edges, start, cands = (torch.as_tensor(a) for a in zone_table(bounds))
    b = torch.as_tensor(bounds)
    hit = in_zones(theta, phi, b)                             # (n, Z)
    slot = zone_slot(edges, phi)
    cand = torch.zeros(len(start) - 1, b.shape[0], dtype=torch.bool)
    for s in range(len(start) - 1):
        cand[s, cands[start[s]:start[s + 1]].long()] = True
    missed = hit & ~cand[slot]
    assert not bool(missed.any()), (
        f"{int(missed.sum())} zone hits outside their slot's candidates")
    return int(hit.sum())


@pytest.mark.parametrize("size", [112, 16])
def test_table_holds_every_zone_of_random_directions(size):
    bounds = ref_zone_bounds(get_eqsp(size))
    rng = np.random.default_rng(size)
    d = rng.normal(size=(100_000, 3))
    d = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                        dtype=torch.float32)
    theta, phi = spherical_angles(d)
    assert assert_superset(theta, phi, bounds) > 90_000


@pytest.mark.parametrize("size", [112, 16])
def test_table_holds_every_zone_on_the_bounds(size):
    bounds = ref_zone_bounds(get_eqsp(size))
    step = lambda a, s: np.nextafter(a, s * np.inf, dtype=np.float32)
    phis = np.unique(np.concatenate([bounds[:, 1], bounds[:, 3]]))
    phis = np.unique(np.concatenate([phis, step(phis, 1), step(phis, -1),
                                     np.float32([0.0, math.pi])]))
    thetas = np.unique(np.concatenate([bounds[:, 0], bounds[:, 2]]))
    thetas = np.concatenate([thetas, step(thetas, 1), step(thetas, -1)])
    thetas = thetas[(thetas >= 0) & (thetas < 2 * math.pi)]
    # midpoints of every zone too, so that each zone is hit
    mid_t = (bounds[:, 0] + bounds[:, 2]) / 2
    mid_p = (bounds[:, 1] + bounds[:, 3]) / 2
    tt, pp = np.meshgrid(np.concatenate([thetas, mid_t % (2 * math.pi)]),
                         np.concatenate([phis, mid_p]), indexing="ij")
    theta = torch.as_tensor(tt.reshape(-1), dtype=torch.float32)
    phi = torch.as_tensor(pp.reshape(-1), dtype=torch.float32)
    hits = assert_superset(theta, phi, bounds)
    # every zone's midpoint lands in it
    assert hits >= bounds.shape[0]


def test_slots_follow_the_kernel_lookup():
    edges = torch.tensor([0.0, 0.5, 1.5], dtype=torch.float32)
    phi = torch.tensor([-1.0, 0.0, 0.2, 0.5, 1.0, 1.5, 2.0, float("nan")])
    assert zone_slot(edges, phi).tolist() == [0, 1, 2, 3, 4, 5, 6, 0]
    bounds = ref_zone_bounds(get_eqsp(112))
    edges, start, cands = zone_table(bounds)
    assert len(start) == 2 * len(edges) + 2
    # a gap holds one belt: at most the largest belt's 19 zones
    gaps = np.diff(start)[2::2]
    assert gaps.max() == 19
