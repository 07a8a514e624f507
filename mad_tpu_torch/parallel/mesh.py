"""Device meshes (port of mad_tpu/parallel/mesh.py:20-49).

mad_tpu's mesh is one process driving several devices; so is the port's.
A :class:`Mesh` is a tuple of torch devices, and shard ``s`` of a sharded
field lives on ``devices[s]``. Several shards may share one device (the
counterpart of mad_tpu's virtual CPU mesh): the CPU tests run
``make_mesh(n, devices=["cpu"] * n)``, a single card runs
``make_mesh(n, devices=["cuda:0"] * n)``. What mad_tpu does with
collectives is done with tensor copies between the shards' devices
(:mod:`.volume`); there is no ``torch.distributed`` and no fallback: a mesh
never becomes a single-device run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """The devices of the shards, shard ``s`` on ``devices[s]``."""

    devices: Tuple[torch.device, ...]

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where the replicated tables (anchors, lanes, descriptor rows)
        are assembled: the first shard's device."""
        return self.devices[0]


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh(n: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n`` shards: on the first ``n`` cards (all of them when
    ``n`` is None), raising when there are fewer; or, with ``devices``, one
    shard on each device named there (devices may repeat)."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n is not None and int(n) != len(devs):
            raise ValueError(f"make_mesh: {n} shards but {len(devs)} "
                             "devices named")
    else:
        have = _cards()
        n = have if n is None else int(n)
        if have < n:
            raise RuntimeError(f"make_mesh: {n} cards asked for, {have} "
                               "available")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one shard")
    return Mesh(devs)


def mesh_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else len(mesh)
