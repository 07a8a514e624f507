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

The dock's data-parallel axes (subunit rows, pairs, candidates, lanes) are
cut by :func:`shard_bounds` into contiguous blocks of the real counts,
where a shard may get none: :func:`map_rows` runs a per-shard body on each
non-empty block and :func:`gather` puts the parts back in shard order on
``Mesh.home`` (mad_tpu's ``all_gather``). Inputs every shard reads whole
(mad_tpu's replicated ``P()`` operands) are built once per distinct device
by :func:`replicate`, so shards that share a card share them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def run_device(mesh: Optional[Mesh], device, default=None) -> torch.device:
    """Where a run's results gather: with a mesh its home device (a
    ``device`` naming another raises: a mesh never quietly runs
    elsewhere), else ``device``, or ``default`` when that is None."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.home:
            raise ValueError(f"device {device} is not the mesh's home "
                             f"{mesh.home}")
        return mesh.home
    return torch.device(default if device is None else device)


def auto_mesh() -> Optional[Mesh]:
    """A mesh over all cards; None with fewer than two (mad_tpu's
    ``auto_mesh``: one device needs no mesh)."""
    return make_mesh() if _cards() >= 2 else None


def shard_bounds(rows: int, n: int) -> List[int]:
    """Bounds of n contiguous blocks of ``rows`` rows (n + 1 ints): every
    block gets rows // n and the first rows % n one more, so blocks are
    empty when there are fewer rows than shards."""
    q, r = divmod(int(rows), int(n))
    return [s * q + min(s, r) for s in range(n + 1)]


def distinct_devices(mesh: Mesh) -> List[torch.device]:
    """The mesh's devices, each once, in shard order."""
    return list(dict.fromkeys(mesh.devices))


def replicate(mesh: Mesh, fn: Callable) -> Dict[torch.device, object]:
    """``fn(device)`` once for each distinct device of the mesh."""
    return {d: fn(d) for d in distinct_devices(mesh)}


def gather(parts: Sequence[torch.Tensor], home: torch.device
           ) -> torch.Tensor:
    """The per-shard parts, in shard order, as one tensor on ``home``."""
    if len(parts) == 1 and parts[0].device == home:
        return parts[0]
    return torch.cat([p.to(home) for p in parts])


def map_rows(mesh: Mesh, rows: int, fn: Callable):
    """``fn(device, start, stop)`` for each shard's block of ``rows`` rows
    (:func:`shard_bounds`) on the shard's device, each returning a tensor
    or a tuple of tensors of ``stop - start`` rows; the outputs gathered
    on ``mesh.home`` in row order. A shard with no row is skipped (with no
    row at all, shard 0 runs on none)."""
    b = shard_bounds(rows, len(mesh))
    parts = [(d, b[s], b[s + 1]) for s, d in enumerate(mesh.devices)
             if b[s + 1] > b[s]] or [(mesh.devices[0], 0, 0)]
    outs = [fn(d, a, e) for d, a, e in parts]
    if isinstance(outs[0], torch.Tensor):
        return gather(outs, mesh.home)
    return tuple(gather(list(col), mesh.home) for col in zip(*outs))
