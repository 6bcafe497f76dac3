"""The device mesh of distributed search.

Counterpart of the reference's ``parallel/mesh.py``: a grid of devices
with two named axes,

  "data"   — the query batch axis: each data row takes its slice of the
             batch, over a full copy of the pack;
  "shards" — the document axis: each column holds a disjoint, contiguous
             run of the pack's shards; a search fans out over it and
             merges with an all-gather and a sum (the collective tail).

Here the grid is of ``torch.device``s. ``make_mesh()`` lays every visible
CUDA device on the shards axis, the reference service's ``(1,
n_local_devices)``. One process drives the whole grid, as the reference's
single-process SPMD does. A grid of CPU entries (``devices=["cpu"] * 4``)
runs the same split, gather and merge code with the plain transport; the
tests use it where there is no card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from elasticsearch_tpu_torch.parallel.device import (NoDeviceError,
                                                     resolve_device)

DATA_AXIS = "data"
SHARD_AXIS = "shards"


def factorize_2d(n: int) -> Tuple[int, int]:
    """(data, shards) grid for n devices: favor the shards axis (search
    scales with document partitions first), keep data as the largest
    power-of-two cofactor ≤ shards."""
    best = (1, n)
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = (d, n // d)
        d *= 2
    return best


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, shards) grid of devices: grid[d][c] is the device of data
    row d and shards column c."""

    grid: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.grid), SHARD_AXIS: len(self.grid[0])}

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(dev for row in self.grid for dev in row)

    @property
    def is_cuda(self) -> bool:
        return self.grid[0][0].type == "cuda"

    def __str__(self) -> str:
        d, s = len(self.grid), len(self.grid[0])
        return f"mesh({d}, {s}) over {[str(x) for x in self.devices]}"


def make_mesh(devices: Optional[Sequence[Union[str, torch.device]]] = None,
              shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A mesh over `devices` (default: every visible CUDA device) of
    `shape` (default: all of them on the shards axis, (1, n)). Raises
    NoDeviceError when no device is given and no GPU is visible. CUDA
    entries must be distinct; CPU entries may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device is available; pass devices=['cpu', ...] "
                "for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n = len(devs)
    kinds = {d.type for d in devs}
    if kinds - {"cuda", "cpu"} or len(kinds) != 1:
        raise ValueError(f"a mesh takes CUDA devices or CPU entries, not "
                         f"both: {[str(d) for d in devs]}")
    if "cuda" in kinds:
        if not torch.cuda.is_available():
            raise NoDeviceError(f"{devs[0]} requested but no CUDA device "
                                f"is available")
        devs = [torch.device("cuda", d.index if d.index is not None
                             else torch.cuda.current_device())
                for d in devs]
        if len({d.index for d in devs}) != n:
            raise ValueError(f"a CUDA mesh needs distinct devices: "
                             f"{[str(d) for d in devs]}")
    if shape is None:
        shape = (1, n)
    data, shards = shape
    if data < 1 or shards < 1 or data * shards != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    grid = tuple(tuple(devs[r * shards: (r + 1) * shards])
                 for r in range(data))
    return Mesh(grid)


def resolve_mesh(device=None, mesh: Optional[Mesh] = None) -> Mesh:
    """The mesh an entry point runs on: `mesh`, or a (1, 1) mesh of
    `device` (``"cpu"``: the plain path), or make_mesh()."""
    if mesh is not None and device is not None:
        raise ValueError("give a mesh or a device, not both")
    if mesh is not None:
        return mesh
    if device is None:
        return make_mesh()
    return make_mesh([resolve_device(device)])
