"""Device meshes for sharded embedding serving.

Port of the JAX package's parallel/mesh.py. A mesh has two axes:

- ``table``: embedding-table rows sharded over its entries (capacity
  scaling: the memory of every entry in aggregate);
- ``data``: request batches replicated or split (throughput scaling).

The JAX package's ``Mesh`` is single-controller: one process drives every
shard. So is this one, and its entries are ``torch.device``s, which may
repeat: ``[cuda:0] * 4`` puts four shards on one card, ``[cpu] * 8`` eight on
the host (the counterpart of the JAX tests' virtual CPU devices). A shard's
exchange with another on the same device is then a copy within that device.

A mesh may also span processes (``group``, a ``torch.distributed`` process
group; the JAX package's ``jax.distributed`` mesh): every rank holds the same
number of table entries, rank ``r`` the shards ``r * L .. r * L + L - 1``, and
``devices`` lists only its own. The table axis is the one split over ranks;
the data axis stays local. The lookups exchange the ranks' blocks with
``all_gather_into_tensor`` and ``all_reduce`` (gloo on the CPU, NCCL on
cards).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _device_array(devices: Sequence, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr.reshape(shape)


class Mesh:
    """``devices``: an object array of ``torch.device`` shaped by
    ``axis_names`` (this rank's entries when ``group`` is set);
    ``shape[axis]``: the axis's size over every rank, which is what the
    JAX code reads."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], group=None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh devices of shape {devices.shape} do not match "
                             f"axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group
        self.world = 1 if group is None else torch.distributed.get_world_size(group)
        self.rank = 0 if group is None else torch.distributed.get_rank(group)
        self.shard_axis = shard_axis_of(self.axis_names)
        self.shape = {a: int(n) * (self.world if a == self.shard_axis else 1)
                      for a, n in zip(self.axis_names, devices.shape)}

    @property
    def local_shards(self) -> int:
        """Table entries this rank holds."""
        return self.shape[self.shard_axis] // self.world

    def _along(self, axis: str) -> list:
        """The entries along ``axis`` at the first entry of every other axis."""
        idx = [0] * self.devices.ndim
        idx[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(idx)])

    def shard_devices(self) -> list:
        """The devices of this rank's shards, in shard order (the lookups
        are replicated over ``data`` and run once, at its first entry)."""
        return self._along(self.shard_axis)

    def data_devices(self) -> list:
        """The devices along ``data`` at shard 0 (one entry without a data
        axis)."""
        return self._along("data") if "data" in self.axis_names else [self.out_device]

    @property
    def out_device(self) -> torch.device:
        """Where a lookup's result lands (the JAX result is replicated; here
        it is on the first entry)."""
        return self.devices.reshape(-1)[0]


def shard_axis_of(axis_names: Sequence[str]) -> str:
    """The shard axis: "table" when the mesh has one (the library
    convention), else the mesh's single axis (ps.json's
    ``table_shard_axis``, parallel/sharded_cache.py)."""
    if "table" in axis_names:
        return "table"
    if len(axis_names) == 1:
        return axis_names[0]
    raise ValueError(
        f"cannot infer the shard axis from mesh axes {tuple(axis_names)}; "
        "name one of them 'table'"
    )


def make_mesh(table: int = 1, data: int = 1, devices=None, group=None) -> Mesh:
    """Build a (data x table) mesh from the first ``data * table`` devices.

    ``devices``: None means every visible card (and raises when there are
    fewer than needed); a list may repeat a device (``[cuda:0] * 4``).
    ``group``: a ``torch.distributed`` process group over which the table
    axis is split: ``table`` counts the shards of every rank, and ``devices``
    lists this rank's ``table // world * data`` entries."""
    if table < 1 or data < 1:
        raise ValueError(
            f"mesh axes must be >= 1 (got table={table}, data={data})"
        )
    world = 1 if group is None else torch.distributed.get_world_size(group)
    if table % world:
        raise ValueError(f"table={table} shards do not split over {world} ranks")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    need = table // world * data
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(_device_array(devices[:need], (data, table // world)), ("data", "table"),
                group=group)


def mesh_1d(devices: Sequence, axis: str) -> Mesh:
    """A one-axis mesh named ``axis`` over ``devices``."""
    return Mesh(_device_array(list(devices), (len(devices),)), (axis,))
