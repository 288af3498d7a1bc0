"""Device and process meshes (counterpart of `bigdl_tpu/parallel/mesh.py`).

The JAX package's mesh is a `jax.sharding.Mesh`: an array of devices with
named axes, over which one program (`shard_map`) runs every shard. The
port has two:
- `Mesh` keeps that single-controller model for sequence parallelism: a
  numpy object array of `torch.device`s with axis names, and one process
  drives every shard on its device. A mesh may name one device several
  times (n shards on one card), the port's stand-in for the JAX tests'
  virtual CPU devices.
- `ProcessMesh` is the mesh of training, one process per device: the
  ranks of the default process group as a (data, model) grid, rank r at
  (r // model, r % model), the reference's row-major
  `np.array(devices).reshape(data, model)`. It holds a data group (the
  ranks with this rank's model index: gradients, BN statistics, loss and
  denominators are reduced over it) and a model group (the ranks with
  this rank's data index: sharded parameters are gathered over it), and,
  on demand, the same grid as a `torch.distributed` `DeviceMesh` for
  DTensors (`serialization/sharded_checkpoint.py`).
  `Engine.get_mesh(data, model)` builds it under a process group.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.parallel import collectives


class Mesh:
    """Devices (a numpy object array of `torch.device`) with one name for
    each of its axes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axis names "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def build_mesh(data: Optional[int] = None, model: int = 1,
               devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over `devices`: by default every CUDA device,
    `cuda:0 .. cuda:{device_count - 1}`. `devices` may repeat a device.

        >>> from bigdl_tpu_torch.parallel import build_mesh
        >>> mesh = build_mesh(data=2, devices=["cpu", "cpu"])
        >>> mesh.axis_names, mesh.devices.shape
        (('data', 'model'), (2, 1))
    """
    if devices is None:
        resolve_device("cuda")  # raises without a CUDA device
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if data is None:
        data = n // model
    if data * model != n or n == 0:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(data, model), ("data", "model"))


def process_mesh_shape(data: Optional[int], model: int,
                       world: int) -> Tuple[int, int]:
    """(data, model) of a process mesh over `world` ranks; `data=None`
    takes what `model` leaves. A model axis that does not divide the world
    raises `ValueError`."""
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"{world} ranks of the process group")
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    return data, model


class ProcessMesh:
    """The ranks of the default process group as a (data, model) grid
    (see the module docstring). Every rank builds it, with the same shape
    and in the same order: its groups are created collectively. `device`
    (default: the current CUDA device, else the CPU) is the device type of
    its `DeviceMesh`."""

    def __init__(self, data: Optional[int] = None, model: int = 1, *,
                 device=None):
        world = collectives.world_size()
        data, model = process_mesh_shape(data, model, world)
        self.axis_names: Tuple[str, ...] = ("data", "model")
        self.ranks = np.arange(world).reshape(data, model)
        self.data_index, self.model_index = divmod(collectives.rank(), model)
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device()) \
                if torch.cuda.is_available() else torch.device("cpu")
        self.device_type = torch.device(device).type
        #: the ranks with this rank's model index, and with its data index
        self.data_group = self._groups([self.ranks[:, m]
                                        for m in range(model)],
                                       self.model_index)
        self.model_group = self._groups(list(self.ranks), self.data_index)
        self._device_mesh = None

    @staticmethod
    def _groups(rows, mine: int) -> collectives.Group:
        """One group for each row of ranks, created by every rank in
        order; the one at `mine`. The whole world is the default group."""
        world = collectives.world_size()
        out = None
        for i, row in enumerate(rows):
            ranks = [int(r) for r in row]
            pg = dist.group.WORLD if len(ranks) == world \
                else dist.new_group(ranks)
            if i == mine:
                out = collectives.Group(ranks, pg)
        return out

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def device_mesh(self):
        """The grid as a `torch.distributed.device_mesh.DeviceMesh` with
        dimensions ("data", "model") over this mesh's groups (built on
        first use)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            self._device_mesh = DeviceMesh.from_group(
                [self.data_group.pg, self.model_group.pg], self.device_type,
                mesh=torch.as_tensor(self.ranks),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def __repr__(self):
        return (f"ProcessMesh({self.shape}, rank at "
                f"({self.data_index}, {self.model_index}))")
