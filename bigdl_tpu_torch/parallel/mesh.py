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

The helpers of the reference's module: `data_sharding` and
`replicate_sharding` name a placement (`NamedSharding`: a mesh and a
`PartitionSpec`); `shard_batch` places a batch over the data axis as
per-position shards; `get_shard_map` gives the single-controller
`shard_map`, which runs a per-shard function without collectives once
for each mesh position, on that position's device.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.parallel.sharding import PartitionSpec
from bigdl_tpu_torch.utils.table import Table


class Mesh:
    """Devices (a numpy object array of `torch.device`) with one name for
    each of its axes. `devices` may be any nested sequence of devices or
    device names (`["cuda"] * 4`); each is resolved as an entry point's
    `device` is."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if not all(isinstance(d, torch.device) for d in devices.flat):
            resolved = np.empty(devices.shape, dtype=object)
            for idx in np.ndindex(devices.shape):
                resolved[idx] = resolve_device(devices[idx])
            devices = resolved
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

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, the other axes at position 0 (where a
        value replicated over them is computed once). Raises `ValueError`
        for an axis the mesh does not have."""
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no {axis!r} axis: "
                             f"{self.axis_names}")
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[k] = slice(None)
        return list(self.devices[tuple(idx)])


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


# --------------------------------------------------------------------------
# The reference's placement helpers
# --------------------------------------------------------------------------

class NamedSharding:
    """A placement over a mesh: `spec` names the mesh axis each dimension
    of a tensor is split over (`jax.sharding.NamedSharding`)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def data_sharding(mesh) -> NamedSharding:
    """Shard the leading (batch) dim over the data axis."""
    return NamedSharding(mesh, PartitionSpec("data"))


def replicate_sharding(mesh) -> NamedSharding:
    """Replicate a value across the whole mesh."""
    return NamedSharding(mesh, PartitionSpec())


def tree_map(fn: Callable, tree):
    """`fn` on every tensor or numpy array leaf of nested dicts, lists,
    tuples and `Table`s (another leaf passes through as it is)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, Table):
        out = Table()
        for k in tree.keys():
            out[k] = tree_map(fn, tree[k])
        return out
    return tree


def shard_batch(mesh, batch):
    """Place a host batch (a tensor, an array or a tree of them) over the
    mesh's data axis.
    - A one-device mesh moves the tree to that device.
    - A `ProcessMesh` (one process per device) leaves the rank's local
      batch whole on the rank's device: each process feeds its own shard
      of the global batch, as the reference's multi-host rule.
    - Otherwise each leaf becomes the list of its shards along the
      leading axis, one for each data position, each on that position's
      device (the shard-list model of `parallel/sequence.py`). The leading
      axis must divide by the data axis."""
    if isinstance(mesh, ProcessMesh):
        devs = [resolve_device(mesh.device_type)]
    elif mesh.devices.size == 1:
        devs = [mesh.devices.flat[0]]
    else:
        devs = mesh.axis_devices("data")

    def place(x):
        x = torch.as_tensor(x)
        if len(devs) == 1:
            return x.to(devs[0])
        if x.shape[0] % len(devs):
            raise ValueError(f"batch of {x.shape[0]} does not split over "
                             f"the {len(devs)} positions of the data axis")
        return [c.to(d) for c, d in zip(x.chunk(len(devs)), devs)]

    return tree_map(place, batch)


def _split_dims(spec, mesh) -> List[Tuple[int, str]]:
    """(tensor dim, mesh axis) of each split dimension of `spec`."""
    out = []
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        if not isinstance(axis, str):
            raise NotImplementedError(
                f"a dimension split over several axes ({axis!r}) is not "
                "ported")
        if axis not in mesh.axis_names:
            raise ValueError(f"spec {spec!r} names {axis!r}, not an axis of "
                             f"the mesh {mesh.axis_names}")
        out.append((d, axis))
    return out


def shard_map(f: Callable, mesh, in_specs, out_specs):
    """The single-controller `shard_map`: returns a function of the
    global inputs that splits each input along the dims its spec names
    (`in_specs`, one `PartitionSpec` a positional input, applied to every
    tensor of a tree input), runs `f` once for each mesh position on that
    position's shards, moved to its device, and joins the outputs as
    `out_specs` says (one spec, or a tuple of specs for a tuple output):
    concatenated along each split dim in position order, and taken from
    position 0 along any axis the spec does not name (a value replicated
    over it). Outputs are joined on position 0's device. `f` may not
    communicate across positions: there are no collectives here."""
    in_specs = tuple(in_specs)
    multi_out = isinstance(out_specs, (tuple, list)) \
        and not isinstance(out_specs, PartitionSpec)
    shape = mesh.devices.shape
    positions = list(np.ndindex(shape))

    def shard(x, spec, pos):
        x = torch.as_tensor(x)
        for d, axis in _split_dims(spec, mesh):
            k = mesh.axis_names.index(axis)
            n = shape[k]
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of size {x.shape[d]} does not "
                                 f"split over the {n} positions of {axis!r}")
            x = x.chunk(n, dim=d)[pos[k]]
        return x.to(mesh.devices[pos])

    def join(outs: np.ndarray, spec, device):
        dims = dict((axis, d) for d, axis in _split_dims(spec, mesh))
        for k in reversed(range(len(shape))):
            axis = mesh.axis_names[k]
            parts = np.moveaxis(outs, k, -1)
            joined = np.empty(parts.shape[:-1], dtype=object)
            for idx in np.ndindex(joined.shape):
                row = parts[idx]
                if axis in dims:
                    joined[idx] = torch.cat([t.to(device) for t in row],
                                            dim=dims[axis])
                else:
                    joined[idx] = row[0].to(device)
            outs = joined
        return outs[()]

    def mapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} inputs for {len(in_specs)} "
                             "in_specs")
        results = np.empty(shape, dtype=object)
        for pos in positions:
            local = [tree_map(functools.partial(shard, spec=spec, pos=pos),
                              a) for a, spec in zip(args, in_specs)]
            results[pos] = f(*local)
        device = mesh.devices[positions[0]]
        if not multi_out:
            return join(results, out_specs, device)
        outs = []
        for i, spec in enumerate(out_specs):
            part = np.empty(shape, dtype=object)
            for pos in positions:
                part[pos] = results[pos][i]
            outs.append(join(part, spec, device))
        return tuple(outs)

    return mapped


def get_shard_map():
    """The port's single-controller `shard_map(f, mesh, in_specs,
    out_specs)` (see `shard_map`), as the reference's `get_shard_map`
    returns `jax.shard_map`."""
    return shard_map
