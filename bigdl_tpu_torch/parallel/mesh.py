"""A device mesh (counterpart of `bigdl_tpu/parallel/mesh.py`).

The JAX package's mesh is a `jax.sharding.Mesh`: an array of devices with
named axes, over which one program (`shard_map`) runs every shard. The
port keeps that single-controller model: `Mesh` is a numpy object array
of `torch.device`s with axis names, and one process drives every shard
on its device. A mesh may name one device several times (n shards on one
card), the port's stand-in for the JAX tests' virtual CPU devices.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device


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
