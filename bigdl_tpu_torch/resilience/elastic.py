"""Elastic training policy: survivors to a training shape, and the replay
rule (counterpart of `bigdl_tpu/resilience/elastic.py`).

Elastic training recovers at the sync window, not the job: when a replica
disappears mid-step the run rolls back to the last committed sync
boundary, rebuilds over the survivors, replays the interrupted batches,
and goes on degraded. This module is the policy; the mechanism
(commit, rollback, replay) is `DistriOptimizer`'s elastic loop.

- Shape: `plan(alive_devices)` maps the surviving devices to a plan. A
  global batch is always `logical_replicas` fixed logical shards, mapped
  onto the devices round-robin, so any survivor count from `min_devices`
  up is a valid shape: the plan is the first `min(alive,
  logical_replicas)` survivors in registry order, with a (data, 1) port
  `Mesh` over their torch devices.
- Replay boundary: `replay_boundary(committed_step)`, the last committed
  sync boundary; every step after it is replayed from the kept batches.

The devices a plan holds are what the registry holds: `membership.Slot`s
for a `SimulatedCluster` (one device may then appear several times),
compared by identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.utils.table import Table


class InsufficientCapacityError(RuntimeError):
    """Fewer survivors than `min_devices`: elastic recovery cannot go on,
    and the failure goes to the job-level retry."""


def torch_device(d) -> torch.device:
    """The torch device of a plan entry (a `Slot`, or a device)."""
    return getattr(d, "device", None) or torch.device(d)


class ElasticPlan:
    """One resolved shape: the devices to run on (registry order), the lead
    (shard results are combined there, in a fixed order), and the mesh over
    their torch devices."""

    __slots__ = ("devices", "mesh", "n_active", "degraded_capacity")

    def __init__(self, devices: Sequence, total_devices: int):
        from bigdl_tpu_torch.parallel.mesh import build_mesh
        self.devices = tuple(devices)
        self.n_active = len(self.devices)
        self.mesh = build_mesh(data=self.n_active, model=1,
                               devices=[torch_device(d)
                                        for d in self.devices])
        self.degraded_capacity = (
            round(1.0 - self.n_active / total_devices, 6)
            if total_devices else 0.0)

    @property
    def lead(self):
        return self.devices[0]

    def __repr__(self):
        return (f"ElasticPlan(n_active={self.n_active}, "
                f"degraded_capacity={self.degraded_capacity})")


class ElasticController:
    """Maps the surviving capacity to a training shape.

    `logical_replicas` is the fixed number of logical gradient shards of a
    global batch: the batch must divide by it, and it never changes over a
    shrink or a grow, which is what keeps the trajectory independent of
    the shape. `min_devices` is the floor below which the run goes to the
    job-level retry instead."""

    def __init__(self, logical_replicas: int, min_devices: int = 1):
        if logical_replicas < 1:
            raise ValueError(
                f"logical_replicas must be >= 1, got {logical_replicas}")
        if not 1 <= min_devices <= logical_replicas:
            raise ValueError(
                f"min_devices must be in [1, {logical_replicas}], "
                f"got {min_devices}")
        self.logical_replicas = int(logical_replicas)
        self.min_devices = int(min_devices)

    def plan(self, alive_devices: Sequence,
             total_devices: Optional[int] = None) -> ElasticPlan:
        """The shape for the survivors; `InsufficientCapacityError` below
        the floor."""
        alive = list(alive_devices)
        if len(alive) < self.min_devices:
            raise InsufficientCapacityError(
                f"{len(alive)} device(s) alive, elastic floor is "
                f"{self.min_devices}")
        use = alive[:min(len(alive), self.logical_replicas)]
        return ElasticPlan(use, total_devices or len(alive))

    def shard_device(self, plan: ElasticPlan, shard_index: int):
        """The device logical shard `shard_index` runs on: round-robin in
        plan order, so a replan remaps shards deterministically."""
        return plan.devices[shard_index % plan.n_active]

    def replay_boundary(self, committed_step: int) -> int:
        """The step a rollback lands on: the last committed boundary."""
        return int(committed_step)

    def split_batch(self, value):
        """A batch's inputs or targets (a numpy array, a tensor, or a list,
        tuple or 1-based `Table` of them) split into `logical_replicas`
        equal shards along axis 0: a list of arrays, tensors (views) or
        `Table`s. `ValueError` when the batch does not divide."""
        R = self.logical_replicas
        if value is None:
            return [None] * R
        if isinstance(value, (list, tuple, Table)):
            per_elem = [self.split_batch(v) for v in value]
            return [Table(*[pe[i] for pe in per_elem]) for i in range(R)]
        arr = value if isinstance(value, torch.Tensor) else np.asarray(value)
        if arr.ndim == 0 or arr.shape[0] % R != 0:
            raise ValueError(
                f"global batch of shape {tuple(arr.shape)} does not divide "
                f"into {R} logical replicas; pick a batch size divisible by "
                f"logical_replicas")
        if isinstance(arr, torch.Tensor):
            return list(arr.chunk(R))
        return np.split(arr, R, axis=0)
