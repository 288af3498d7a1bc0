"""Synchronous data-parallel training (counterpart of
`bigdl_tpu/optim/distri_optimizer.py`), on one device so far.

On one device the reference's SPMD step degenerates to the local step:
the batch is not split, no gradient all-reduce runs, and every sharding
spec is replicated. So the port's `DistriOptimizer` runs `BaseOptimizer`'s
step and loop on its one device. Several devices (data parallel over
`torch.distributed`) are `ROADMAP.md` queue 1 item 6, and asking for them
raises `NotImplementedError`. Retry from checkpoints, elastic mode and
gradient bucketing are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.optim.local_optimizer import BaseOptimizer


class DistriOptimizer(BaseOptimizer):
    """Data-parallel SGD over the devices of `mesh` (the reference's
    parameter) or `devices` (default: the one CUDA device); only a single
    device is supported yet."""

    def __init__(self, model: torch.nn.Module, dataset, criterion,
                 mesh=None, *, devices: Optional[Sequence] = None):
        if mesh is not None:
            if devices is not None:
                raise ValueError("pass mesh or devices, not both")
            devices = list(mesh.devices.ravel())
        devices = [resolve_device(d) for d in (devices or [None])]
        if len(devices) != 1:
            raise NotImplementedError(
                f"DistriOptimizer over {len(devices)} devices is not ported "
                "yet (ROADMAP.md queue 1 item 6, multi-GPU data parallel); "
                "pass one device")
        super().__init__(model, dataset, criterion, device=devices[0])
        self.devices = devices

    def _log_suffix(self) -> str:
        return f" ({len(self.devices)} devices)"

    def optimize(self) -> torch.nn.Module:
        return self._optimize_impl()
