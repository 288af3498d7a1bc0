"""The `Optimizer` factory (counterpart of `bigdl_tpu/optim/optimizer.py`).

`Optimizer(model, training_set, criterion, batch_size)` batches the
training set and picks the loop, as the reference does: `LocalOptimizer`
on one device, `DistriOptimizer` over several (which raises for now:
multi-GPU data parallel is `ROADMAP.md` queue 1 item 6).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalDataSet)
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer,
                                                   LocalOptimizer)


def Optimizer(model: torch.nn.Module, training_set, criterion,
              batch_size: int = 32, local: Optional[bool] = None,
              drop_remainder: Optional[bool] = None, *,
              device=None) -> BaseOptimizer:
    """The optimizer for `model` (already on `device`, default CUDA) over
    `training_set`: an `AbstractDataSet`, a pair of numpy arrays
    (features, labels) or a list of `Sample`s, batched by `batch_size`
    unless its items are already MiniBatches. `local=None` picks
    `LocalOptimizer` when one device is visible (the CPU, or a single
    card) and `DistriOptimizer` over all the cards otherwise."""
    device = resolve_device(device)
    devices = [device]
    if device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if local is None:
        local = len(devices) <= 1
    if drop_remainder is None:
        drop_remainder = not local  # equal shards per step across devices
    dataset = _as_batched_dataset(training_set, batch_size, drop_remainder)
    if local:
        return LocalOptimizer(model, dataset, criterion,
                              batch_size=batch_size, device=device)
    return DistriOptimizer(model, dataset, criterion, devices=devices)


def _as_batched_dataset(training_set, batch_size: int,
                        drop_remainder: bool) -> AbstractDataSet:
    if isinstance(training_set, AbstractDataSet):
        base = training_set
    elif isinstance(training_set, (list, tuple)) and len(training_set) == 2 \
            and isinstance(training_set[0], np.ndarray):
        base = DataSet.from_arrays(training_set[0], training_set[1])
    elif isinstance(training_set, (list, tuple)) and training_set \
            and isinstance(training_set[0], Sample):
        base = LocalDataSet(training_set)
    else:
        raise TypeError(f"cannot build a dataset from {type(training_set)}")
    first = next(iter(base.data(train=False)), None)
    if isinstance(first, MiniBatch):
        return base
    return base.transform(
        SampleToMiniBatch(batch_size, drop_remainder=drop_remainder))
