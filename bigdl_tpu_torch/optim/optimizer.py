"""The `Optimizer` factory (counterpart of `bigdl_tpu/optim/optimizer.py`).

`Optimizer(model, training_set, criterion, batch_size)` batches the
training set and picks the loop, as the reference does: `DistriOptimizer`
when the process group has more than one rank (one process per GPU,
`Engine.init(distributed=True)`), with `drop_remainder=True` so every
rank's shard steps in equal batches; otherwise `LocalOptimizer` on one
device. A single process that sees several cards raises: data parallelism
in the port is one process per GPU, and the one single-controller loop
over several devices is `DistriOptimizer`'s elastic mode, built directly
(`DistriOptimizer(..., devices=...).set_elastic()`). `local=False` takes
`DistriOptimizer` on one device. Further keywords (the retry
settings `retry_times`, `retry_interval_s`, `retry_policy`) go to
`DistriOptimizer`, as in the reference; where the reference's
`LocalOptimizer` drops them, the port raises.
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
from bigdl_tpu_torch.parallel import collectives


def Optimizer(model: torch.nn.Module, training_set, criterion,
              batch_size: int = 32, local: Optional[bool] = None,
              drop_remainder: Optional[bool] = None, *,
              device=None, **kw) -> BaseOptimizer:
    """The optimizer for `model` (already on `device`, default CUDA) over
    `training_set`: an `AbstractDataSet`, a pair of numpy arrays
    (features, labels) or a list of `Sample`s, batched by `batch_size`
    unless its items are already MiniBatches. `local=None` picks
    `DistriOptimizer` on `device` when the process group has more than one
    rank, `LocalOptimizer` when one device is visible (the CPU, or a
    single card), and raises when one process sees several cards; with
    `local=False`, `DistriOptimizer` on `device`. `kw` goes to
    `DistriOptimizer`."""
    device = resolve_device(device)
    devices = [device]
    if device.type == "cuda" and collectives.world_size() == 1:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if len(devices) > 1:
        raise NotImplementedError(
            f"{len(devices)} cards in one process: start one process per "
            "GPU (Engine.init(distributed=True)), or build "
            "DistriOptimizer(..., devices=...) and arm set_elastic")
    if local is None:
        local = collectives.world_size() == 1
    if drop_remainder is None:
        drop_remainder = not local  # equal shards per step across devices
    dataset = _as_batched_dataset(training_set, batch_size, drop_remainder)
    if local:
        if kw:
            raise TypeError(f"{sorted(kw)} apply to DistriOptimizer; "
                            "LocalOptimizer takes none (pass local=False)")
        return LocalOptimizer(model, dataset, criterion,
                              batch_size=batch_size, device=device)
    return DistriOptimizer(model, dataset, criterion, devices=devices, **kw)


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
