"""Training (counterpart of `bigdl_tpu.optim`): `SGD`, triggers, metrics,
`LocalOptimizer` and the single-device `DistriOptimizer`."""

from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer,
                                                   LocalOptimizer)
from bigdl_tpu_torch.optim.metrics import Metrics, Timer
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule
from bigdl_tpu_torch.optim.trigger import (Trigger, every_epoch, max_epoch,
                                           max_iteration, several_iteration)

__all__ = ["BaseOptimizer", "Default", "DistriOptimizer",
           "LearningRateSchedule", "LocalOptimizer", "Metrics", "OptimMethod",
           "SGD", "Timer", "Trigger", "every_epoch", "max_epoch",
           "max_iteration", "several_iteration"]
