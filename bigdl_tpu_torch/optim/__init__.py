"""Training and batch inference (counterpart of `bigdl_tpu.optim`): `SGD`,
`Adam`, `AdamW`, the learning-rate schedules, triggers, metrics,
`LocalOptimizer`, the single-device `DistriOptimizer`, the `Optimizer`
factory, and `LocalPredictor`."""

from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer,
                                                   LocalOptimizer)
from bigdl_tpu_torch.optim.metrics import Metrics, Timer
from bigdl_tpu_torch.optim.optim_method import (SGD, Adam, AdamW,
                                                OptimMethod)
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.predictor import LocalPredictor, Predictor
from bigdl_tpu_torch.optim.schedules import (CosineDecay, Default,
                                             LearningRateSchedule,
                                             WarmupCosineDecay)
from bigdl_tpu_torch.optim.trigger import (Trigger, every_epoch, max_epoch,
                                           max_iteration, several_iteration)

__all__ = ["Adam", "AdamW", "BaseOptimizer", "CosineDecay", "Default",
           "DistriOptimizer", "LearningRateSchedule", "LocalOptimizer",
           "LocalPredictor", "Metrics", "OptimMethod", "Optimizer",
           "Predictor", "SGD", "Timer", "Trigger",
           "WarmupCosineDecay", "every_epoch", "max_epoch", "max_iteration",
           "several_iteration"]
