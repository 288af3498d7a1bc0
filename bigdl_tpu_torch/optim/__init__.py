"""Training and batch inference (counterpart of `bigdl_tpu.optim`): the
optimization methods (`SGD`, the Adam family, `LAMB`, `Adagrad`,
`Adadelta`, `RMSprop`, `Ftrl`, `LBFGS`, per-submodule methods), the
learning-rate schedules, triggers, metrics, the
regularizers, the validation methods and `Evaluator`, `LocalOptimizer`,
the data-parallel `DistriOptimizer` (one process per device) with its
gradient buckets (`GradientBucketPlan`) and its parity subclass
`ParallelOptimizer`, the `Optimizer` factory, `LocalPredictor`, the
mesh-sharded `DistriPredictor` and the `PredictionService` facade."""

from bigdl_tpu_torch.optim.bucketing import GradientBucketPlan
from bigdl_tpu_torch.optim.distri_optimizer import (DistriOptimizer,
                                                    ParallelOptimizer)
from bigdl_tpu_torch.optim.evaluator import (DistriValidator, Evaluator,
                                             LocalValidator)
from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer,
                                                   LocalOptimizer)
from bigdl_tpu_torch.optim.metrics import Metrics, Timer
from bigdl_tpu_torch.optim.optim_method import (LAMB, LBFGS, SGD, Adadelta,
                                                Adagrad, Adam, Adamax, AdamW,
                                                CompositeOptimMethod, Ftrl,
                                                OptimMethod, ParallelAdam,
                                                RMSprop)
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.predictor import (DistriPredictor,
                                             LocalPredictor,
                                             PredictionService, Predictor)
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               Regularizer)
from bigdl_tpu_torch.optim.schedules import (CosineDecay, Default,
                                             EpochDecay, EpochDecayWithWarmUp,
                                             EpochSchedule, EpochStep,
                                             Exponential,
                                             LearningRateSchedule, MultiStep,
                                             NaturalExp, Plateau, Poly,
                                             Regime, SequentialSchedule,
                                             Step, Warmup, WarmupCosineDecay)
from bigdl_tpu_torch.optim.trigger import (Trigger, and_, every_epoch,
                                           max_epoch, max_iteration,
                                           max_score, min_loss, or_,
                                           several_iteration)
from bigdl_tpu_torch.optim.validation import (MAE, NDCG, AccuracyResult,
                                              ContiguousResult, HitRatio,
                                              Loss, LossResult,
                                              Top1Accuracy, Top5Accuracy,
                                              TreeNNAccuracy,
                                              ValidationMethod,
                                              ValidationResult)

__all__ = ["AccuracyResult", "Adadelta", "Adagrad", "Adam", "Adamax",
           "AdamW", "BaseOptimizer", "CompositeOptimMethod",
           "ContiguousResult", "CosineDecay", "Default", "DistriOptimizer",
           "DistriPredictor", "DistriValidator", "EpochDecay",
           "EpochDecayWithWarmUp", "EpochSchedule", "EpochStep", "Evaluator", "Exponential", "Ftrl",
           "GradientBucketPlan",
           "HitRatio", "L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "LAMB", "LBFGS", "LearningRateSchedule", "LocalOptimizer",
           "LocalPredictor", "LocalValidator", "Loss", "LossResult", "MAE",
           "Metrics", "MultiStep", "NDCG", "NaturalExp", "OptimMethod",
           "Optimizer", "ParallelAdam", "ParallelOptimizer", "Plateau",
           "Poly", "PredictionService", "Predictor", "RMSprop", "Regime",
           "Regularizer", "SGD", "SequentialSchedule", "Step", "Timer",
           "Top1Accuracy", "Top5Accuracy", "TreeNNAccuracy", "Trigger",
           "ValidationMethod", "ValidationResult", "Warmup",
           "WarmupCosineDecay", "and_", "every_epoch", "max_epoch",
           "max_iteration", "max_score", "min_loss", "or_",
           "several_iteration"]
