"""Learning-rate schedules (counterpart of `bigdl_tpu/optim/schedules.py`).

Ported: `Default` (the schedule `SGD` and `Adam` use unless given
another), `CosineDecay` and `WarmupCosineDecay` (the transformer recipe).
A schedule is a host-side function of the optimizer's state dict.
"""

from __future__ import annotations

import math


class LearningRateSchedule:
    """compute(optim) -> learning rate."""

    def compute(self, optim) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + neval * learning_rate_decay)."""

    def compute(self, optim) -> float:
        n = optim.state["neval"]
        return optim.learning_rate / (1 + n * optim.learning_rate_decay)


class CosineDecay(LearningRateSchedule):
    """Half-cosine from lr to lr * alpha over `decay_iteration` steps, then
    held at lr * alpha."""

    def __init__(self, decay_iteration: int, alpha: float = 0.0):
        if decay_iteration < 1:
            raise ValueError(
                f"decay_iteration must be >= 1, got {decay_iteration}")
        self.decay_iteration = decay_iteration
        self.alpha = alpha

    def compute(self, optim) -> float:
        n = min(optim.state["neval"], self.decay_iteration)
        cos = 0.5 * (1 + math.cos(math.pi * n / self.decay_iteration))
        return optim.learning_rate * (self.alpha + (1 - self.alpha) * cos)


class WarmupCosineDecay(LearningRateSchedule):
    """Linear ramp 0 -> lr over `warmup_iteration` steps, then half-cosine
    lr -> lr * alpha through `total_iteration`: one continuous schedule
    whose peak is the optimizer's learning rate."""

    def __init__(self, warmup_iteration: int, total_iteration: int,
                 alpha: float = 0.0):
        if not 0 <= warmup_iteration < total_iteration:
            raise ValueError(
                f"need 0 <= warmup ({warmup_iteration}) < total "
                f"({total_iteration})")
        self.warmup_iteration = warmup_iteration
        self.total_iteration = total_iteration
        self.alpha = alpha

    def compute(self, optim) -> float:
        n = optim.state["neval"]
        w = self.warmup_iteration
        if w > 0 and n < w:
            return optim.learning_rate * n / w
        n = min(n, self.total_iteration)
        cos = 0.5 * (1 + math.cos(math.pi * (n - w) /
                                  (self.total_iteration - w)))
        return optim.learning_rate * (self.alpha + (1 - self.alpha) * cos)
