"""Learning-rate schedules (counterpart of `bigdl_tpu/optim/schedules.py`).

Ported: `Default`, the schedule `SGD` uses unless given another. A
schedule is a host-side function of the optimizer's state dict.
"""

from __future__ import annotations


class LearningRateSchedule:
    """compute(optim) -> learning rate."""

    def compute(self, optim) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + neval * learning_rate_decay)."""

    def compute(self, optim) -> float:
        n = optim.state["neval"]
        return optim.learning_rate / (1 + n * optim.learning_rate_decay)
