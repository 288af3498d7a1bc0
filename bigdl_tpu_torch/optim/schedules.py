"""Learning-rate schedules (counterpart of `bigdl_tpu/optim/schedules.py`).

Ported: all of the reference's schedules. `Default` (the schedule `SGD`
and `Adam` use unless given another), `CosineDecay` and
`WarmupCosineDecay` (the transformer recipe), `Poly`, `Step`,
`MultiStep`, `EpochDecay`, `EpochStep`, `NaturalExp`, `Exponential`,
`EpochSchedule` over `Regime`s, `Plateau` (fed the validation score by
the loop), `Warmup`, `SequentialSchedule` and `EpochDecayWithWarmUp`. A
schedule is a host-side function of the optimizer's state dict.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence


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


class Poly(LearningRateSchedule):
    """lr * (1 - neval / max_iteration)^power; 0 past `max_iteration`."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def compute(self, optim) -> float:
        n = optim.state["neval"]
        if n > self.max_iteration:
            return 0.0
        return optim.learning_rate * math.pow(
            1.0 - n / self.max_iteration, self.power)


class Step(LearningRateSchedule):
    """lr * gamma^floor(neval / step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def compute(self, optim) -> float:
        return optim.learning_rate * math.pow(
            self.gamma, optim.state["neval"] // self.step_size)


class MultiStep(LearningRateSchedule):
    """lr * gamma^(the number of milestones in `step_sizes` reached)."""

    def __init__(self, step_sizes: Sequence[int], gamma: float):
        self.step_sizes, self.gamma = list(step_sizes), gamma

    def compute(self, optim) -> float:
        n = optim.state["neval"]
        k = sum(1 for s in self.step_sizes if n >= s)
        return optim.learning_rate * math.pow(self.gamma, k)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch)."""

    def __init__(self, decay_fn: Callable[[int], float]):
        self.decay_fn = decay_fn

    def compute(self, optim) -> float:
        return optim.learning_rate * math.pow(
            0.1, self.decay_fn(optim.state["epoch"]))


class EpochStep(LearningRateSchedule):
    """lr * gamma^floor(epoch / step_size)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def compute(self, optim) -> float:
        return optim.learning_rate * math.pow(
            self.gamma, optim.state["epoch"] // self.step_size)


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(neval / decay_step))."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step, self.gamma = decay_step, gamma

    def compute(self, optim) -> float:
        return optim.learning_rate * math.exp(
            -self.gamma * (optim.state["neval"] // self.decay_step))


class Exponential(LearningRateSchedule):
    """lr * decay_rate^(neval / decay_step), the exponent floored with
    `staircase`."""

    def __init__(self, decay_step: int, decay_rate: float,
                 staircase: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.staircase = staircase

    def compute(self, optim) -> float:
        p = optim.state["neval"] / self.decay_step
        if self.staircase:
            p = math.floor(p)
        return optim.learning_rate * math.pow(self.decay_rate, p)


class Regime:
    """The settings `config` for the 1-based epochs start_epoch through
    end_epoch, one span of an `EpochSchedule`."""

    def __init__(self, start_epoch: int, end_epoch: int, config: dict):
        self.start_epoch, self.end_epoch = start_epoch, end_epoch
        self.config = config


class EpochSchedule(LearningRateSchedule):
    """Per-epoch regimes: in the first regime whose span holds the current
    (1-based) epoch, "learningRate" gives the rate and every other key
    (the reference's camelCase names, or the attribute's own) is set on
    the optimization method; an unknown key raises. Outside every regime
    the method's own learning rate."""

    _KEY_MAP = {
        "learningRate": "learning_rate",
        "learningRateDecay": "learning_rate_decay",
        "weightDecay": "weight_decay",
        "momentum": "momentum",
        "dampening": "dampening",
        "nesterov": "nesterov",
    }

    def __init__(self, regimes: Sequence[Regime]):
        self.regimes = list(regimes)

    def compute(self, optim) -> float:
        epoch = optim.state["epoch"] + 1  # the reference's epochs: 1-based
        lr = optim.learning_rate
        for r in self.regimes:
            if r.start_epoch <= epoch <= r.end_epoch:
                for k, v in r.config.items():
                    attr = self._KEY_MAP.get(k, k)
                    if attr == "learning_rate":
                        lr = v
                    elif hasattr(optim, attr):
                        setattr(optim, attr, v)
                    else:
                        raise ValueError(
                            f"unknown regime hyperparameter {k!r}")
                break
        return lr


class Plateau(LearningRateSchedule):
    """Reduce the rate when the monitored score stops improving: the loop
    calls `record(score, optim)` after each validation. The score improves
    when it beats the best by more than `epsilon` (below it in "min"
    mode, above it in "max"); after `patience` validations without
    improvement the rate is multiplied by `factor` (not below `min_lr`)
    and `cooldown` validations pass before the count starts again.
    `monitor` is kept and not read, as in the reference."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min",
                 epsilon: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon = mode, epsilon
        self.cooldown, self.min_lr = cooldown, min_lr
        self.best: Optional[float] = None
        self.wait = 0
        self.cooldown_counter = 0
        self._lr: Optional[float] = None

    def record(self, value: float, optim=None):
        if self._lr is None:
            self._lr = optim.learning_rate if optim else 0.01
        improved = (self.best is None or
                    (self.mode == "min" and value < self.best - self.epsilon)
                    or (self.mode == "max"
                        and value > self.best + self.epsilon))
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if improved:
            self.best = value
            self.wait = 0
        elif self.cooldown_counter == 0:
            self.wait += 1
            if self.wait >= self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.wait = 0

    def compute(self, optim) -> float:
        if self._lr is None:
            self._lr = optim.learning_rate
        return self._lr


class Warmup(LearningRateSchedule):
    """lr + delta * neval: a linear ramp, usually the first stage of a
    `SequentialSchedule`."""

    def __init__(self, delta: float):
        self.delta = delta

    def compute(self, optim) -> float:
        return optim.learning_rate + self.delta * optim.state["neval"]


class SequentialSchedule(LearningRateSchedule):
    """Schedules run one after another (`add(schedule, max_iteration)`),
    each for its `max_iteration` steps and seeing neval counted from its
    own start; the last one runs on past its span."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.iteration_per_epoch = iteration_per_epoch
        self.schedules: List[LearningRateSchedule] = []
        self.durations: List[int] = []

    def add(self, schedule: LearningRateSchedule, max_iteration: int):
        self.schedules.append(schedule)
        self.durations.append(max_iteration)
        return self

    def compute(self, optim) -> float:
        n = optim.state["neval"]
        offset = 0
        for sched, dur in zip(self.schedules, self.durations):
            if n < offset + dur or sched is self.schedules[-1]:
                saved = optim.state["neval"]
                optim.state["neval"] = n - offset
                try:
                    return sched.compute(optim)
                finally:
                    optim.state["neval"] = saved
            offset += dur
        return optim.learning_rate


class EpochDecayWithWarmUp(LearningRateSchedule):
    """lr + warmup_delta * neval for `warmup_iteration` steps, then the
    peak it reached times 0.1^decay_type(epoch)."""

    def __init__(self, warmup_iteration: int, warmup_delta: float,
                 decay_type: Callable[[int], float]):
        self.warmup_iteration = warmup_iteration
        self.warmup_delta = warmup_delta
        self.decay_type = decay_type

    def compute(self, optim) -> float:
        n = optim.state["neval"]
        if n < self.warmup_iteration:
            return optim.learning_rate + self.warmup_delta * n
        max_lr = optim.learning_rate \
            + self.warmup_delta * self.warmup_iteration
        return max_lr * math.pow(0.1, self.decay_type(optim.state["epoch"]))
