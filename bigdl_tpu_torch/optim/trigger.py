"""Triggers (counterpart of `bigdl_tpu/optim/trigger.py`).

`every_epoch`, `several_iteration`, `max_epoch`, `max_iteration`,
`max_score` (the validation score the loop keeps in the state's "score"),
`min_loss`, and their composition with `and_` / `or_`, with the
reference's camelCase aliases. A trigger is a predicate over the
host-side training state dict (epoch, neval, loss, score, ...).
"""

from __future__ import annotations

from typing import Callable, Dict


class Trigger:
    def __init__(self, fn: Callable[[Dict], bool]):
        self._fn = fn

    def __call__(self, state: Dict) -> bool:
        return self._fn(state)


def every_epoch() -> Trigger:
    """Fires once each time an epoch boundary has been crossed."""
    last = [0]

    def check(state):
        e = state.get("epoch", 0)
        if e > last[0]:
            last[0] = e
            return True
        return False

    return Trigger(check)


def several_iteration(interval: int) -> Trigger:
    """Fires every `interval` iterations."""
    return Trigger(lambda s: s.get("neval", 0) % interval == 0
                   and s.get("neval", 0) > 0)


def max_epoch(n: int) -> Trigger:
    """Fires once the epoch count reaches n."""
    return Trigger(lambda s: s.get("epoch", 0) >= n)


def max_iteration(n: int) -> Trigger:
    """Fires once the iteration count (neval) reaches n."""
    return Trigger(lambda s: s.get("neval", 0) >= n)


def max_score(v: float) -> Trigger:
    """Fires once the validation score exceeds v."""
    return Trigger(lambda s: s.get("score", float("-inf")) > v)


def min_loss(v: float) -> Trigger:
    """Fires once the loss drops below v."""
    return Trigger(lambda s: s.get("loss", float("inf")) < v)


def and_(*triggers: Trigger) -> Trigger:
    """Fires when every one of `triggers` fires."""
    return Trigger(lambda s: all(t(s) for t in triggers))


def or_(*triggers: Trigger) -> Trigger:
    """Fires when any one of `triggers` fires."""
    return Trigger(lambda s: any(t(s) for t in triggers))


# the reference's camelCase names
everyEpoch = every_epoch
severalIteration = several_iteration
maxEpoch = max_epoch
maxIteration = max_iteration
maxScore = max_score
minLoss = min_loss
