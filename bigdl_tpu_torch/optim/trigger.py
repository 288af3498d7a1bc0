"""Triggers (counterpart of `bigdl_tpu/optim/trigger.py`).

Ported: `every_epoch`, `several_iteration`, `max_epoch` and
`max_iteration`, what the training loop uses. A trigger is a predicate over
the host-side training state dict (epoch, neval, ...).
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
