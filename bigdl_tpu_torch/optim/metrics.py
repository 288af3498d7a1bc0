"""Named phase timers of the training loop (counterpart of
`bigdl_tpu/optim/metrics.py`): host wall times in nanoseconds, summed and
counted per name ("computing time average", "data fetch time")."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict


class Metrics:
    def __init__(self):
        self._sum: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    def add(self, name: str, value: float):
        self._sum[name] += value
        self._count[name] += 1

    def get(self, name: str) -> float:
        """Mean of the values added under `name` (0 if none)."""
        c = self._count.get(name, 0)
        return self._sum[name] / c if c else 0.0

    def reset(self):
        self._sum.clear()
        self._count.clear()


class Timer:
    """`with Timer(metrics, name): ...` adds the block's wall time (ns)."""

    def __init__(self, metrics: Metrics, name: str):
        self.metrics, self.name = metrics, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.metrics.add(self.name, time.perf_counter_ns() - self.t0)
        return False
