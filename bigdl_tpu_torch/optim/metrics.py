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

    def set(self, name: str, value: float):
        """Replace `name`'s values by the one `value`."""
        self._sum[name] = value
        self._count[name] = 1

    def get(self, name: str) -> float:
        """Mean of the values added under `name` (0 if none)."""
        c = self._count.get(name, 0)
        return self._sum[name] / c if c else 0.0

    def as_dict(self, unit_scale: float = 1e9
                ) -> Dict[str, Dict[str, float]]:
        """The table as {name: {mean, count, total}}, scaled as `summary`
        (default ns -> s): the `run_end` record's `metrics`."""
        return {name: {"mean": self.get(name) / unit_scale,
                       "count": self._count.get(name, 0),
                       "total": self._sum[name] / unit_scale}
                for name in sorted(self._sum)}

    def summary(self, unit_scale: float = 1e9) -> str:
        """The table as the reference prints it, one mean a line."""
        lines = ["========== Metrics Summary =========="]
        for name in sorted(self._sum):
            lines.append(f"{name} : {self.get(name) / unit_scale} s")
        lines.append("=====================================")
        return "\n".join(lines)

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
