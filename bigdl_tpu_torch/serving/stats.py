"""Serving-side latency accounting (counterpart of
`bigdl_tpu/serving/stats.py`).

A `WindowedHistogram` keeps the most recent N observations (serving runs
are unbounded, so an ever-growing reservoir would leak) and reduces them
to p50/p95/p99 on demand.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np


class WindowedHistogram:
    """Thread-safe sliding-window histogram reduced to quantiles on demand.

    `window` bounds memory: once full, the oldest observations fall out, so
    percentiles track the last `window` events rather than the whole run.
    """

    def __init__(self, window: int = 8192):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._values: deque = deque(maxlen=window)
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0

    def record(self, value: float):
        with self._lock:
            self._values.append(float(value))
            self._count += 1
            self._total += float(value)

    @property
    def count(self) -> int:
        """Total observations over the run (not just the window)."""
        with self._lock:
            return self._count

    def mean(self) -> Optional[float]:
        """Run-lifetime mean (total/count), None before any observation."""
        with self._lock:
            return self._total / self._count if self._count else None

    def quantiles(self, qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
        """`{"p50": ..., "p95": ..., "p99": ...}` over the current window;
        empty dict before any observation."""
        with self._lock:
            vals = list(self._values)
        if not vals:
            return {}
        arr = np.asarray(vals)
        return {f"p{int(q)}": float(np.percentile(arr, q)) for q in qs}

    def snapshot(self, prefix: str, scale: float = 1.0,
                 digits: int = 3) -> Dict[str, float]:
        """Flat fields: `<prefix>_p50/...` (scaled, rounded) plus
        `<prefix>_count`. An empty window contributes only the count."""
        out = {f"{prefix}_{k}": round(v * scale, digits)
               for k, v in self.quantiles().items()}
        out[f"{prefix}_count"] = self.count
        return out
