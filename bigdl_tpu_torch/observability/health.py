"""Training-loop health monitors: the NaN guard, straggler and throughput
watch (counterpart of `bigdl_tpu/observability/health.py`).

Failures a training loop does not surface by itself: a NaN loss keeps
"training" forever, one straggling step hides inside an averaged
throughput, and a slow throughput bleed shows only when someone rereads
old logs. Monitors attach to an optimizer with `set_health_monitors(...)`
and observe every sync point's step record (the dict the telemetry stream
carries); findings go to the training logger and, with telemetry
attached, to the stream as `event` records.

The NaN guard's `skip` is enforced in the step, on the device
(`torch.where(bad, old, new)` over the parameters, the optimizer's slots
and the BN running statistics); the host side only reports. `raise` ends
the run with `TrainingHealthError`; under `DistriOptimizer` with a
checkpoint set, the retry path reloads the newest checkpoint, which makes
"raise + checkpoint" a rollback-on-NaN policy.

Example:
    >>> from bigdl_tpu_torch.observability import NanGuard
    >>> g = NanGuard(action="warn")
    >>> g.observe({"step": 3, "loss": float("nan")})
    >>> g.nonfinite_steps
    1
"""

from __future__ import annotations

import logging
import math
import statistics
from collections import deque
from typing import Dict

logger = logging.getLogger("bigdl_tpu_torch.optim")


class TrainingHealthError(RuntimeError):
    """Raised by a monitor whose action is "raise" (a NaN/Inf loss or
    gradient under `NanGuard(action="raise")`)."""


class HealthMonitor:
    """Base monitor: `observe(record, telemetry)` is called at every sync
    point with the step record; implementations log, emit or raise."""

    def observe(self, record: Dict, telemetry=None):
        raise NotImplementedError

    def _emit(self, telemetry, kind: str, **fields):
        if telemetry is not None:
            telemetry.event(kind, **fields)


class NanGuard(HealthMonitor):
    """NaN/Inf loss and gradient guard.

    action:
      - "warn": log and emit an event; training goes on.
      - "skip": also, the step reverts its update (parameters, every
        optimizer slot, the BN running statistics) whenever the step is
        non-finite, so one poisoned batch cannot destroy the run.
      - "raise": end the run with `TrainingHealthError`.

    `check_grads=True` also guards the global gradient norm (computed in
    the step), catching an inf/NaN gradient behind a finite loss.
    """

    ACTIONS = ("warn", "skip", "raise")

    def __init__(self, action: str = "warn", check_grads: bool = True):
        if action not in self.ACTIONS:
            raise ValueError(f"action must be one of {self.ACTIONS}, "
                             f"got {action!r}")
        self.action = action
        self.check_grads = check_grads
        self.nonfinite_steps = 0  # running total over the run

    def observe(self, record: Dict, telemetry=None):
        bad = int(record.get("nonfinite_steps", 0))
        if not bad:
            loss = record.get("loss")
            bad = int(loss is not None and not math.isfinite(loss))
        if not bad:
            return
        self.nonfinite_steps += bad
        msg = (f"non-finite loss/gradients at iteration "
               f"{record.get('step')} (loss={record.get('loss')}, "
               f"{bad} step(s) this window, action={self.action})")
        self._emit(telemetry, "nan_guard", step=record.get("step"),
                   loss=record.get("loss"), nonfinite_steps=bad,
                   action=self.action)
        if self.action == "raise":
            raise TrainingHealthError(msg)
        verb = "update skipped: " if self.action == "skip" else ""
        logger.warning(f"[NanGuard] {verb}{msg}")


class StragglerDetector(HealthMonitor):
    """Slow-step detector: warns when a sync window's time a step exceeds
    `factor` times the rolling median of the last `window` observations,
    after `min_history` of them. The first `warmup` windows (kernel
    builds, allocator growth) are not observed."""

    def __init__(self, factor: float = 3.0, window: int = 64,
                 min_history: int = 8, warmup: int = 1):
        self.factor = factor
        self.min_history = min_history
        self.history: deque = deque(maxlen=window)
        self.stragglers = 0
        self._warmup_left = max(0, int(warmup))

    def observe(self, record: Dict, telemetry=None):
        dt = record.get("step_time_s")
        if dt is None or not math.isfinite(dt):
            return
        if self._warmup_left > 0:
            self._warmup_left -= 1
            return
        if len(self.history) >= self.min_history:
            p50 = statistics.median(self.history)
            if p50 > 0 and dt > self.factor * p50:
                self.stragglers += 1
                logger.warning(
                    f"[StragglerDetector] iteration {record.get('step')} "
                    f"took {dt * 1e3:.1f} ms/step vs rolling p50 "
                    f"{p50 * 1e3:.1f} ms ({dt / p50:.1f}x)")
                self._emit(telemetry, "straggler",
                           step=record.get("step"), step_time_s=dt,
                           p50_step_time_s=p50)
        self.history.append(dt)


class ThroughputMonitor(HealthMonitor):
    """Throughput-regression warning: each window's records/s against the
    rolling median of the last `window` windows; warns below
    `(1 - tolerance)` of it. The first `warmup` windows are not
    observed."""

    def __init__(self, tolerance: float = 0.3, window: int = 20,
                 min_history: int = 5, warmup: int = 1):
        self.tolerance = tolerance
        self.min_history = min_history
        self.history: deque = deque(maxlen=window)
        self.regressions = 0
        self._warmup_left = max(0, int(warmup))

    def observe(self, record: Dict, telemetry=None):
        tp = record.get("throughput")
        if tp is None or not math.isfinite(tp):
            return
        if self._warmup_left > 0:
            self._warmup_left -= 1
            return
        if len(self.history) >= self.min_history:
            med = statistics.median(self.history)
            if med > 0 and tp < (1.0 - self.tolerance) * med:
                self.regressions += 1
                logger.warning(
                    f"[ThroughputMonitor] iteration {record.get('step')}: "
                    f"{tp:.1f} records/sec is {1 - tp / med:.0%} below the "
                    f"rolling median {med:.1f}")
                self._emit(telemetry, "throughput_regression",
                           step=record.get("step"), throughput=tp,
                           median_throughput=med)
        self.history.append(tp)
