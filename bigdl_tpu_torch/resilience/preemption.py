"""Preemption: SIGTERM, then a checkpoint, a drain and a clean stop
(counterpart of `bigdl_tpu/resilience/preemption.py`).

Preemptible capacity gets SIGTERM, then SIGKILL some seconds later.
`PreemptionHandler` only records the signal and its time in the signal
handler; the work happens on the training thread at the next iteration
boundary, where the optimizer (`set_preemption_handler`) polls
`triggered` and then:
1. drains the step in flight (the state it saves is a finished step's),
2. writes a checkpoint at once, the data cursor included, when a
   checkpoint path is set,
3. emits a `preempted` event and a `run_abort`, and returns from
   `optimize()` without raising.

The handler is installed for the duration of `optimize()` and the
previous disposition is restored on every exit. A second signal inside
the grace window chains to the previous disposition (usually: terminate),
so a second SIGTERM still stops a wedged run.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Callable, Dict, Optional, Sequence

logger = logging.getLogger("bigdl_tpu_torch.resilience")


class PreemptionHandler:
    """Latches a termination signal for the training loop to act on.

    `install()` warns and does nothing off the main thread (Python delivers
    signals to the main thread only); `triggered` and `signum` read from
    any thread. `clock` (default `time.monotonic`) makes the grace window
    testable in virtual time."""

    def __init__(self, grace_s: float = 30.0,
                 signals: Sequence[int] = (signal.SIGTERM,),
                 clock: Optional[Callable[[], float]] = None):
        if grace_s <= 0:
            raise ValueError(f"grace_s must be > 0, got {grace_s}")
        self.grace_s = float(grace_s)
        self.signals = tuple(signals)
        self.clock = clock or time.monotonic
        self.signum: Optional[int] = None
        self._triggered_at: Optional[float] = None
        self._old: Dict[int, object] = {}
        self._installed = False

    def _on_signal(self, signum, frame):
        if self._triggered_at is not None:
            # a second signal inside the grace window: chain to the
            # previous disposition
            old = self._old.get(signum)
            if callable(old):
                old(signum, frame)
            elif old == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self.signum = signum
        self._triggered_at = self.clock()
        logger.warning(
            "received signal %d: preemption grace window of %.1fs opened; "
            "checkpointing at the next iteration boundary", signum,
            self.grace_s)

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            logger.warning("PreemptionHandler.install() called off the "
                           "main thread; signal handling disabled")
            return self
        try:
            for s in self.signals:
                self._old[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except ValueError as e:  # not the main interpreter
            logger.warning("cannot install signal handlers (%r); "
                           "preemption handling disabled", e)
        return self

    def uninstall(self):
        """Restore the previous signal dispositions."""
        if not self._installed:
            return
        for s, old in self._old.items():
            try:
                signal.signal(s, old)
            except (ValueError, TypeError):
                pass
        self._old.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()

    @property
    def triggered(self) -> bool:
        return self._triggered_at is not None

    def deadline_remaining(self) -> Optional[float]:
        """Seconds left in the grace window; None before a signal."""
        if self._triggered_at is None:
            return None
        return self.grace_s - (self.clock() - self._triggered_at)

    def reset(self):
        """Clear the latch (a handler reused across runs)."""
        self.signum = None
        self._triggered_at = None


class PreemptedError(RuntimeError):
    """The error a preempted run's `run_abort` event carries; never raised
    out of `optimize()`, whose stop is clean."""
